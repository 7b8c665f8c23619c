"""The rest of the model zoo against the JAX reference on the CPU: the
granite (dense GQA and MQA), llava (patch prefix) and musicgen (codebook
streams) configs and models, the repaired patch prefill, and the serving
entry points' handling of codebooks and patches. Inputs come from seeded
numpy generators; parameters are drawn by the reference and carried over
through ``params_from_numpy``.

Tolerances: logits and caches 1e-4 (``MODEL_ATOL``: fp32 sums in another
order over a few layers); tokens exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import step_fns as JSF  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import serving_engine as TSE  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

MODEL_ATOL = 1e-4
NEW_ARCHS = ["granite-3-8b", "granite-34b", "mixtral-8x7b", "mixtral-8x22b",
             "llava-next-34b", "musicgen-large"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process: torch runs 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _configs(arch, **kw):
    jcfg = dataclasses.replace(jbase.get_arch(arch).SMOKE, **kw)
    tcfg = dataclasses.replace(tbase.get_arch(arch).SMOKE, **kw)
    return jcfg, tcfg


def _jparams(jcfg):
    """Reference weights with LoRA b perturbed (init's b = 0 is a no-op)."""
    p = japi.init_model(jax.random.PRNGKey(0), jcfg)
    p["lora"] = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), x.shape, x.dtype), p["lora"])
    return p


def _assert_tree_close(jtree, ttree, atol):
    jl = [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
          jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tl = [(p, x.numpy()) for p, x in leaves_with_path(ttree)]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype, p
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=p)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), _np(want), atol=MODEL_ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------


def test_registry_lists_the_reference_architectures():
    assert tbase.list_archs() == jbase.list_archs()
    assert len(tbase.list_archs()) == 10


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_equal_the_reference(arch):
    """FULL and SMOKE field by field; the fusion blocks (one per KV group:
    a single block for granite-34b's MQA) and the padded vocab."""
    from repro.models import transformer as JTF
    from repro_torch.models import transformer as TTF

    for which in ("FULL", "SMOKE"):
        j = getattr(jbase.get_arch(arch), which)
        t = getattr(tbase.get_arch(arch), which)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), which
        assert tapi.fusion_block_dims(t) == japi.fusion_block_dims(j)
        assert TTF.padded_vocab(t) == JTF.padded_vocab(j)
    full = tbase.get_arch(arch).FULL
    if arch == "granite-34b":
        assert tapi.fusion_block_dims(full) == (48 * 128,)
    if arch == "musicgen-large":
        assert TTF.padded_vocab(full) == 8192  # vocab x 4 codebooks


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_param_tree_matches_the_reference(arch):
    jcfg, tcfg = _configs(arch)
    jp = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg))
    tp = tapi.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    jl = [(jax.tree_util.keystr(p), x.shape, str(x.dtype)) for p, x in
          jax.tree_util.tree_flatten_with_path(jp)[0]]
    tl = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
          for p, x in leaves_with_path(tp)]
    assert jl == tl


# ---------------------------------------------------------------------------
# granite: dense GQA (3-8b, tied embeddings, vocab 99 padded) and MQA (34b)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-8b", "granite-34b"])
def test_granite_forward_prefill_and_decode_match_the_reference(arch):
    jcfg, tcfg = _configs(arch)
    jp = _jparams(jcfg)
    tp = _port(jp)
    B, S, max_len = 2, 12, 16
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (B, S)
                                               ).astype(np.int32)
    jlogits, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    jc = japi.init_caches(jcfg, B, max_len)
    jlast, jc = japi.prefill_with_cache(jp, jcfg, jc, jnp.asarray(tokens))
    nxt = np.asarray(jnp.argmax(jlast[:, -1], -1)).astype(np.int32)[:, None]
    jstep, jc2 = japi.decode_step(jp, jcfg, jc, jnp.asarray(nxt),
                                  jnp.int32(S))
    tt = torch.from_numpy(tokens)
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        logits, aux = tapi.forward(tp, cfg, {"tokens": tt})
        _close(logits, jlogits)
        assert aux == 0.0
        tc = tapi.init_caches(cfg, B, max_len, device="cpu")
        last, tc = tapi.prefill_with_cache(tp, cfg, tc, tt)
        _close(last, jlast)
        _assert_tree_close(jc, tc, MODEL_ATOL)
        step, tc = tapi.decode_step(tp, cfg, tc, torch.from_numpy(nxt), S)
        _close(step, jstep)
        _assert_tree_close(jc2, tc, MODEL_ATOL)


# ---------------------------------------------------------------------------
# llava: the patch prefix
# ---------------------------------------------------------------------------


def _llava_case():
    jcfg, tcfg = _configs("llava-next-34b")
    # the reference's chunked attention needs q_chunk | S; one chunk of
    # any length computes the same scores (the port's takes any S)
    jcfg = dataclasses.replace(jcfg, q_chunk=64)
    jp = _jparams(jcfg)
    rng = np.random.default_rng(7)
    B, S = 2, 12
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    patches = rng.normal(size=(B, jcfg.n_patches, jcfg.d_model)
                         ).astype(np.float32)
    return jcfg, tcfg, jp, _port(jp), tokens, patches


def test_llava_forward_with_patches_matches_the_reference():
    jcfg, tcfg, jp, tp, tokens, patches = _llava_case()
    jlogits, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                         "patches": jnp.asarray(patches)})
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        logits, _ = tapi.forward(tp, cfg, {
            "tokens": torch.from_numpy(tokens),
            "patches": torch.from_numpy(patches)})
        assert logits.shape == (2, jcfg.n_patches + 12, jcfg.vocab)
        _close(logits, jlogits)


def test_llava_prefill_with_patches_matches_the_reference_forward():
    """The port's repaired prefill (positions and ring check over
    n_patches + S) against the reference's ``api.forward`` with patches,
    whose ``prefill_with_cache`` fails on them; then a decode step against
    the forward on the extended sequence."""
    jcfg, tcfg, jp, tp, tokens, patches = _llava_case()
    B, S, n_p = tokens.shape[0], tokens.shape[1], jcfg.n_patches
    jpatch = jnp.asarray(patches)
    jfull, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                       "patches": jpatch})
    with pytest.raises(ValueError, match="Incompatible shapes"):
        japi.prefill_with_cache(jp, jcfg, japi.init_caches(jcfg, B, 40),
                                jnp.asarray(tokens), patches=jpatch)
    nxt = np.asarray(jnp.argmax(jfull[:, -1], -1)).astype(np.int32)[:, None]
    jext, _ = japi.forward(jp, jcfg, {
        "tokens": jnp.asarray(np.concatenate([tokens, nxt], 1)),
        "patches": jpatch})
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        tc = tapi.init_caches(cfg, B, n_p + S + 4, device="cpu")
        last, tc = tapi.prefill_with_cache(tp, cfg, tc,
                                           torch.from_numpy(tokens),
                                           patches=torch.from_numpy(patches))
        _close(last, jfull[:, -1:])
        assert (tc["pos"][:, :n_p + S] == torch.arange(n_p + S)).all()
        assert (tc["pos"][:, n_p + S:] == -1).all()
        step, _ = tapi.decode_step(tp, cfg, tc, torch.from_numpy(nxt),
                                   n_p + S)
        _close(step, jext[:, -1:])


def test_token_loop_prefill_raises_on_patches():
    """A ring too small for n_patches + S sends the prefill to the
    per-token loop, which takes no patches: it raises instead of dropping
    them."""
    _, tcfg, _, tp, tokens, patches = _llava_case()
    tc = tapi.init_caches(tcfg, 2, tcfg.n_patches + 4, device="cpu")
    with pytest.raises(ValueError, match="takes no patches"):
        tapi.prefill_with_cache(tp, tcfg, tc, torch.from_numpy(tokens),
                                patches=torch.from_numpy(patches))


def test_llava_serve_entry_point_draws_stub_patches(capsys):
    res = tserve.main(["--arch", "llava-next-34b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "6",
                       "--decode-steps", "3"])
    assert res["tokens"].shape == (2, 3)
    assert "16 patches + 6 tokens" in capsys.readouterr().out
    p = tserve.stub_patches(tbase.get_arch("llava-next-34b").SMOKE, 2, 0,
                            "cpu")
    assert p.shape == (2, 16, 64) and p.dtype == torch.float32


# ---------------------------------------------------------------------------
# musicgen: codebook streams
# ---------------------------------------------------------------------------


def test_musicgen_forward_prefill_and_decode_match_the_reference():
    """Summed codebook embeddings (row i * vocab + id), [B, S, CB, V]
    logits; prefill and decode logits [B, 1, CB, V]."""
    jcfg, tcfg = _configs("musicgen-large")
    jp = _jparams(jcfg)
    tp = _port(jp)
    B, S, CB = 2, 10, jcfg.n_codebooks
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (B, S, CB)
                                               ).astype(np.int32)
    jlogits, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    jc = japi.init_caches(jcfg, B, 16)
    jlast, jc = japi.prefill_with_cache(jp, jcfg, jc, jnp.asarray(tokens))
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)  # [B, 1, CB]
    jstep, _ = japi.decode_step(jp, jcfg, jc, jnp.asarray(nxt), jnp.int32(S))
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        logits, _ = tapi.forward(tp, cfg, {"tokens": torch.from_numpy(tokens)})
        assert logits.shape == (B, S, CB, jcfg.vocab)
        _close(logits, jlogits)
        tc = tapi.init_caches(cfg, B, 16, device="cpu")
        last, tc = tapi.prefill_with_cache(tp, cfg, tc,
                                           torch.from_numpy(tokens))
        assert last.shape == (B, 1, CB, jcfg.vocab)
        _close(last, jlast)
        step, _ = tapi.decode_step(tp, cfg, tc, torch.from_numpy(nxt), S)
        assert step.shape == (B, 1, CB, jcfg.vocab)
        _close(step, jstep)


def test_musicgen_run_batched_tokens_match_the_reference_loop():
    """``run_batched`` on [B, P, CB] prompts against the reference
    launcher's loop (prefill_with_cache, the greedy token reshaped to
    [B, 1, CB], its serve step) on the same prompts."""
    jcfg, tcfg = _configs("musicgen-large")
    jp = _jparams(jcfg)
    res = tserve.run_batched(tcfg, _port(jp), batch=2, prompt_len=8,
                             decode_steps=5, device="cpu")
    prompts = jnp.asarray(res["prompts"])
    assert prompts.shape == (2, 8, 4) and res["tokens"].shape == (2, 5, 4)
    caches = japi.init_caches(jcfg, 2, 13)
    logits, caches = japi.prefill_with_cache(jp, jcfg, caches, prompts)
    tok = jnp.argmax(logits, -1).astype(jnp.int32).reshape(2, 1, 4)
    step = JSF.make_serve_step(jcfg)
    out = []
    for pos in range(8, 13):
        tok, caches = step(jp, caches, tok, jnp.int32(pos))
        out.append(np.asarray(tok))
    np.testing.assert_array_equal(res["tokens"], np.concatenate(out, 1))


def test_engine_raises_on_a_codebook_config():
    tcfg = tbase.get_arch("musicgen-large").SMOKE
    tp = tapi.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    reg = TSE.AdapterRegistry(tcfg, capacity=2, device="cpu")
    with pytest.raises(ValueError, match="takes no codebook prompts"):
        TSE.ServingEngine(tp, tcfg, reg, batch_slots=2, max_len=16)
    with pytest.raises(ValueError, match="takes no codebook prompts"):
        tserve.main(["--arch", "musicgen-large", "--smoke", "--device",
                     "cpu", "--engine"])
