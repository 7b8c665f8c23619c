"""The port's serving slice against the JAX reference, on the CPU: the plain
versions of the flash-attention and gathered multi-LoRA kernels (vs the
Pallas kernels in interpret mode and the XLA oracles), the dense LM (phi3
and gemma2 SMOKE, fp32), the continuous-batching engine and the serve entry
point. Inputs come from seeded numpy generators; parameters are drawn by the
reference and carried over through ``params_from_numpy``.

Tolerances: kernels 2e-5 (fp32) / 3e-2 (bf16) for attention and 1e-5 for
the projection, as the reference's kernel tests; model logits and caches
1e-4 (fp32 sums in another order over a few layers); engine tokens exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as j_fa_ref  # noqa: E402
from repro.kernels.mdlora import ops as jmd  # noqa: E402
from repro.kernels.mdlora.kernel import mdlora_matmul_multi_pallas  # noqa: E402
from repro.launch import serving_engine as JSE  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.mdlora import ops as md_ops  # noqa: E402
from repro_torch.kernels.mdlora import ref as md_ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import step_fns as tstep  # noqa: E402
from repro_torch.launch import serving_engine as TSE  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

I32MAX = np.iinfo(np.int32).max
FA_ATOL, FA_ATOL_BF16, MD_ATOL, MODEL_ATOL = 2e-5, 3e-2, 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash attention: plain version vs Pallas (interpret) and the XLA oracle
# ---------------------------------------------------------------------------


def _fa_case(rng, B, S, T, K, G, hd, dtype=np.float32):
    q = rng.normal(size=(B, S, K, G, hd)).astype(dtype)
    k = rng.normal(size=(B, T, K, hd)).astype(dtype)
    v = rng.normal(size=(B, T, K, hd)).astype(dtype)
    return q, k, v


def _fa_port(q, k, v, qpos, kvpos, window, softcap):
    before = dict(fa_ops.LAUNCHES)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    if q.dtype == ml_dtypes.bfloat16:
        t = lambda a: params_from_numpy(np.asarray(a), "cpu")  # noqa: E731
    out = fa_ops.flash_attention(t(q), t(k), t(v), t(qpos), t(kvpos), window,
                                 softcap)
    assert fa_ops.LAUNCHES == before  # a CPU tensor never reaches a kernel
    return out.float().numpy()


def _fa_jax(q, k, v, qpos, kvpos, window, softcap, bq, bt):
    args = [jnp.asarray(a) for a in (q, k, v, qpos, kvpos)]
    w = I32MAX if window is None else window
    pallas = flash_attention_pallas(*args, w, softcap, bq=bq, bt=bt,
                                    interpret=True)
    return _np(pallas), _np(j_fa_ref(*args, w, softcap))


@pytest.mark.parametrize("S,K,G,hd,window,softcap", [
    (64, 2, 2, 16, None, None),
    (128, 1, 4, 32, 32, None),
    (128, 4, 1, 64, None, 50.0),
    (64, 2, 3, 16, 16, 30.0),
])
def test_flash_prefill_matches_pallas_and_oracle(S, K, G, hd, window,
                                                 softcap):
    rng = np.random.default_rng(S + K * 7 + G * 13 + hd)
    q, k, v = _fa_case(rng, 2, S, S, K, G, hd)
    pos = np.arange(S, dtype=np.int32)
    got = _fa_port(q, k, v, pos, pos, window, softcap)
    pallas, oracle = _fa_jax(q, k, v, pos, pos, window, softcap, 32, 32)
    np.testing.assert_allclose(got, pallas, atol=FA_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=FA_ATOL, rtol=0)


@pytest.mark.parametrize("T,filled,S,bt", [(64, 50, 1, 16), (50, 37, 5, 50)],
                         ids=["ring_decode", "ragged_T"])
def test_flash_ring_cache_matches_pallas_and_oracle(T, filled, S, bt):
    """Decode against a ring cache with -1 slots, and a ragged T (no tile
    multiple) with a few query rows at the end of the filled part."""
    rng = np.random.default_rng(T + S)
    q, k, v = _fa_case(rng, 2, S, T, 2, 2, 16)
    kvpos = np.where(np.arange(T) < filled, np.arange(T), -1).astype(np.int32)
    rng.shuffle(kvpos)  # a ring: slots in no order
    qpos = np.arange(filled - S, filled, dtype=np.int32)
    got = _fa_port(q, k, v, qpos, kvpos, None, None)
    pallas, oracle = _fa_jax(q, k, v, qpos, kvpos, None, None, S, bt)
    np.testing.assert_allclose(got, pallas, atol=FA_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=FA_ATOL, rtol=0)


def test_flash_bf16_matches_pallas_and_oracle():
    rng = np.random.default_rng(5)
    q, k, v = _fa_case(rng, 1, 64, 64, 2, 2, 32, ml_dtypes.bfloat16)
    pos = np.arange(64, dtype=np.int32)
    got = _fa_port(q, k, v, pos, pos, None, None)
    pallas, oracle = _fa_jax(q, k, v, pos, pos, None, None, 32, 32)
    np.testing.assert_allclose(got, pallas, atol=FA_ATOL_BF16, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=FA_ATOL_BF16, rtol=0)


def test_flash_empty_rows_give_zero_as_the_pallas_kernel():
    """Rows that see no key (every cached position is after them, or the
    window excludes all) give 0 in the kernel and the plain version; the
    XLA oracle's softmax over all -1e30 would give the mean of v."""
    rng = np.random.default_rng(9)
    T, S = 32, 8
    q, k, v = _fa_case(rng, 2, S, T, 2, 2, 16)
    kvpos = np.where(np.arange(T) < 20, np.arange(T) + 4, -1).astype(np.int32)
    qpos = np.array([0, 1, 2, 3, 10, 15, 23, 40], np.int32)
    got = _fa_port(q, k, v, qpos, kvpos, 8, None)
    pallas, _ = _fa_jax(q, k, v, qpos, kvpos, 8, None, S, 16)
    np.testing.assert_allclose(got, pallas, atol=FA_ATOL, rtol=0)
    assert (got[:, :4] == 0).all() and (got[:, -1] == 0).all()
    assert (np.abs(got[:, 4:7]).sum(-1) > 0).all()


# ---------------------------------------------------------------------------
# gathered multi-LoRA: plain version vs Pallas (interpret) and per-row oracle
# ---------------------------------------------------------------------------


def _md_case(B, D, F, r, A, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w0 = (0.05 * rng.normal(size=(D, F))).astype(np.float32)
    a = (0.1 * rng.normal(size=(A, D, r))).astype(np.float32)
    b = (0.1 * rng.normal(size=(A, r, F))).astype(np.float32)
    idx = rng.integers(0, A, B).astype(np.int32)
    mm = (rng.random((B, 2)) < 0.7).astype(np.float32)
    return x, w0, a, b, idx, mm


@pytest.mark.parametrize("B,D,F,r,A", [(8, 64, 128, 4, 3),
                                       (16, 128, 64, 8, 16),
                                       (4, 256, 128, 16, 2)])
def test_mdlora_multi_matches_pallas_and_per_row_oracle(B, D, F, r, A):
    x, w0, a, b, idx, mm = _md_case(B, D, F, r, A, B * D + F)
    masks_j = jmd.block_row_masks([D // 2, D // 2], mm)
    masks_t = md_ops.block_row_masks([D // 2, D // 2], mm)
    np.testing.assert_array_equal(masks_t.numpy(), _np(masks_j))
    t = [torch.from_numpy(z) for z in (x, w0, a, b, idx)]
    before = dict(md_ops.LAUNCHES)
    got = md_ops.mdlora_matmul_multi(*t, row_mask=masks_t, scale=2.0).numpy()
    assert md_ops.LAUNCHES == before
    pallas = mdlora_matmul_multi_pallas(
        *map(jnp.asarray, (x, w0, a, b)), jnp.asarray(idx), masks_j, 2.0,
        bf=min(256, F), bd=min(256, D), interpret=True)
    np.testing.assert_allclose(got, _np(pallas), atol=MD_ATOL, rtol=MD_ATOL)
    rows = [md_ref.mdlora_matmul_ref(t[0][i:i + 1], t[1], t[2][idx[i]],
                                     t[3][idx[i]], masks_t[i], 2.0)
            for i in range(B)]
    np.testing.assert_allclose(got, torch.cat(rows).numpy(), atol=MD_ATOL,
                               rtol=MD_ATOL)


def test_mdlora_multi_row_mask_none_and_row_order():
    """row_mask=None means all ones; permuting the rows permutes the
    result."""
    x, w0, a, b, idx, _ = _md_case(16, 128, 128, 8, 5, 1)
    t = [torch.from_numpy(z) for z in (x, w0, a, b, idx)]
    got = md_ops.mdlora_matmul_multi(*t, scale=2.0)
    ones = torch.ones(16, 128)
    torch.testing.assert_close(got, md_ops.mdlora_matmul_multi(
        *t, row_mask=ones, scale=2.0), atol=0, rtol=0)
    pallas = mdlora_matmul_multi_pallas(
        *map(jnp.asarray, (x, w0, a, b, idx)), jnp.ones((16, 128)), 2.0,
        bf=128, bd=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(pallas), atol=MD_ATOL)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(16))
    yp = md_ops.mdlora_matmul_multi(t[0][perm], *t[1:4], t[4][perm],
                                    scale=2.0)
    torch.testing.assert_close(got[perm], yp, atol=MD_ATOL, rtol=MD_ATOL)


# ---------------------------------------------------------------------------
# models: phi3 and gemma2 SMOKE, reference weights carried over
# ---------------------------------------------------------------------------


def _configs(arch, **kw):
    jcfg = dataclasses.replace(jbase.get_arch(arch).SMOKE, **kw)
    tcfg = dataclasses.replace(tbase.get_arch(arch).SMOKE, **kw)
    return jcfg, tcfg


def _perturbed_lora(lora, seed):
    """Init's b = 0 makes LoRA a no-op; perturb so it is exercised."""
    return jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
        jax.random.PRNGKey(seed), x.shape, x.dtype), lora)


def _jparams(jcfg):
    p = japi.init_model(jax.random.PRNGKey(0), jcfg)
    p["lora"] = _perturbed_lora(p["lora"], 1)
    return p


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _assert_tree_close(jtree, ttree, atol):
    jl = [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
          jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tl = [(p, x.numpy()) for p, x in leaves_with_path(ttree)]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype, p
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=p)


def test_configs_and_param_tree_match_the_reference():
    for arch in tbase.list_archs():
        for which in ("FULL", "SMOKE"):
            j = dataclasses.asdict(getattr(jbase.get_arch(arch), which))
            t = dataclasses.asdict(getattr(tbase.get_arch(arch), which))
            assert j == t, (arch, which)
    jcfg, tcfg = _configs("gemma2-27b")
    jp = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg))
    tp = tapi.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    jl = [(jax.tree_util.keystr(p), x.shape, str(x.dtype)) for p, x in
          jax.tree_util.tree_flatten_with_path(jp)[0]]
    tl = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
          for p, x in leaves_with_path(tp)]
    assert jl == tl
    assert sum(x.size for x in jax.tree.leaves(jp)) == tapi.param_count(tp)


def test_params_from_numpy_keeps_bf16_bits():
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(
        ml_dtypes.bfloat16)
    t = params_from_numpy({"w": x}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))


def test_layers_match_the_reference():
    """rmsnorm (1+w), layernorm, RoPE with [S] and [B, 1] positions,
    softcap, the GeGLU MLP and masked cross-entropy."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = (0.1 * rng.normal(size=16)).astype(np.float32)
    ln = {"scale": (1 + 0.1 * rng.normal(size=16)).astype(np.float32),
          "bias": (0.1 * rng.normal(size=16)).astype(np.float32)}
    mlp = {k: (0.2 * rng.normal(size=s)).astype(np.float32) for k, s in
           (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    logits = (3 * rng.normal(size=(2, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    pos_s = np.arange(3, 8, dtype=np.int32)
    pos_b = np.array([[4], [9]], np.int32)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    pairs = [
        (JL.rmsnorm(w, x), TL.rmsnorm(t(w), t(x))),
        (JL.layernorm(ln, x), TL.layernorm(_port(ln), t(x))),
        (JL.apply_rope(x, pos_s), TL.apply_rope(t(x), t(pos_s))),
        (JL.apply_rope(x[:, :1], pos_b), TL.apply_rope(t(x[:, :1]),
                                                       t(pos_b))),
        (JL.softcap(x * 40, 30.0), TL.softcap(t(x * 40), 30.0)),
        (JL.glu_mlp(mlp, x[..., 0, :], "gelu"),
         TL.glu_mlp(_port(mlp), t(x[..., 0, :]), "gelu")),
        (JL.cross_entropy_logits(logits, labels, mask),
         TL.cross_entropy_logits(t(logits), t(labels), t(mask))),
    ]
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                                   rtol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "gemma2-27b"])
def test_forward_prefill_and_decode_match_the_reference(arch):
    """lm_forward logits; caches and last logits after prefill_with_cache;
    one decode step after it -- reference XLA path vs the port's plain
    ("xla") and kernel-op ("pallas") paths."""
    jcfg, tcfg = _configs(arch)
    jp = _jparams(jcfg)
    tp = _port(jp)
    # 24 tokens pass gemma2's window of 16 in the forward; the prefill
    # stays within one ring size (the reference's one-shot prefill takes
    # stacked caches only)
    B, S, max_len = 2, 12, 16
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (B, 24)
                                               ).astype(np.int32)
    jlogits, _, _ = JTF.lm_forward(jp, jcfg, jnp.asarray(tokens))
    jc = japi.init_caches(jcfg, B, max_len)
    jlast, jc = japi.prefill_with_cache(jp, jcfg, jc,
                                        jnp.asarray(tokens[:, :S]))
    nxt = np.asarray(jnp.argmax(jlast[:, -1], -1)).astype(np.int32)[:, None]
    jstep, jc2 = japi.decode_step(jp, jcfg, jc, jnp.asarray(nxt),
                                  jnp.int32(S))
    tt = torch.from_numpy(tokens)
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        logits, _, _ = tapi.TF.lm_forward(tp, cfg, tt)
        np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                                   atol=MODEL_ATOL, rtol=0)
        tc = tapi.init_caches(cfg, B, max_len, device="cpu")
        last, tc = tapi.prefill_with_cache(tp, cfg, tc, tt[:, :S])
        np.testing.assert_allclose(last.numpy(), _np(jlast), atol=MODEL_ATOL,
                                   rtol=0)
        _assert_tree_close(jc, tc, MODEL_ATOL)
        step, tc = tapi.decode_step(tp, cfg, tc, torch.from_numpy(nxt), S)
        np.testing.assert_allclose(step.numpy(), _np(jstep), atol=MODEL_ATOL,
                                   rtol=0)
        _assert_tree_close(jc2, tc, MODEL_ATOL)
    prefill = tstep.make_prefill_step(tcfg)({"base": tp["base"],
                                             "lora": tp["lora"]},
                                            {"tokens": tt[:, :S]})
    np.testing.assert_allclose(prefill.numpy(), _np(jlast[:, 0]),
                               atol=MODEL_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "gemma2-27b"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_matches_forward(arch, impl):
    """Token-by-token decode reproduces the full-sequence forward. 24
    tokens: gemma2's local layers keep a 16-slot ring that wraps, beside
    the global layers' 24-slot one."""
    _, tcfg = _configs(arch, attn_impl=impl)
    tp = tapi.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    B, S = 2, 24
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab, (B, S)).astype(np.int32))
    full, _ = tapi.forward(tp, tcfg, {"tokens": tok})
    caches = tapi.init_caches(tcfg, B, S, device="cpu")
    steps = []
    for t in range(S):
        lg, caches = tapi.decode_step(tp, tcfg, caches, tok[:, t:t + 1], t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=MODEL_ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# engine: port vs reference tokens, join/leave, int8 KV
# ---------------------------------------------------------------------------


def _registries(jcfg, tcfg, n_adapters, seed=0):
    """The reference's test registry (perturbed adapters, one block of each
    client absent) and the port's with the same adapters and masks."""
    rng = np.random.default_rng(seed)
    jreg = JSE.AdapterRegistry(jax.random.PRNGKey(1), jcfg,
                               capacity=n_adapters)
    treg = TSE.AdapterRegistry(tcfg, capacity=n_adapters, device="cpu")
    nb = len(jreg.block_dims)
    assert treg.block_dims == jreg.block_dims
    for i in range(n_adapters):
        lora = _perturbed_lora(
            japi.init_model(jax.random.PRNGKey(50 + i), jcfg)["lora"], 99 + i)
        mm = np.ones(nb, np.float32)
        mm[int(rng.integers(1, nb))] = 0.0
        jreg.register(f"c{i}", lora, modality_mask=mm)
        treg.register(f"c{i}", _port(lora), modality_mask=mm)
    np.testing.assert_array_equal(treg.fusion_masks.numpy(),
                                  _np(jreg.fusion_masks))
    return jreg, treg, rng


def _requests(cls, prompts, n_adapters, new_tokens):
    return [cls(rid=f"r{i}", prompt=p, adapter=f"c{i % n_adapters}",
                max_new_tokens=int(n)) for i, (p, n) in
            enumerate(zip(prompts, new_tokens))]


def _serve(cls_engine, params, cfg, reg, reqs, slots, max_len, **kw):
    eng = cls_engine(params, cfg, reg, batch_slots=slots, max_len=max_len,
                     **kw)
    for r in reqs:
        eng.submit(r)
    return eng, eng.run()["outputs"]


def test_engine_matches_reference_engine_and_naive():
    """Uniform lengths, gathered decode (kernel op and plain version): the
    port's tokens equal the reference engine's and the port's own
    per-request baseline's."""
    jcfg, tcfg = _configs("phi3-medium-14b")
    jp = _jparams(jcfg)
    tp = _port(jp)
    jreg, treg, rng = _registries(jcfg, tcfg, 3)
    prompts = [rng.integers(0, jcfg.vocab, 6) for _ in range(4)]
    jreqs = _requests(JSE.Request, prompts, 3, [8] * 4)
    _, want = _serve(JSE.ServingEngine, jp, jcfg, jreg, jreqs, 4, 20)
    for impl in ("pallas", "xla"):
        treqs = _requests(TSE.Request, prompts, 3, [8] * 4)
        _, got = _serve(TSE.ServingEngine, tp, tcfg, treg, treqs, 4, 20,
                        lora_impl=impl)
        assert got == want
    naive = TSE.naive_serve(tp, tcfg, treg, treqs, max_len=20)["outputs"]
    assert naive == want


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf", "int8_kv"])
def test_engine_join_leave_does_not_perturb_survivors(kv_quant):
    """2 slots, 5 requests with ragged lengths: rows finish and new ones
    join mid-stream through recycled slots; every request still matches its
    solo run, and the fresh row every admission clones stays empty."""
    jcfg, tcfg = _configs("phi3-medium-14b", kv_quant=kv_quant)
    tp = _port(_jparams(jcfg))
    _, treg, rng = _registries(jcfg, tcfg, 3)
    prompts = [rng.integers(0, jcfg.vocab, n) for n in (4, 7, 5, 6, 3)]
    reqs = _requests(TSE.Request, prompts, 3, [6, 3, 8, 4, 7])
    eng, got = _serve(TSE.ServingEngine, tp, tcfg, treg, reqs, 2, 24,
                      lora_impl="pallas")
    assert got == TSE.naive_serve(tp, tcfg, treg, reqs, 24)["outputs"]
    assert [len(got[r.rid]) for r in reqs] == [6, 3, 8, 4, 7]
    assert (eng._fresh_row["pos"] == -1).all()
    assert not eng._fresh_row["k"].any()
    if kv_quant:
        assert eng.caches["k"].dtype == torch.int8


def test_engine_submission_order_and_registry_updates():
    """Reordering the queue changes no request's tokens; ``ingest_update``
    changes what a client is served without repacking and stays equal to
    the per-request baseline; an evicted slot is reused, and a recycled
    batch slot carries nothing of its last occupant."""
    jcfg, tcfg = _configs("phi3-medium-14b")
    tp = _port(_jparams(jcfg))
    _, reg, rng = _registries(jcfg, tcfg, 3)
    prompts = [rng.integers(0, jcfg.vocab, n) for n in (5, 3, 6, 4, 7, 5)]
    reqs = _requests(TSE.Request, prompts, 3, [4, 6, 3, 5, 4, 6])
    outs = [_serve(TSE.ServingEngine, tp, tcfg, reg,
                   [reqs[i] for i in order], 3, 20, lora_impl="pallas")[1]
            for order in (range(6), [3, 0, 5, 1, 4, 2])]
    assert outs[0] == outs[1]

    one = [TSE.Request(rid="x", prompt=prompts[0], adapter="c0",
                       max_new_tokens=6)]
    before = _serve(TSE.ServingEngine, tp, tcfg, reg, one, 1, 16)[1]["x"]
    reg.ingest_update("c0", tree_map(lambda x: 0.3 * torch.ones_like(x[:, 0]),
                                     reg.store))
    after = _serve(TSE.ServingEngine, tp, tcfg, reg, one, 1, 16)[1]["x"]
    assert before != after
    assert after == TSE.naive_serve(tp, tcfg, reg, one, 16)["outputs"]["x"]
    reg.evict("c1")
    s = reg.register("c9", _port(japi.init_model(jax.random.PRNGKey(7),
                                                 jcfg)["lora"]))
    assert s == reg.slot("c9") and "c1" not in reg._slots
    two = [TSE.Request(rid="p", prompt=prompts[1], adapter="c0",
                       max_new_tokens=4),
           TSE.Request(rid="q", prompt=prompts[2], adapter="c9",
                       max_new_tokens=5)]
    got = _serve(TSE.ServingEngine, tp, tcfg, reg, two, 1, 16)[1]
    assert got == TSE.naive_serve(tp, tcfg, reg, two, 16)["outputs"]


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", [False, True], ids=["batched", "engine"])
def test_serve_entry_point_on_cpu(engine, capsys):
    args = ["--arch", "phi3-medium-14b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--decode-steps", "4"]
    res = tserve.main(args + (["--engine"] if engine else []))
    if engine:
        assert res["generated_tokens"] == 4 * 4  # 2 x batch requests
        assert all(len(v) == 4 for v in res["outputs"].values())
    else:
        assert res["tokens"].shape == (2, 4)
        assert torch.isfinite(res["prefill_logits"]).all()
    assert "[serve" in capsys.readouterr().out


def test_profile_entry_point_on_cpu(capsys):
    from repro_torch.launch import profile_serve

    res = profile_serve.main(["--arch", "phi3-medium-14b", "--smoke",
                              "--device", "cpu", "--steps", "2"])
    for mode in ("batched", "engine"):
        assert res[mode]["wall_ms"] > 0 and res[mode]["busy_ms"] is None
        assert res[mode]["top"] and res[mode]["launches"] == 0
    out = capsys.readouterr().out
    assert "[profile] batched decode B=8" in out
    assert "[profile] engine decode, 16 busy slots" in out
