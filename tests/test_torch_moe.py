"""The port's sparse MoE (``models/moe.py``) and the mixtral models against
the JAX reference on the CPU. Inputs come from seeded numpy generators;
parameters are drawn by the reference and carried over through
``params_from_numpy``.

Tolerances: the MoE layer 1e-5 (fp32 sums in another order over d and f);
model logits, caches and aux 1e-4 (``MODEL_ATOL``, as the dense models'
tests); the kept (token, expert) sets exactly, and engine tokens exactly.

Routing takes the top-k of fp32 softmax probabilities. ``torch.topk``
orders tied values differently from ``lax.top_k`` (which takes the lower
expert id first), but a tie has probability ~0 on random data: at these
seeds no token's top-2 probabilities tie, which the tests assert.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import serving_engine as JSE  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serving_engine as TSE  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

MOE_ATOL, MODEL_ATOL = 1e-5, 1e-4
MIXTRALS = ["mixtral-8x7b", "mixtral-8x22b"]


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


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------


def _reference_kept(p, x, top_k, cap):
    """The reference's dispatch (``repro/models/moe.py`` ``_moe_one_seq``,
    its routing and sort-based slotting lines) per sequence -> the set of
    kept (sequence, token, expert) triples and the top-k ids [B, S, k]."""
    kept, ids = set(), []
    for b in range(x.shape[0]):
        probs = jax.nn.softmax(jnp.asarray(x[b]) @ p["router"], axis=-1)
        _, eids = jax.lax.top_k(probs, top_k)
        flat_e = eids.reshape(-1)
        flat_t = jnp.repeat(jnp.arange(x.shape[1]), top_k)
        order = jnp.argsort(flat_e)
        se, st = flat_e[order], flat_t[order]
        rank = jnp.arange(se.shape[0]) - jnp.searchsorted(se, se,
                                                           side="left")
        kept |= {(b, int(t), int(e)) for t, e, r in zip(
            np.asarray(st), np.asarray(se), np.asarray(rank)) if r < cap}
        ids.append(np.asarray(eids))
    return kept, np.stack(ids)


def _port_kept(p, x, top_k, cap):
    probs, _, ids = TMOE.route(p, x, top_k)
    order, rank, _ = TMOE.dispatch(ids, p["wi"].shape[0], cap)
    B = x.shape[0]
    flat_e = ids.reshape(B, -1)
    kept = {(b, int(order[b, i]) // top_k, int(flat_e[b, order[b, i]]))
            for b in range(B) for i in range(order.shape[1])
            if rank[b, i] < cap}
    # no tie between the k-th and the (k+1)-th probability at this seed
    top = torch.topk(probs, top_k + 1, dim=-1).values
    assert (top[..., top_k - 1] > top[..., top_k]).all()
    return kept, ids.numpy()


@pytest.mark.parametrize("cf", [1.25, 4.0], ids=["drops", "no_drops"])
def test_sparse_moe_matches_reference(cf):
    """Output (atol 1e-5), aux and the kept (token, expert) set; at cf 1.25
    some assignments are dropped, at cf = E none."""
    E, top_k, d, f, B, S = 4, 2, 64, 96, 4, 64
    jp = JMOE.init_moe_mlp(jax.random.PRNGKey(3), d, f, E)
    rng = np.random.default_rng(5)
    # a shared component skews the routing, so popular experts overflow
    x = (rng.normal(size=(B, S, d)) + rng.normal(size=d)).astype(np.float32)
    want, jaux = JMOE.moe_mlp(jp, jnp.asarray(x), top_k=top_k,
                              capacity_factor=cf)
    tp, tx = _port(jp), torch.from_numpy(x)
    got, aux = TMOE.moe_mlp(tp, tx, top_k=top_k, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=MOE_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    cap = TMOE.capacity(S, top_k, E, cf)
    jkept, jids = _reference_kept(jp, x, top_k, cap)
    tkept, tids = _port_kept(tp, tx, top_k, cap)
    np.testing.assert_array_equal(tids, jids)
    assert tkept == jkept
    n_drop = B * S * top_k - len(tkept)
    assert (n_drop > 0) == (cf < E), n_drop


def test_dense_moe_matches_reference_and_sparse_at_full_capacity():
    E, top_k, d, f, B, S = 4, 2, 64, 96, 2, 32
    jp = JMOE.init_moe_mlp(jax.random.PRNGKey(4), d, f, E)
    x = np.random.default_rng(6).normal(size=(B, S, d)).astype(np.float32)
    want, jaux = JMOE.moe_mlp(jp, jnp.asarray(x), top_k=top_k, impl="dense")
    tp, tx = _port(jp), torch.from_numpy(x)
    got, aux = TMOE.moe_mlp(tp, tx, top_k=top_k, impl="dense")
    np.testing.assert_allclose(got.numpy(), _np(want), atol=MOE_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    sparse, _ = TMOE.moe_mlp(tp, tx, top_k=top_k, capacity_factor=float(E))
    np.testing.assert_allclose(sparse.numpy(), got.numpy(), atol=MOE_ATOL,
                               rtol=0)
    with pytest.raises(ValueError, match="unknown moe impl"):
        TMOE.moe_mlp(tp, tx, top_k=top_k, impl="grouped")


def test_moe_param_tree_and_router_dtype_match_the_reference():
    """Layer-stacked leaves of the reference's paths and shapes; the
    router stays fp32 in a bf16 model."""
    jcfg, tcfg = _configs("mixtral-8x7b", dtype="bfloat16",
                          param_dtype="bfloat16")
    jp = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg))
    tp = tapi.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    jl = [(jax.tree_util.keystr(p), x.shape, str(x.dtype)) for p, x in
          jax.tree_util.tree_flatten_with_path(jp)[0]]
    tl = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
          for p, x in leaves_with_path(tp)]
    assert jl == tl
    mlp = tp["base"]["layers"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert mlp["wi"].dtype == torch.bfloat16
    assert tuple(mlp["wo"].shape) == (2, 4, 96, 64)


# ---------------------------------------------------------------------------
# mixtral SMOKE models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MIXTRALS)
def test_mixtral_forward_prefill_and_decode_match_the_reference(arch):
    """lm_forward logits and aux; caches and last logits after
    prefill_with_cache; one decode step -- the port's plain ("xla") and
    kernel-op ("pallas") attention."""
    jcfg, tcfg = _configs(arch)
    jp = _jparams(jcfg)
    tp = _port(jp)
    B, S, max_len = 2, 12, 16
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (B, 24)
                                               ).astype(np.int32)
    jlogits, _, jaux = JTF.lm_forward(jp, jcfg, jnp.asarray(tokens))
    jc = japi.init_caches(jcfg, B, max_len)
    jlast, jc = japi.prefill_with_cache(jp, jcfg, jc,
                                        jnp.asarray(tokens[:, :S]))
    nxt = np.asarray(jnp.argmax(jlast[:, -1], -1)).astype(np.int32)[:, None]
    jstep, jc2 = japi.decode_step(jp, jcfg, jc, jnp.asarray(nxt),
                                  jnp.int32(S))
    tt = torch.from_numpy(tokens)
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        logits, _, aux = tapi.TF.lm_forward(tp, cfg, tt)
        np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                                   atol=MODEL_ATOL, rtol=0)
        np.testing.assert_allclose(float(aux), float(jaux), atol=MODEL_ATOL,
                                   rtol=0)
        assert float(aux) >= 2 * (1.0 - 1e-3)  # >= 1 per layer
        tc = tapi.init_caches(cfg, B, max_len, device="cpu")
        last, tc = tapi.prefill_with_cache(tp, cfg, tc, tt[:, :S])
        np.testing.assert_allclose(last.numpy(), _np(jlast), atol=MODEL_ATOL,
                                   rtol=0)
        _assert_tree_close(jc, tc, MODEL_ATOL)
        step, tc = tapi.decode_step(tp, cfg, tc, torch.from_numpy(nxt), S)
        np.testing.assert_allclose(step.numpy(), _np(jstep), atol=MODEL_ATOL,
                                   rtol=0)
        _assert_tree_close(jc2, tc, MODEL_ATOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mixtral_decode_matches_forward_at_no_drop_capacity(impl):
    """Token-by-token decode reproduces the full forward when capacity
    drops nothing (cf = E, as the reference's test_decode_matches_forward):
    decode (S = 1) never drops. 24 tokens wrap the 16-slot sliding-window
    ring."""
    _, tcfg = _configs("mixtral-8x7b", attn_impl=impl)
    tcfg = dataclasses.replace(tcfg, capacity_factor=float(tcfg.n_experts))
    tp = tapi.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    B, S = 2, 24
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab, (B, S)).astype(np.int32))
    full, _ = tapi.forward(tp, tcfg, {"tokens": tok})
    caches = tapi.init_caches(tcfg, B, S, device="cpu")
    assert caches["k"].shape[2] == tcfg.sliding_window
    steps = []
    for t in range(S):
        lg, caches = tapi.decode_step(tp, tcfg, caches, tok[:, t:t + 1], t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=MODEL_ATOL,
                               rtol=0)


def test_mixtral_engine_matches_reference_engine():
    """Ragged prompts over 2 slots (admissions prefill at batch 1 with
    their own capacity; decode rows route independently): the port's
    tokens, through the kernel op and the plain gathered projection, equal
    the reference engine's."""
    jcfg, tcfg = _configs("mixtral-8x7b")
    jp = _jparams(jcfg)
    tp = _port(jp)
    rng = np.random.default_rng(0)
    jreg = JSE.AdapterRegistry(jax.random.PRNGKey(1), jcfg, capacity=3)
    treg = TSE.AdapterRegistry(tcfg, capacity=3, device="cpu")
    nb = len(jreg.block_dims)
    for i in range(3):
        lora = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
            jax.random.PRNGKey(99 + i), x.shape, x.dtype),
            japi.init_model(jax.random.PRNGKey(50 + i), jcfg)["lora"])
        mm = np.ones(nb, np.float32)
        mm[int(rng.integers(0, nb))] = 0.0
        jreg.register(f"c{i}", lora, modality_mask=mm)
        treg.register(f"c{i}", _port(lora), modality_mask=mm)
    prompts = [rng.integers(0, jcfg.vocab, n) for n in (6, 11, 4, 9)]
    new = [5, 3, 6, 4]

    def serve(mod, params, cfg, reg, **kw):
        eng = mod.ServingEngine(params, cfg, reg, batch_slots=2, max_len=20,
                                **kw)
        for i, (p, n) in enumerate(zip(prompts, new)):
            eng.submit(mod.Request(rid=f"r{i}", prompt=p,
                                   adapter=f"c{i % 3}", max_new_tokens=n))
        return eng.run()["outputs"]

    want = serve(JSE, jp, jcfg, jreg)
    for impl in ("pallas", "xla"):
        assert serve(TSE, tp, tcfg, treg, lora_impl=impl) == want
