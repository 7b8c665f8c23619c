"""The port's cohort-agg plain versions and CohortAggBuffer against the JAX
reference on the CPU: the XLA oracle and the Pallas kernel in interpret mode,
at the shapes of tests/test_kernels.py plus the async path's (4, 112, 128),
to the reference's own tolerance (atol 1e-4)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist as jdist  # noqa: E402
from repro.core import aggregation as JAG  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro.data import mm_config_for as j_cfg  # noqa: E402
from repro.kernels.cohort_agg import ops as jops  # noqa: E402
from repro_torch import dist as tdist  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import aggregation as TAG  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.data import mm_config_for as t_cfg  # noqa: E402
from repro_torch.kernels.cohort_agg import ops as tops  # noqa: E402
from repro_torch.kernels.cohort_agg import ref as tref  # noqa: E402
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(N, D, r, seed, quant=False, empty=False):
    rng = np.random.default_rng(seed)
    W = (rng.random((N, D)) * (rng.random((N, D)) < 0.7)).astype(np.float32)
    C = (rng.random((N, D)) < 0.6).astype(np.float32)
    if empty:
        W[:] = 0.0
        C[:] = 0.0
    if not quant:
        return rng.normal(size=(N, D, r)).astype(np.float32), W, C
    q = rng.integers(-127, 128, (N, D, r)).astype(np.int8)
    scales = rng.uniform(1e-3, 1e-1, N).astype(np.float32)
    staleness = rng.integers(0, 6, N).astype(np.float32)
    return q, scales, W, C, staleness


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=1e-4)


@pytest.mark.parametrize("N,D,r", [(4, 64, 4), (9, 128, 8), (16, 256, 1),
                                   (4, 112, 128)])
@pytest.mark.parametrize("empty", [False, True], ids=["cohort", "empty"])
def test_fp32_ref_matches_oracle_and_pallas(N, D, r, empty):
    x, W, C = _inputs(N, D, r, seed=N * D + r, empty=empty)
    before = dict(tops.LAUNCHES)
    got = tops.cohort_agg_divergence(*map(torch.as_tensor, (x, W, C)))
    assert tops.LAUNCHES == before  # CPU tensors never reach a kernel
    jx, jW, jC = map(jnp.asarray, (x, W, C))
    _close(got, jops.cohort_agg_divergence(jx, jW, jC, impl="xla"))
    _close(got, jops.cohort_agg_divergence(jx, jW, jC, impl="pallas",
                                           interpret=True))
    if empty:
        assert (got[0] == 0).all() and (got[3] == 0).all()


@pytest.mark.parametrize("N,D,r", [(4, 64, 4), (9, 96, 8), (16, 100, 1),
                                   (4, 112, 128)])
@pytest.mark.parametrize("exponent", [0.0, 0.5])
def test_quant_ref_matches_oracle_and_pallas(N, D, r, exponent):
    args = _inputs(N, D, r, seed=N + D + r, quant=True)
    got = tops.cohort_agg_divergence_quant(*map(torch.as_tensor, args),
                                           exponent=exponent)
    jargs = tuple(map(jnp.asarray, args))
    _close(got, jops.cohort_agg_divergence_quant(*jargs, exponent=exponent,
                                                 impl="xla"))
    _close(got, jops.cohort_agg_divergence_quant(*jargs, exponent=exponent,
                                                 impl="pallas",
                                                 interpret=True))
    # and == dequantize -> discount -> fp32 reduction (the unfused oracle)
    q, s, W, C, st = map(torch.as_tensor, args)
    want = tref.cohort_agg_divergence_ref(
        q.float() * s[:, None, None],
        W * tref.staleness_discount_ref(st, exponent)[:, None], C)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=1e-4)


def test_quant_empty_cohort_stays_finite():
    q, s, W, C, st = map(torch.as_tensor,
                         _inputs(5, 64, 4, seed=2, quant=True, empty=True))
    out = tops.cohort_agg_divergence_quant(q, s, W, C, st, exponent=0.5)
    assert all(torch.isfinite(o).all() for o in out)
    assert (out[0] == 0).all() and (out[3] == 0).all()


def test_unsupported_device_raises():
    x = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.cohort_agg_divergence(x, x[:, :, 0], x[:, :, 0])


# ---------------------------------------------------------------------------
# the server buffer on one client stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def task_pair():
    cfg = dict(backbone="cnn", d_feat=8, d_fused=32, cnn_ch=(8, 16))
    jtask, jtr0 = JTask.create(j_cfg("pamap2", **cfg), jax.random.PRNGKey(0))
    ttask, ttr0 = TTask.create(t_cfg("pamap2", **cfg),
                               params=jax.tree.map(np.asarray, jtr0),
                               device="cpu")
    return jtask, jtr0, ttask, ttr0


def _assert_trees_close(jtree, ttree, atol):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = leaves_with_path(params_to_numpy(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), atol=atol, rtol=0)


def test_buffer_push_and_push_quantized_match_reference(task_pair):
    jtask, jtr0, ttask, ttr0 = task_pair
    layout = jtask.layout
    rng = np.random.default_rng(1)
    N = 5
    deltas = jax.tree.map(lambda x: (rng.normal(size=(N,) + x.shape) * 1e-2)
                          .astype(np.float32), jtr0)
    trained = (rng.random((N, layout.G)) > 0.3).astype(np.float32)
    mmask = (rng.random((N, layout.n_modalities)) > 0.2).astype(np.float32)
    staleness = rng.integers(0, 5, N).astype(np.float32)
    a = 0.5
    tt = lambda x: torch.as_tensor(x)  # noqa: E731

    jdisc = JAG.staleness_discounts(staleness, a)
    tdisc = TAG.staleness_discounts(tt(staleness), a)
    np.testing.assert_allclose(tdisc.numpy(), np.asarray(jdisc), rtol=1e-6)
    for defer in (False, True):
        jW = JAG.cohort_weights(layout, trained, mmask, client_scale=jdisc,
                                defer_scale=defer)
        tW = TAG.cohort_weights(ttask.layout, tt(trained), tt(mmask),
                                client_scale=tdisc, defer_scale=defer)
        np.testing.assert_allclose(tW.numpy(), np.asarray(jW), rtol=1e-6)
    C = trained

    jb = JAG.CohortAggBuffer(layout, jtr0)
    jb.push(deltas, JAG.cohort_weights(layout, trained, mmask), C)
    tb = TAG.CohortAggBuffer(ttask.layout, ttr0)
    tb.push(params_from_numpy(deltas, "cpu"),
            TAG.cohort_weights(ttask.layout, tt(trained), tt(mmask)), tt(C))
    for (ja, jd, jc), (ta, td, tc) in ((jb.finalize(), tb.finalize()),):
        _assert_trees_close(ja, ta, 1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    # int8 ingest of the same codes (the reference's), discount deferred
    q, s, _ = jdist.quantize_int8_stacked(deltas)
    jW = JAG.cohort_weights(layout, trained, mmask, client_scale=jdisc,
                            defer_scale=True)
    jb.reset()
    jb.push_quantized(q, s, jW, C, staleness=staleness, exponent=a)
    tb.reset()
    tb.push_quantized(params_from_numpy(jax.tree.map(np.asarray, q), "cpu"),
                      params_from_numpy(jax.tree.map(np.asarray, s), "cpu"),
                      TAG.cohort_weights(ttask.layout, tt(trained), tt(mmask),
                                         client_scale=tdisc,
                                         defer_scale=True),
                      tt(C), staleness=tt(staleness), exponent=a)
    (ja, jd, jc), (ta, td, tc) = jb.finalize(), tb.finalize()
    _assert_trees_close(ja, ta, 1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # and the port's own codes dequantize to within one step of the stack
    tq, ts, _ = tdist.quantize_int8_stacked(params_from_numpy(deltas, "cpu"))
    deq = tdist.dequantize_int8_stacked(tq, ts)
    _assert_trees_close(deltas, deq, float(max(np.asarray(x).max()
                                               for x in jax.tree.leaves(s))))


def test_buffer_refuses_robust_reducers(task_pair):
    """An unknown reducer is refused, and a robust buffer refuses a second
    push before its finalize (order statistics do not stream); the four
    known reducers are taken (tests/test_torch_robust.py holds them against
    the reference)."""
    _, _, ttask, ttr0 = task_pair
    with pytest.raises(ValueError, match="robust"):
        TAG.CohortAggBuffer(ttask.layout, ttr0, robust="huber")
    stack = tree_map(lambda x: torch.ones((3,) + x.shape), ttr0)
    W = C = torch.ones((3, ttask.layout.G))
    for kind in TAG.ROBUST_AGGREGATORS:
        buf = TAG.CohortAggBuffer(ttask.layout, ttr0, robust=kind)
        buf.push(stack, W, C)
        if kind == "mean":
            buf.push(stack, W, C)
        else:
            with pytest.raises(RuntimeError, match="one push"):
                buf.push(stack, W, C)
