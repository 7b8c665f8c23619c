"""The port's Byzantine-robust cohort reducers against the JAX reference, on
the CPU: the array-level estimators, the per-group pairwise distances on
Backbone 1 and 2 trees, ``robust_combine`` and the robust ``CohortAggBuffer``
on Backbone 2 (one push per flush; int8 dequantized first), and the heap
runtime with each robust strategy on PAMAP2_B2_SMALL.

Both packages get the same numpy inputs and the reference's initial weights;
the reference runs share one compiled local update."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist as jdist  # noqa: E402
from repro.configs import relief_har as JC  # noqa: E402
from repro.core import aggregation as JAG  # noqa: E402
from repro.core import async_engine as JA  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro.data import make_har_dataset as j_dataset  # noqa: E402
from repro.sim import make_fleet as j_fleet  # noqa: E402
from repro_torch.configs import relief_har as TC  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import aggregation as TAG  # noqa: E402
from repro_torch.core import async_engine as TA  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.data import make_har_dataset as t_dataset  # noqa: E402
from repro_torch.sim import make_fleet as t_fleet  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

KW = dict(rounds=1, local_epochs=1, steps_per_epoch=2, batch_size=8,
          eval_every=100, seed=0)
# fp32 reductions over at most 9 clients (and, for the distances, a few
# hundred elements per group) in another order than XLA's
TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def b2_small():
    jtask, jtr0 = JTask.create(JC.PAMAP2_B2_SMALL, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtask.params(jtr0))
    ttask, ttr0 = TTask.create(TC.PAMAP2_B2_SMALL, params=params,
                               device="cpu")
    return (jtask, jtr0, j_dataset("pamap2", windows_per_subject=60, seed=0),
            ttask, ttr0, t_dataset("pamap2", windows_per_subject=60, seed=0),
            {})


@pytest.fixture(scope="module")
def trees(b2_small):
    """(reference task, reference trainable, port task, port trainable) for
    Backbone 1 (the CNN of tests/test_async_engine.py: whole leaves and
    fusion rows) and PAMAP2_B2_SMALL (layer-stacked groups). The layout
    tests use the runtime's K = 4, so the reference compiles each robust
    reduction once per file."""
    from repro.data import mm_config_for as j_cfg
    from repro_torch.data import mm_config_for as t_cfg

    cnn = dict(backbone="cnn", d_feat=8, d_fused=32, cnn_ch=(8, 16))
    jtask, jtr0 = JTask.create(j_cfg("pamap2", **cnn), jax.random.PRNGKey(2))
    params = jax.tree.map(np.asarray, jtask.params(jtr0))
    ttask, ttr0 = TTask.create(t_cfg("pamap2", **cnn), params=params,
                               device="cpu")
    jb2, jb2tr, _, tb2, tb2tr, _, _ = b2_small
    return {"b1": (jtask, jtr0, ttask, ttr0), "b2": (jb2, jb2tr, tb2, tb2tr)}


def _assert_trees_close(jtree, ttree, atol, rtol=0.0):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = leaves_with_path(params_to_numpy(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(p))


def _stack(jtr0, K, seed, evil=None):
    """K client deltas; row ``evil`` blown up x1000 (a Byzantine client)."""
    g = np.random.default_rng(seed)
    d = jax.tree.map(
        lambda x: (0.01 * g.normal(size=(K,) + x.shape)).astype(np.float32),
        jax.tree.map(np.asarray, jtr0))
    if evil is not None:
        for leaf in jax.tree.leaves(d):
            leaf[evil] *= 1000.0
    return d


def _weights(layout, K, seed, empty_group=True):
    """Cohort weights and divergence cohort of K clients (modality masks
    with a gap, one group nobody trained when ``empty_group``)."""
    g = np.random.default_rng(seed)
    trained = (g.random((K, layout.G)) > 0.25).astype(np.float32)
    if empty_group:
        trained[:, 1] = 0.0
    mm = (g.random((K, layout.n_modalities)) > 0.2).astype(np.float32)
    mm[:, 0] = 1.0
    C = (layout.accessible(mm) & (trained > 0)).astype(np.float32)
    return trained, mm, C


# ---------------------------------------------------------------------------
# array-level estimators
# ---------------------------------------------------------------------------


def _reducer_inputs(K, shape, seed, ties):
    g = np.random.default_rng(seed)
    x = g.normal(size=(K,) + shape).astype(np.float32)
    if ties:  # repeated values: the stable ranks decide who is trimmed
        x = np.round(x * 2) / 2
    w = (g.random((K,) + shape) * (g.random((K,) + shape) < 0.7)
         ).astype(np.float32)
    w[:, 0] = 0.0  # an empty coordinate -> 0
    return x, w


@pytest.mark.parametrize("K,shape", [(3, (5,)), (4, (6, 3)), (9, (7, 2)),
                                     (1, (4,))])
@pytest.mark.parametrize("trim", [0.0, 0.1, 0.25, 0.5])
@pytest.mark.parametrize("ties", [False, True])
def test_trimmed_mean_matches_reference(K, shape, trim, ties):
    x, w = _reducer_inputs(K, shape, K * 31 + len(shape), ties)
    want = np.asarray(JAG.trimmed_mean(x, w, trim))
    got = TAG.trimmed_mean(torch.as_tensor(x), torch.as_tensor(w), trim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got.numpy()[0].max() == 0.0 == np.abs(got.numpy()[0]).max()


@pytest.mark.parametrize("K,shape", [(3, (5,)), (4, (6, 3)), (9, (7, 2)),
                                     (1, (4,))])
@pytest.mark.parametrize("ties", [False, True])
def test_coordinate_median_matches_reference(K, shape, ties):
    x, w = _reducer_inputs(K, shape, K * 17 + 1, ties)
    want = np.asarray(JAG.coordinate_median(x, w > 0))
    got = TAG.coordinate_median(torch.as_tensor(x), torch.as_tensor(w > 0))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("K,G,f", [(5, 6, 1), (8, 4, 2), (3, 3, 1),
                                   (4, 5, 0)])
def test_krum_select_matches_reference(K, G, f):
    """Per group: the same selected client row, empty and single-member
    groups included (ties in the scores go to the first row in both)."""
    g = np.random.default_rng(K * G + f)
    pts = g.normal(size=(K, G, 3)).astype(np.float32)
    d2 = np.square(pts[:, None] - pts[None, :]).sum(-1).astype(np.float32)
    member = g.random((K, G)) < 0.7
    member[:, 0] = False  # empty group
    member[:, 1] = False
    member[2, 1] = True  # one member
    want = np.asarray(JAG.krum_select(d2, member, f))
    got = TAG.krum_select(torch.as_tensor(d2), torch.as_tensor(member), f)
    np.testing.assert_array_equal(got.numpy(), want)
    tied = np.zeros_like(d2)  # every score equal: the first member wins
    np.testing.assert_array_equal(
        TAG.krum_select(torch.as_tensor(tied), torch.as_tensor(member),
                        f).numpy(),
        np.asarray(JAG.krum_select(tied, member, f)))


# ---------------------------------------------------------------------------
# layout-level: pairwise distances, robust_combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backbone", ["b1", "b2"])
def test_group_pairwise_sq_matches_reference(trees, backbone):
    jtask, jtr0, ttask, _ = trees[backbone]
    d = _stack(jtr0, 4, 11)
    want = np.asarray(JAG.group_pairwise_sq(jtask.layout, d))
    got = TAG.group_pairwise_sq(ttask.layout, params_from_numpy(d, "cpu"))
    assert got.shape == (4, 4, ttask.layout.G)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if backbone == "b2":  # every layer group has its own distances
        enc = [g for g, n in enumerate(ttask.layout.names)
               if n.startswith("E_")]
        assert (got[0, 1, enc] > 0).all()


@pytest.mark.parametrize("kind", list(JAG.ROBUST_AGGREGATORS))
def test_robust_combine_matches_reference(trees, kind):
    """Backbone 2 (all three leaf classes), one x1000 attacker among 4
    clients, a group nobody trained."""
    jtask, jtr0, ttask, _ = trees["b2"]
    d = _stack(jtr0, 4, 12, evil=2)
    trained, mm, _ = _weights(jtask.layout, 4, 13)
    jW = JAG.cohort_weights(jtask.layout, trained, mm)
    tW = TAG.cohort_weights(ttask.layout, torch.as_tensor(trained),
                            torch.as_tensor(mm))
    want = JAG.robust_combine(jtask.layout, d, jW, kind, trim_frac=0.2,
                              krum_f=1)
    got = TAG.robust_combine(ttask.layout, params_from_numpy(d, "cpu"), tW,
                             kind, trim_frac=0.2, krum_f=1)
    _assert_trees_close(want, got, **TOL)


def test_robust_combine_rejects_unknown_kind(trees):
    _, jtr0, ttask, _ = trees["b1"]
    with pytest.raises(ValueError, match="robust kind"):
        TAG.robust_combine(ttask.layout,
                           params_from_numpy(_stack(jtr0, 3, 0), "cpu"),
                           torch.ones((3, ttask.layout.G)), "huber")


# ---------------------------------------------------------------------------
# the robust buffer
# ---------------------------------------------------------------------------


def _finalized_close(jb, tb):
    (ja, jd, jc), (ta, td, tc) = jb.finalize(), tb.finalize()
    _assert_trees_close(ja, ta, **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("kind", ["trimmed", "median", "krum"])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_b2_robust_buffer_matches_reference(trees, kind, codec):
    """Backbone 2, 4 clients, one attacker: the robust aggregate and the
    plain Eq. 5 statistics. int8 dequantizes first and folds the discount
    into W (the reference's codes, a = 0.5)."""
    jtask, jtr0, ttask, ttr0 = trees["b2"]
    jl, tl = jtask.layout, ttask.layout
    d = _stack(jtr0, 4, 21, evil=0)
    trained, mm, C = _weights(jl, 4, 22)
    kw = dict(robust=kind, trim_frac=0.25, krum_f=1)
    jb, tb = JAG.CohortAggBuffer(jl, jtr0, **kw), TAG.CohortAggBuffer(
        tl, ttr0, **kw)
    Ct = torch.as_tensor(C)
    if codec == "none":
        jb.push(d, JAG.cohort_weights(jl, trained, mm), C)
        tb.push(params_from_numpy(d, "cpu"), TAG.cohort_weights(
            tl, torch.as_tensor(trained), torch.as_tensor(mm)), Ct)
    else:
        stale = np.array([0, 1, 2, 3], np.float32)
        q, s, _ = jdist.quantize_int8_stacked(d)
        jb.push_quantized(q, s, JAG.cohort_weights(
            jl, trained, mm, client_scale=JAG.staleness_discounts(stale, .5),
            defer_scale=True), C, staleness=stale, exponent=0.5)
        tb.push_quantized(
            params_from_numpy(jax.tree.map(np.asarray, q), "cpu"),
            params_from_numpy(jax.tree.map(np.asarray, s), "cpu"),
            TAG.cohort_weights(
                tl, torch.as_tensor(trained), torch.as_tensor(mm),
                client_scale=TAG.staleness_discounts(torch.as_tensor(stale),
                                                     0.5),
                defer_scale=True), Ct, staleness=torch.as_tensor(stale),
            exponent=0.5)
    _finalized_close(jb, tb)


def test_robust_buffer_takes_one_push(trees):
    _, jtr0, ttask, ttr0 = trees["b2"]
    d = params_from_numpy(_stack(jtr0, 4, 5), "cpu")
    trained, mm, C = _weights(ttask.layout, 4, 6)
    W = TAG.cohort_weights(ttask.layout, torch.as_tensor(trained),
                           torch.as_tensor(mm))
    buf = TAG.CohortAggBuffer(ttask.layout, ttr0, robust="median")
    buf.push(d, W, torch.as_tensor(C))
    with pytest.raises(RuntimeError, match="one push"):
        buf.push(d, W, torch.as_tensor(C))
    buf.reset()
    buf.push(d, W, torch.as_tensor(C))  # reset clears the guard
    mean = TAG.CohortAggBuffer(ttask.layout, ttr0)
    mean.push(d, W, torch.as_tensor(C))
    mean.push(d, W, torch.as_tensor(C))  # the mean streams
    with pytest.raises(ValueError, match="robust"):
        TAG.CohortAggBuffer(ttask.layout, ttr0, robust="bogus")


# ---------------------------------------------------------------------------
# the heap runtime with each robust strategy on PAMAP2_B2_SMALL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["relief_trimmed", "relief_median",
                                      "relief_krum"])
def test_robust_strategy_two_flushes_match_reference(b2_small, strategy):
    """Fleet (3,3,2), K = 4, a = 0.5, two flushes: histories exact, losses
    to rtol 1e-4, trainable to atol 1e-4, divergence EMA to rtol 1e-3."""
    jtask, jtr0, jds, ttask, ttr0, tds, shared = b2_small
    out = []
    for A, S, task, tr0, fleet, ds in ((JA, JS, jtask, jtr0, j_fleet, jds),
                                       (TA, TS, ttask, ttr0, t_fleet, tds)):
        run = A.AsyncFedRun.create(
            task, tr0, S.get(strategy, buffer_size=4, staleness_exponent=0.5),
            fleet(3, 3, 2, M=4, hetero_scale=100.0), A.AsyncFedConfig(**KW))
        if A is JA:
            run.local_update = shared.setdefault(0.0, run.local_update)
        out.append((run, run.run(ds, total_updates=8)))
    (jrun, jh), (trun, th) = out
    assert trun.aggbuf.robust == jrun.aggbuf.robust != "mean"
    assert len(jh["flush"]) == len(th["flush"]) == 2
    for key in ("flush", "sim_time_s", "staleness_mean", "selected_frac"):
        assert th[key] == jh[key], key
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    _assert_trees_close(jrun.state.trainable, trun.state.trainable, 1e-4)
    np.testing.assert_allclose(trun.state.dbar, jrun.state.dbar, rtol=1e-3,
                               atol=1e-9)


def test_check_strategy_rejects_bad_robust(b2_small):
    _, _, _, ttask, ttr0, _, _ = b2_small
    s = dataclasses.replace(TS.relief_median(), robust="bogus")
    with pytest.raises(ValueError, match="robust"):
        TA.AsyncFedRun.create(ttask, ttr0, s, t_fleet(2, 1, 1, M=4),
                              TA.AsyncFedConfig(**KW))
