"""The port's asynchronous runtime on Backbone 2 against the JAX reference,
on the CPU: the streaming buffer over the layer-stacked encoder groups, the
heap runtime (``AsyncFedRun``) on PAMAP2_B2_SMALL with both uplink codecs
and HeLoRA rank caps, and the entry point with ``--backbone b2``.

Both packages get the same numpy inputs and the reference's initial weights;
the port runs the plain versions of its kernels here (CPU tensors). The
reference runs share one compiled local update (it depends only on the task
and the strategy's proximal term), so each batch size compiles once."""
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
from repro_torch.sim import FaultModel as TFaults  # noqa: E402
from repro_torch.sim import make_fleet as t_fleet  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

KW = dict(rounds=1, local_epochs=1, steps_per_epoch=2, batch_size=8,
          eval_every=100, seed=0)
# the buffer's reductions: fp32 sums over at most 9 clients and a few
# hundred elements, in another order than XLA's
BUF_TOL = dict(atol=1e-6, rtol=1e-6)


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
def b2_full():
    """PAMAP2_B2 FULL: the fusion leaf a is [112, 8], the path's shape."""
    jtask, jtr0 = JTask.create(JC.PAMAP2_B2, jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, jtask.params(jtr0))
    ttask, ttr0 = TTask.create(TC.PAMAP2_B2, params=params, device="cpu")
    return jtask, jtr0, ttask, ttr0


def _assert_trees_close(jtree, ttree, atol, rtol=0.0):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = leaves_with_path(params_to_numpy(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(p))


def _buffer_inputs(jtask, jtr0, K, seed):
    """Client-stacked deltas, trained groups, modality masks (one client
    without mag, so its cohort is partial), staleness."""
    g = np.random.default_rng(seed)
    layout = jtask.layout
    deltas = jax.tree.map(
        lambda x: (0.01 * g.normal(size=(K,) + x.shape)).astype(np.float32),
        jax.tree.map(np.asarray, jtr0))
    trained = (g.random((K, layout.G)) > 0.3).astype(np.float32)
    mm = (g.random((K, layout.n_modalities)) > 0.2).astype(np.float32)
    mm[:, 0] = 1.0
    stale = g.integers(0, 5, K).astype(np.float32)
    C = (layout.accessible(mm) & (trained > 0)).astype(np.float32)
    return deltas, trained, mm, stale, C


def _buffers(jtask, jtr0, ttask, ttr0, robust="mean", **jkw):
    return (JAG.CohortAggBuffer(jtask.layout, jtr0, robust=robust, **jkw),
            TAG.CohortAggBuffer(ttask.layout, ttr0, robust=robust))


def _assert_finalized_close(jb, tb):
    (ja, jd, jc), (ta, td, tc) = jb.finalize(), tb.finalize()
    _assert_trees_close(ja, ta, **BUF_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **BUF_TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("K", [4, 9])
def test_b2_buffer_push_matches_reference(b2_full, K):
    """fp32 push over B2's fusion leaf, its layer-stacked encoder groups
    (E_{m}_L{l}, one group per slice) and the head, then a second chunk
    into the same buffer: aggregate, divergence and counts."""
    jtask, jtr0, ttask, ttr0 = b2_full
    jb, tb = _buffers(jtask, jtr0, ttask, ttr0)
    assert ttask.layout.leaf_axis0_groups
    for seed in (K, K + 100):
        deltas, trained, mm, _, C = _buffer_inputs(jtask, jtr0, K, seed)
        jb.push(deltas, JAG.cohort_weights(jtask.layout, trained, mm), C)
        tb.push(params_from_numpy(deltas, "cpu"),
                TAG.cohort_weights(ttask.layout, torch.as_tensor(trained),
                                   torch.as_tensor(mm)), torch.as_tensor(C))
    _assert_finalized_close(jb, tb)


@pytest.mark.parametrize("K", [4, 9])
def test_b2_buffer_push_quantized_matches_reference(b2_full, K):
    """int8 ingest of the reference's codes with the staleness discount
    deferred into the reduction (a = 0.5)."""
    jtask, jtr0, ttask, ttr0 = b2_full
    deltas, trained, mm, stale, C = _buffer_inputs(jtask, jtr0, K, 7 * K)
    q, s, _ = jdist.quantize_int8_stacked(deltas)
    jdisc = JAG.staleness_discounts(stale, 0.5)
    tdisc = TAG.staleness_discounts(torch.as_tensor(stale), 0.5)
    jb, tb = _buffers(jtask, jtr0, ttask, ttr0)
    jb.push_quantized(q, s, JAG.cohort_weights(
        jtask.layout, trained, mm, client_scale=jdisc, defer_scale=True),
        C, staleness=stale, exponent=0.5)
    tb.push_quantized(
        params_from_numpy(jax.tree.map(np.asarray, q), "cpu"),
        params_from_numpy(jax.tree.map(np.asarray, s), "cpu"),
        TAG.cohort_weights(ttask.layout, torch.as_tensor(trained),
                           torch.as_tensor(mm), client_scale=tdisc,
                           defer_scale=True),
        torch.as_tensor(C), staleness=torch.as_tensor(stale), exponent=0.5)
    _assert_finalized_close(jb, tb)


def test_b2_buffer_matches_reference_pallas_interpret(b2_full):
    """The reference buffer through its Pallas kernel in interpret mode at
    B2's [4, 112, 8] fusion shape (as tests/test_async_engine.py:76 runs
    it) against the port's buffer: the same flush, atol 1e-5 (the Pallas
    kernel's block sums against XLA's and torch's)."""
    jtask, jtr0, ttask, ttr0 = b2_full
    deltas, trained, mm, _, C = _buffer_inputs(jtask, jtr0, 4, 3)
    assert deltas["lora"]["fusion"]["a"].shape == (4, 112, 8)
    jb, tb = _buffers(jtask, jtr0, ttask, ttr0, impl="pallas",
                      interpret=True)
    jb.push(deltas, JAG.cohort_weights(jtask.layout, trained, mm), C)
    tb.push(params_from_numpy(deltas, "cpu"),
            TAG.cohort_weights(ttask.layout, torch.as_tensor(trained),
                               torch.as_tensor(mm)), torch.as_tensor(C))
    (ja, jd, jc), (ta, td, tc) = jb.finalize(), tb.finalize()
    _assert_trees_close(ja, ta, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ---------------------------------------------------------------------------
# the heap runtime on PAMAP2_B2_SMALL
# ---------------------------------------------------------------------------


def run_pair(setup, strategy, codec="none", faults=None, updates=8,
             **strategy_kw):
    """The reference's and the port's AsyncFedRun from the same weights,
    paper fleet (3,3,2) at a 100x gap, K = 4, a = 0.5, ``updates`` absorbed
    updates. ``faults``: FaultModel keyword arguments, given to each
    package's own FaultModel."""
    from repro.sim import FaultModel as JFaults

    jtask, jtr0, jds, ttask, ttr0, tds, shared = setup
    out = []
    for A, S, task, tr0, fleet, ds, FM in (
            (JA, JS, jtask, jtr0, j_fleet, jds, JFaults),
            (TA, TS, ttask, ttr0, t_fleet, tds, TFaults)):
        run = A.AsyncFedRun.create(
            task, tr0, S.get(strategy, buffer_size=4, staleness_exponent=0.5,
                             **strategy_kw),
            fleet(3, 3, 2, M=4, hetero_scale=100.0),
            A.AsyncFedConfig(uplink_codec=codec,
                             faults=FM(**faults) if faults else None, **KW))
        if A is JA:  # one compiled local update for every reference run
            run.local_update = shared.setdefault(run.strategy.prox_mu,
                                                 run.local_update)
        out.append((run, run.run(ds, total_updates=updates)))
    return out


def assert_runs_match(pair, flushes=2):
    """Histories exact, losses to rtol 1e-4, divergence EMA to rtol 1e-3,
    trainable to atol 1e-4 (int8: one quantization step of a few updates
    apart at most where fp32 rounds x/scale the other way)."""
    (jrun, jh), (trun, th) = pair
    assert len(jh["flush"]) == len(th["flush"]) == flushes
    for key in ("flush", "sim_time_s", "staleness_mean", "selected_frac",
                "energy_j", "upload_mb"):
        assert th[key] == jh[key], key
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    np.testing.assert_array_equal(trun.trace.per_client_updates,
                                  jrun.trace.per_client_updates)
    _assert_trees_close(jrun.state.trainable, trun.state.trainable, 1e-4)
    np.testing.assert_allclose(trun.state.dbar, jrun.state.dbar, rtol=1e-3,
                               atol=1e-9)
    assert np.isfinite(th["f1"]).all()


@pytest.mark.parametrize("strategy,codec", [("async_relief", "none"),
                                            ("async_relief", "int8"),
                                            ("async_fedbuff", "none"),
                                            ("async_fedbuff", "int8")])
def test_b2_two_flushes_match_reference(b2_small, strategy, codec):
    assert_runs_match(run_pair(b2_small, strategy, codec))


def test_b2_rank_caps_match_reference(b2_small):
    """HeLoRA rank caps (1, .5, .25) by compute tier on the async runtime:
    the slow tiers' LoRA rank tails stay exactly zero in their deltas."""
    pair = run_pair(b2_small, "async_relief", rank_caps=(1.0, 0.5, 0.25))
    assert_runs_match(pair)
    trun = pair[1][0]
    assert trun.rank_gate is not None
    gates = trun.rank_gate["lora"]["fusion"]["a"]  # [N, D, r]
    assert (gates[:, :, -1] == 0).any() and (gates[:, :, 0] == 1).all()


def test_options_accepted(b2_small):
    """Robust reducers, fault injection, rank caps and Backbone 2 are taken
    by both runtimes (the vectorized one refuses rank caps, as the
    reference's does)."""
    _, _, _, ttask, ttr0, _, _ = b2_small
    fleet = t_fleet(3, 3, 2, M=4)
    faults = TFaults(byzantine_frac=0.3, dropout_prob=0.1)
    for strat in (TS.relief_trimmed(), TS.relief_median(), TS.relief_krum(),
                  TS.async_relief(rank_caps=(1.0, 0.5, 0.25))):
        run = TA.AsyncFedRun.create(ttask, ttr0, strat, fleet,
                                    TA.AsyncFedConfig(faults=faults, **KW))
        assert run.aggbuf.robust == strat.robust and run.fx is not None
    for grad_mode in TA.GRAD_MODES:
        run = TA.VectorizedAsyncFedRun.create(
            ttask, ttr0, TS.relief_krum(), fleet,
            TA.AsyncFedConfig(faults=faults, grad_mode=grad_mode, **KW))
        assert run.aggbuf.robust == "krum"
    with pytest.raises(ValueError, match="rank_caps"):
        TA.VectorizedAsyncFedRun.create(
            ttask, ttr0, TS.async_relief(rank_caps=(1.0, 0.5)), fleet,
            TA.AsyncFedConfig(**KW))


def test_entry_point_runs_b2_on_cpu(capsys):
    """The slice through its entry point: Backbone 2 small, the sync FedAvg
    comparison first, then two flushes of the int8 uplink."""
    from repro_torch.launch import train_async_har

    hist = train_async_har.main(["--device", "cpu", "--small", "--rounds",
                                 "1", "--codec", "int8", "--backbone", "b2"])
    assert len(hist["flush"]) == 2 and np.isfinite(hist["loss"]).all()
    out = capsys.readouterr().out
    assert "pamap2/b2" in out and "[sync fedavg ]" in out
    assert "wall-clock speedup vs sync FedAvg" in out
