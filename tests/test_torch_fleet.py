"""The port's vectorized fleet runtime (``VectorizedAsyncFedRun``,
``sim/fleet.py``) against the JAX reference, on the CPU: the
structure-of-arrays primitives exactly equal, the runtime in all three
grad modes against the reference's on PAMAP2_B2_SMALL, and the port's own
heap and vectorized runtimes event for event.

Both packages get the same numpy inputs and the reference's initial weights;
the reference runs share one compiled local update."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import relief_har as JC  # noqa: E402
from repro.core import async_engine as JA  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro.data import make_har_dataset as j_dataset  # noqa: E402
from repro.sim import fleet as JF  # noqa: E402
from repro.sim import make_fleet as j_fleet  # noqa: E402
from repro.sim import scale_fleet as j_scale  # noqa: E402
from repro_torch.configs import relief_har as TC  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core import async_engine as TA  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.data import make_har_dataset as t_dataset  # noqa: E402
from repro_torch.data import mm_config_for as t_cfg  # noqa: E402
from repro_torch.sim import fleet as TF  # noqa: E402
from repro_torch.sim import make_fleet as t_fleet  # noqa: E402
from repro_torch.sim import scale_fleet as t_scale  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

KW = dict(rounds=1, local_epochs=1, steps_per_epoch=2, batch_size=8,
          eval_every=100, seed=0)
STATE_FIELDS = ("t_next", "seq", "version", "group_bits", "mod_bits",
                "t_comp", "t_comm", "upload_bytes", "energy_j", "updates",
                "alive", "lost")


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
def cnn():
    cfg = t_cfg("pamap2", backbone="cnn", d_feat=8, d_fused=32,
                cnn_ch=(8, 16))
    task, tr0 = TTask.create(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return task, tr0, t_dataset("pamap2", windows_per_subject=60, seed=0)


# ---------------------------------------------------------------------------
# structure-of-arrays primitives: exactly the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,G", [(17, 23), (5, 64), (3, 1), (0, 8)])
def test_group_bits_equal_reference(B, G):
    S = np.random.default_rng(B + G).random((B, G)) > 0.5
    bits = TF.pack_group_bits(S)
    np.testing.assert_array_equal(bits, JF.pack_group_bits(S))
    assert bits.dtype == np.uint64
    np.testing.assert_array_equal(TF.unpack_group_bits(bits, G), S)
    np.testing.assert_array_equal(TF.unpack_group_bits(bits, G),
                                  JF.unpack_group_bits(bits, G))
    with pytest.raises(ValueError):
        TF.pack_group_bits(np.ones((1, 65), bool))


def _assert_states_equal(t, j):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    assert (t.next_seq, t.in_flight) == (j.next_seq, j.in_flight)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_state_and_population_equal_reference(seed):
    """A random walk of dispatches (with tied completion times), windowed
    extractions under a gap, claims, completions and churn steps, applied
    to both packages' FleetState and PopulationModel: every array, every
    window (FIFO ties never split) and every departure equal."""
    g = np.random.default_rng(seed)
    N = 60
    fleet = t_scale(t_fleet(3, 3, 2, M=4), N, np.random.default_rng(seed))
    states = (TF.FleetState.create(N), JF.FleetState.create(N))
    pops = (TF.PopulationModel(churn_rate=0.3, arrival_rate=0.5),
            JF.PopulationModel(churn_rate=0.3, arrival_rate=0.5))
    rngs = [np.random.default_rng([seed, 5]) for _ in range(2)]
    now = 0.0
    for step in range(40):
        idle = np.nonzero(~np.isfinite(states[0].t_next)
                          & states[0].alive)[0]
        if len(idle):
            idx = g.permutation(idle)[:g.integers(1, len(idle) + 1)]
            dur = np.round(g.random(len(idx)) * 4, 1) + 0.1  # ties
            args = (idx, now, step, g.integers(0, 2**40, len(idx)).astype(
                np.uint64), dur, g.random(len(idx)), g.random(len(idx)),
                g.random(len(idx)))
            for s in states:
                s.dispatch(*args)
        k, gap = int(g.integers(1, 9)), float(g.choice([0.0, 0.05, 0.5]))
        (tt, ti), (jt, ji) = (s.peek_window(k, gap) for s in states)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(ti, ji)
        if len(ti):
            take = ti[:g.integers(1, len(ti) + 1)]
            for s in states:
                s.claim(take)
                s.complete(fleet, take)
            now = float(tt[len(take) - 1])
        dt = float(g.random())
        (td, ta), (jd, ja) = (p.step(r, s, dt)
                              for p, r, s in zip(pops, rngs, states))
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ta, ja)
        _assert_states_equal(*states)


# ---------------------------------------------------------------------------
# the vectorized runtime against the reference's, all three grad modes
# ---------------------------------------------------------------------------


def _vec_pair(setup, fleet_fn, fed_kw, strategy="async_relief", updates=8,
              buffer=4):
    jtask, jtr0, jds, ttask, ttr0, tds, shared = setup
    out = []
    for A, S, task, tr0, fleet, ds in ((JA, JS, jtask, jtr0, j_fleet, jds),
                                       (TA, TS, ttask, ttr0, t_fleet, tds)):
        run = A.VectorizedAsyncFedRun.create(
            task, tr0, S.get(strategy, buffer_size=buffer,
                             staleness_exponent=0.5),
            fleet_fn(fleet, A is JA), A.AsyncFedConfig(**(KW | fed_kw)))
        if A is JA and run.local_update is not None:
            run.local_update = shared.setdefault(0.0, run.local_update)
        no_data = fed_kw.get("grad_mode") == "none"
        out.append((run, run.run(None if no_data else ds,
                                 total_updates=updates)))
    return out


def _assert_vec_match(pair, flushes, grads=True):
    (jrun, jh), (trun, th) = pair
    assert len(jh["flush"]) == len(th["flush"]) == flushes
    for key in ("flush", "sim_time_s", "staleness_mean", "selected_frac",
                "energy_j", "upload_mb"):
        assert th[key] == jh[key], key
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(trun.fstate, f),
                                      getattr(jrun.fstate, f), err_msg=f)
    if not grads:
        assert np.isnan(th["loss"]).all() and np.isnan(jh["loss"]).all()
        return
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    jl = jax.tree_util.tree_flatten_with_path(jrun.state.trainable)[0]
    tl = leaves_with_path(params_to_numpy(trun.state.trainable))
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(p))
    np.testing.assert_allclose(trun.state.dbar, jrun.state.dbar, rtol=1e-3,
                               atol=1e-9)


def _paper(fleet, _):
    return fleet(3, 3, 2, M=4, hetero_scale=100.0)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_dispatch_mode_matches_reference(b2_small, codec):
    """Paper fleet, K = 4, two flushes, int8 error feedback in the
    [N, ...] pending store."""
    _assert_vec_match(_vec_pair(b2_small, _paper,
                                {"grad_mode": "dispatch",
                                 "uplink_codec": codec}), 2)


def _scaled(fleet, is_ref):
    scale = j_scale if is_ref else t_scale
    return scale(fleet(3, 3, 2, M=4), 200, np.random.default_rng([0, 0x5CA1E]))


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_cohort_mode_matches_reference(b2_small, codec):
    """N = 200 (the chip phase's fleet, scaled down), K = 8, a ring of 4
    snapshots, churn 0.01 and re-arrivals 0.02 per second, jitter 0.1:
    three flushes of counter-based cohort gradients."""
    fed = {"grad_mode": "cohort", "uplink_codec": codec, "snapshot_ring": 4,
           "churn_rate": 0.01, "arrival_rate": 0.02, "jitter_sigma": 0.1}
    pair = _vec_pair(b2_small, _scaled, fed, updates=24, buffer=8)
    _assert_vec_match(pair, 3)
    assert pair[1][0].ring_clamped == pair[0][0].ring_clamped


def test_none_mode_matches_reference(b2_small):
    """System simulation only, N = 10^4 with churn: every flush and every
    per-client array equal, losses NaN."""
    def big(fleet, is_ref):
        scale = j_scale if is_ref else t_scale
        return scale(fleet(3, 3, 2, M=4), 10_000, np.random.default_rng(3))
    fed = {"grad_mode": "none", "jitter_sigma": 0.2, "churn_rate": 0.05,
           "arrival_rate": 0.1}
    _assert_vec_match(_vec_pair(b2_small, big, fed, updates=64 * 40,
                                buffer=64), 40, grads=False)


# ---------------------------------------------------------------------------
# the port's heap and vectorized runtimes, and fleet-scale behaviour
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy,jitter", [("async_relief", 0.0),
                                             ("async_fedbuff", 0.3)])
def test_heap_and_vectorized_histories_equal(cnn, strategy, jitter):
    """N = 100: the vectorized runtime in dispatch mode reproduces the heap
    loop's flush history (cohort weights; fedavg weights under jitter,
    whose distinct completion times take the one-event windows)."""
    task, tr0, ds = cnn
    fleet = t_scale(t_fleet(3, 3, 2, M=4), 100, np.random.default_rng(7))
    kw = dict(rounds=1, local_epochs=1, steps_per_epoch=1, batch_size=4,
              eval_every=0, seed=0, jitter_sigma=jitter)
    heap = TA.AsyncFedRun.create(task, tr0, TS.get(strategy, buffer_size=8),
                                 fleet, TA.AsyncFedConfig(**kw))
    heap.run(ds, total_updates=130)
    vec = TA.VectorizedAsyncFedRun.create(
        task, tr0, TS.get(strategy, buffer_size=8), fleet,
        TA.AsyncFedConfig(grad_mode="dispatch", **kw))
    vec.run(ds, total_updates=130)
    h0, h1 = heap.history, vec.history
    assert len(h0["flush"]) == len(h1["flush"]) > 5
    for key in ("flush", "staleness_mean", "selected_frac", "sim_time_s"):
        np.testing.assert_array_equal(h0[key], h1[key], err_msg=key)
    np.testing.assert_allclose(h0["loss"], h1["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(heap.trace.per_client_updates,
                                  vec.trace.per_client_updates)
    for (p, a), (_, b) in zip(leaves_with_path(heap.state.trainable),
                              leaves_with_path(vec.state.trainable)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=p)


def _vec_run(task, tr0, n, fed_kw, total, ds=None, buffer=64):
    fleet = t_scale(t_fleet(3, 3, 2, M=4), n, np.random.default_rng(3))
    kw = dict(rounds=1, local_epochs=1, steps_per_epoch=1, batch_size=4,
              eval_every=0, seed=0)
    run = TA.VectorizedAsyncFedRun.create(
        task, tr0, TS.async_relief(buffer_size=buffer), fleet,
        TA.AsyncFedConfig(**(kw | fed_kw)))
    run.run(ds, total_updates=total)
    return run


def test_cohort_mode_decouples_gradients_and_keeps_the_ring(cnn):
    """grad_mode="cohort" trains only the flushed clients: its system trace
    equals grad_mode="none"'s, its losses are finite, the model moved, and
    the ring's slots hold the versions they were written with."""
    task, tr0, ds = cnn
    none = _vec_run(task, tr0, 200, {"grad_mode": "none"}, 240, buffer=8)
    coh = _vec_run(task, tr0, 200, {"grad_mode": "cohort",
                                    "snapshot_ring": 4}, 240, ds, buffer=8)
    for key in ("flush", "sim_time_s", "staleness_mean", "energy_j"):
        np.testing.assert_array_equal(none.history[key], coh.history[key],
                                      err_msg=key)
    assert np.isfinite(coh.history["loss"]).all()
    slot = coh.state.round % 4
    for (p, ring), (_, t), (_, t0) in zip(
            leaves_with_path(coh._ring), leaves_with_path(coh.state.trainable),
            leaves_with_path(tr0)):
        assert torch.equal(ring[slot], t), p
    assert any(not torch.equal(a, b) for a, b in zip(
        (t for _, t in leaves_with_path(coh.state.trainable)),
        (t for _, t in leaves_with_path(tr0))))


def test_determinism_and_churn_at_1e4(cnn):
    """Same seed, the same bits at N = 10^4 (grad_mode "none"); with churn
    and re-arrivals every absorbed completion is counted once and the
    in-flight counter equals the scheduled completions."""
    task, tr0, _ = cnn
    runs = [_vec_run(task, tr0, 10_000, {"grad_mode": "none",
                                         "jitter_sigma": 0.2}, 2000)
            for _ in range(2)]
    for key in ("flush", "sim_time_s", "staleness_mean", "energy_j",
                "selected_frac", "loss"):
        np.testing.assert_array_equal(runs[0].history[key],
                                      runs[1].history[key], err_msg=key)
    run = _vec_run(task, tr0, 500, {"grad_mode": "none", "jitter_sigma": 0.1,
                                    "churn_rate": 0.5, "arrival_rate": 0.5},
                   1500)
    fs = run.fstate
    assert run.trace.completions == fs.updates.sum() == 1500
    assert fs.in_flight == int(np.isfinite(fs.t_next).sum())
    assert fs.in_flight <= int(fs.alive.sum())


def test_vectorized_rejects_unsupported(cnn):
    task, tr0, _ = cnn
    fleet = t_fleet(2, 1, 1, M=4)
    with pytest.raises(ValueError, match="grad_mode"):
        TA.VectorizedAsyncFedRun.create(task, tr0, TS.async_relief(), fleet,
                                        TA.AsyncFedConfig(grad_mode="bogus"))
    with pytest.raises(ValueError, match="dataset"):
        TA.VectorizedAsyncFedRun.create(
            task, tr0, TS.async_relief(), fleet,
            TA.AsyncFedConfig(grad_mode="cohort")).run(None)
    with pytest.raises(ValueError, match="alloc='random'"):
        TA.VectorizedAsyncFedRun.create(task, tr0, TS.get(
            "async_relief", alloc="random"), fleet, TA.AsyncFedConfig())
