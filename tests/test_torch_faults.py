"""The port's fault injection (``sim/faults.py``) against the JAX reference,
on the CPU: Byzantine membership and the per-cycle draws exactly equal,
``corrupt_stack`` bitwise equal for every corruption, the heap runtime under
faults on PAMAP2_B2_SMALL (fp32 and int8, the mean and Krum), and the
port's own heap and vectorized runtimes event for event under faults.

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
from repro.sim import FaultModel as JFaults  # noqa: E402
from repro.sim import FaultRuntime as JRuntime  # noqa: E402
from repro.sim import make_fleet as j_fleet  # noqa: E402
from repro_torch.configs import relief_har as TC  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import async_engine as TA  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.data import make_har_dataset as t_dataset  # noqa: E402
from repro_torch.data import mm_config_for as t_cfg  # noqa: E402
from repro_torch.sim import CORRUPTIONS  # noqa: E402
from repro_torch.sim import FaultModel as TFaults  # noqa: E402
from repro_torch.sim import FaultRuntime as TRuntime  # noqa: E402
from repro_torch.sim import make_fleet as t_fleet  # noqa: E402
from repro_torch.sim import scale_fleet as t_scale  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

KW = dict(rounds=1, local_epochs=1, steps_per_epoch=2, batch_size=8,
          eval_every=100, seed=0)
# the fault model of chip_smoke.py's robust phase: one attacker in the
# mag cohort of the paper fleet (mag is held by the three full-tier clients)
PHASE_FAULTS = dict(byzantine_frac=1 / 3, corruption="sign_flip",
                    target_modality=3, dropout_prob=0.1, stall_prob=0.1)


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


def _assert_trees_close(jtree, ttree, atol, rtol=0.0):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = leaves_with_path(params_to_numpy(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(p))


# ---------------------------------------------------------------------------
# FaultModel: validation, membership, draws
# ---------------------------------------------------------------------------


def test_validation():
    with pytest.raises(ValueError, match="corruption"):
        TFaults(corruption="bogus")
    with pytest.raises(ValueError, match="byzantine_frac"):
        TFaults(byzantine_frac=1.5)
    assert not TFaults().active and TFaults(byzantine_frac=0.1).active
    assert CORRUPTIONS == ("none", "sign_flip", "gauss", "collusion")


@pytest.mark.parametrize("seed,frac,target", [(0, 0.25, None), (11, 0.5, 2),
                                              (3, 1 / 3, 3), (5, 0.0, None),
                                              (7, 1.0, 0)])
def test_byzantine_mask_equals_reference(seed, frac, target):
    mm = np.random.default_rng(seed).random((200, 4)) > 0.5
    kw = dict(seed=seed, byzantine_frac=frac, target_modality=target)
    np.testing.assert_array_equal(TFaults(**kw).byzantine_mask(mm),
                                  JFaults(**kw).byzantine_mask(mm))


def test_phase_faults_take_one_mag_attacker():
    """The chip phase's fault model on the paper fleet: one of the three
    mag holders is Byzantine, in both packages."""
    mm = t_fleet(3, 3, 2, M=4).modality_mask
    byz = TFaults(**PHASE_FAULTS).byzantine_mask(mm)
    assert byz.sum() == 1 and mm[byz, 3].all() and mm[:, 3].sum() == 3
    np.testing.assert_array_equal(byz,
                                  JFaults(**PHASE_FAULTS).byzantine_mask(mm))


@pytest.mark.parametrize("seed,drop,stall", [(7, 0.5, 0.5), (1, 0.1, 0.0),
                                             (2, 0.0, 0.3), (3, 0.0, 0.0)])
def test_cycle_faults_equal_reference(seed, drop, stall):
    kw = dict(seed=seed, byzantine_frac=1.0, dropout_prob=drop,
              stall_prob=stall, stall_factor=3.0)
    g = np.random.default_rng(seed)
    byz = g.random(40) < 0.6
    for t in range(6):
        clients = g.permutation(40)[:17]
        tickets = g.integers(0, 50, 17)
        for a, b in zip(TFaults(**kw).cycle_faults(byz, clients, tickets),
                        JFaults(**kw).cycle_faults(byz, clients, tickets)):
            np.testing.assert_array_equal(a, b)


def test_fault_runtime_tickets_equal_reference():
    mm = np.random.default_rng(0).random((12, 4)) > 0.4
    fm = dict(seed=4, byzantine_frac=0.5, dropout_prob=0.5, stall_prob=0.5)
    t, j = TRuntime(TFaults(**fm), mm), JRuntime(JFaults(**fm), mm)
    np.testing.assert_array_equal(t.byz, j.byz)
    g = np.random.default_rng(1)
    for _ in range(8):
        clients = np.sort(g.permutation(12)[:5])
        for a, b in zip(t.on_dispatch(clients), j.on_dispatch(clients)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.tickets, j.tickets)


# ---------------------------------------------------------------------------
# corruption: bitwise equal to the reference
# ---------------------------------------------------------------------------


def _nested(g, k):
    """A tree whose sorted-key order differs from its insertion order."""
    return {"z": g.standard_normal((k, 4)).astype(np.float32),
            "a": {"y": g.standard_normal((k, 6, 3)).astype(np.float32),
                  "b": g.standard_normal((k, 2, 2, 2)).astype(np.float32)}}


@pytest.mark.parametrize("corruption", CORRUPTIONS)
@pytest.mark.parametrize("tree", ["nested", "b2"])
def test_corrupt_stack_bitwise_equals_reference(b2_small, corruption, tree):
    g = np.random.default_rng(len(corruption))
    K = 5
    if tree == "nested":
        d = _nested(g, K)
    else:
        d = jax.tree.map(
            lambda x: (0.01 * g.normal(size=(K,) + x.shape)).astype(
                np.float32), jax.tree.map(np.asarray, b2_small[1]))
    rows = np.array([True, False, True, False, True])
    clients = np.array([4, 0, 7, 2, 9])
    tickets = np.array([0, 3, 1, 2, 5])
    kw = dict(seed=9, corruption=corruption, corruption_scale=3.7,
              byzantine_frac=0.5)
    want = JFaults(**kw).corrupt_stack(d, rows, clients, tickets)
    fm = TFaults(**kw)
    for _ in range(2):  # the second call takes the cached collusion draw
        got = fm.corrupt_stack(params_from_numpy(d, "cpu"), rows, clients,
                               tickets)
        jl = jax.tree_util.tree_flatten_with_path(want)[0]
        tl = leaves_with_path(got)
        assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
        for (p, a), (_, b) in zip(jl, tl):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=jax.tree_util.keystr(p))


def test_corrupt_stack_gauss_batch_invariant():
    """The same cycle corrupted in another batch gets the same bits."""
    g = np.random.default_rng(4)
    t = params_from_numpy(_nested(g, 4), "cpu")
    fm = TFaults(seed=1, corruption="gauss", corruption_scale=3.0,
                 byzantine_frac=1.0)
    full = fm.corrupt_stack(t, np.ones(4, bool), np.arange(4),
                            np.arange(4, dtype=np.int64))
    solo = fm.corrupt_stack(
        {"z": t["z"][2:3], "a": {k: v[2:3] for k, v in t["a"].items()}},
        np.ones(1, bool), np.array([2]), np.array([2], np.int64))
    for (_, a), (_, b) in zip(leaves_with_path(full), leaves_with_path(solo)):
        assert torch.equal(a[2], b[0])


# ---------------------------------------------------------------------------
# the heap runtime under faults on PAMAP2_B2_SMALL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy,codec", [("async_relief", "none"),
                                            ("relief_krum", "int8")])
def test_b2_runs_under_faults_match_reference(b2_small, strategy, codec):
    """The chip phase's faults over 12 absorbed updates (dropped cycles are
    redispatched, never absorbed): histories exact, losses to rtol 1e-4,
    trainable to atol 1e-4, divergence EMA to rtol 1e-3."""
    jtask, jtr0, jds, ttask, ttr0, tds, shared = b2_small
    out = []
    for A, S, task, tr0, fleet, ds, FM in (
            (JA, JS, jtask, jtr0, j_fleet, jds, JFaults),
            (TA, TS, ttask, ttr0, t_fleet, tds, TFaults)):
        run = A.AsyncFedRun.create(
            task, tr0, S.get(strategy, buffer_size=4, staleness_exponent=0.5),
            fleet(3, 3, 2, M=4, hetero_scale=100.0),
            A.AsyncFedConfig(uplink_codec=codec, faults=FM(**PHASE_FAULTS),
                             **KW))
        if A is JA:
            run.local_update = shared.setdefault(0.0, run.local_update)
        out.append((run, run.run(ds, total_updates=12)))
    (jrun, jh), (trun, th) = out
    assert len(jh["flush"]) == len(th["flush"]) == 3
    for key in ("flush", "sim_time_s", "staleness_mean", "selected_frac",
                "energy_j", "upload_mb"):
        assert th[key] == jh[key], key
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    np.testing.assert_array_equal(trun.fx.tickets, jrun.fx.tickets)
    np.testing.assert_array_equal(trun.trace.per_client_updates,
                                  jrun.trace.per_client_updates)
    _assert_trees_close(jrun.state.trainable, trun.state.trainable, 1e-4)
    np.testing.assert_allclose(trun.state.dbar, jrun.state.dbar, rtol=1e-3,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# the port's heap and vectorized runtimes, event for event under faults
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cnn():
    cfg = t_cfg("pamap2", backbone="cnn", d_feat=8, d_fused=32,
                cnn_ch=(8, 16))
    task, tr0 = TTask.create(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return task, tr0, t_dataset("pamap2", windows_per_subject=60, seed=0)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_heap_and_vectorized_equal_under_faults(cnn, codec):
    """Dropout, stalls and targeted sign flips keyed by (seed, client,
    ticket): both runtimes draw the same faults, so their flush histories
    are event for event equal (N = 100, jitter 0.2), and the final models
    agree to atol 1e-5."""
    task, tr0, ds = cnn
    fleet = t_scale(t_fleet(3, 3, 2, M=4), 100, np.random.default_rng(7))
    fm = TFaults(seed=3, byzantine_frac=0.3, corruption="sign_flip",
                 corruption_scale=5.0, dropout_prob=0.3, stall_prob=0.3,
                 stall_factor=4.0, target_modality=0)
    kw = dict(rounds=1, local_epochs=1, steps_per_epoch=1, batch_size=4,
              eval_every=0, seed=0, jitter_sigma=0.2, faults=fm,
              uplink_codec=codec)
    heap = TA.AsyncFedRun.create(task, tr0, TS.async_relief(buffer_size=8),
                                 fleet, TA.AsyncFedConfig(**kw))
    heap.run(ds, total_updates=130)
    vec = TA.VectorizedAsyncFedRun.create(
        task, tr0, TS.async_relief(buffer_size=8), fleet,
        TA.AsyncFedConfig(grad_mode="dispatch", **kw))
    vec.run(ds, total_updates=130)
    h0, h1 = heap.history, vec.history
    assert len(h0["flush"]) == len(h1["flush"]) > 5
    for key in ("flush", "staleness_mean", "selected_frac", "sim_time_s"):
        np.testing.assert_array_equal(h0[key], h1[key], err_msg=key)
    np.testing.assert_allclose(h0["loss"], h1["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h0["energy_j"], h1["energy_j"], rtol=1e-9)
    assert heap.trace.completions == vec.trace.completions == 130
    np.testing.assert_array_equal(heap.trace.per_client_updates,
                                  vec.trace.per_client_updates)
    np.testing.assert_array_equal(heap.fx.tickets, vec.fx.tickets)
    for (p, a), (_, b) in zip(leaves_with_path(heap.state.trainable),
                              leaves_with_path(vec.state.trainable)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=p)


def test_dropout_slows_progress_not_accounting(cnn):
    """Dropped completions are pure loss: the same absorbed total, more
    simulated time, no energy or updates for the crashes."""
    task, tr0, ds = cnn
    fleet = t_scale(t_fleet(3, 3, 2, M=4), 60, np.random.default_rng(7))
    kw = dict(rounds=1, local_epochs=1, steps_per_epoch=1, batch_size=4,
              eval_every=0, seed=0)
    runs = {}
    for name, fm in (("clean", None),
                     ("drop", TFaults(seed=2, byzantine_frac=0.5,
                                      corruption="none",
                                      dropout_prob=0.6))):
        run = TA.VectorizedAsyncFedRun.create(
            task, tr0, TS.async_relief(buffer_size=8), fleet,
            TA.AsyncFedConfig(grad_mode="none", faults=fm, **kw))
        run.run(None, total_updates=200)
        runs[name] = run
    c, d = runs["clean"], runs["drop"]
    assert c.trace.completions == d.trace.completions == 200
    assert d.state.sim_time > c.state.sim_time
    assert d.fstate.updates.sum() == 200
    assert d.fx.tickets.sum() > d.fstate.updates.sum()  # crashes redispatch
