"""The port's asynchronous runtime against the JAX reference, on the CPU.

Both packages get the same numpy data and the reference's initial weights;
the port runs its plain PyTorch cohort-agg versions here (CPU tensors)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import async_engine as JA  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro.data import make_har_dataset as j_dataset  # noqa: E402
from repro.data import mm_config_for as j_cfg  # noqa: E402
from repro.sim import make_fleet as j_fleet  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core import async_engine as TA  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.data import make_har_dataset as t_dataset  # noqa: E402
from repro_torch.data import mm_config_for as t_cfg  # noqa: E402
from repro_torch.sim import make_fleet as t_fleet  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

# the config of tests/test_async_engine.py
CFG = dict(backbone="cnn", d_feat=8, d_fused=32, cnn_ch=(8, 16))
KW = dict(local_epochs=1, steps_per_epoch=2, batch_size=8, eval_every=100,
          seed=0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jtask, jtr0 = JTask.create(j_cfg("pamap2", **CFG), jax.random.PRNGKey(0))
    tr0_np = jax.tree.map(np.asarray, jtr0)
    ttask, ttr0 = TTask.create(t_cfg("pamap2", **CFG), params=tr0_np,
                               device="cpu")
    return (j_dataset("pamap2", windows_per_subject=60, seed=0), jtask, jtr0,
            t_dataset("pamap2", windows_per_subject=60, seed=0), ttask, ttr0)


def _record_S(run) -> list:
    """Wrap the run's flush so each flush's S rows are kept."""
    log, flush = [], run._flush_arrays

    def wrapped(deltas, S, *args, **kw):
        log.append(np.array(S))
        return flush(deltas, S, *args, **kw)

    run._flush_arrays = wrapped
    return log


def _assert_trees_close(jtree, ttree, atol):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = leaves_with_path(params_to_numpy(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(p))


def test_one_flush_homogeneous_matches_reference(setup):
    """Homogeneous fleet, K = N, a = 0: one flush, trainable to atol 1e-5."""
    jds, jtask, jtr0, tds, ttask, ttr0 = setup
    jrun = JA.AsyncFedRun.create(
        jtask, jtr0, JS.async_relief(buffer_size=4, staleness_exponent=0.0),
        j_fleet(4, 0, 0, M=4), JA.AsyncFedConfig(rounds=1, **KW))
    jrun.run(jds, total_updates=4)
    trun = TA.AsyncFedRun.create(
        ttask, ttr0, TS.async_relief(buffer_size=4, staleness_exponent=0.0),
        t_fleet(4, 0, 0, M=4), TA.AsyncFedConfig(rounds=1, **KW))
    trun.run(tds, total_updates=4)
    assert jrun.state.round == trun.state.round == 1
    _assert_trees_close(jrun.state.trainable, trun.state.trainable, 1e-5)


@pytest.mark.parametrize("strategy,codec", [("async_relief", "none"),
                                            ("async_relief", "int8"),
                                            ("async_fedbuff", "none")])
def test_two_flushes_paper_fleet_match_reference(setup, strategy, codec):
    """Fleet (3,3,2), K = 4, a = 0.5, two flushes: RELIEF with both uplink
    codecs, and the modality-unaware FedBuff baseline (fedavg weights).

    Allocation is a top-k over the divergence EMA, which an fp tie could
    flip in a later flush; so flushes are compared only while their S rows
    agree (here they agree throughout, which the test also requires of the
    first flush)."""
    jds, jtask, jtr0, tds, ttask, ttr0 = setup
    runs = []
    for A, S, task, tr0, fleet, ds in (
            (JA, JS, jtask, jtr0, j_fleet, jds),
            (TA, TS, ttask, ttr0, t_fleet, tds)):
        run = A.AsyncFedRun.create(
            task, tr0, S.get(strategy, buffer_size=4, staleness_exponent=0.5),
            fleet(3, 3, 2, M=4, hetero_scale=100.0),
            A.AsyncFedConfig(rounds=1, uplink_codec=codec, **KW))
        log = _record_S(run)
        hist = run.run(ds, total_updates=8)
        runs.append((run, hist, log))
    (jrun, jh, jS), (trun, th, tS) = runs
    assert len(jS) == len(tS) == 2
    agree = 0
    while agree < 2 and np.array_equal(jS[agree], tS[agree]):
        agree += 1
    assert agree >= 1, "first flush allocation differs"
    for key in ("sim_time_s", "staleness_mean", "selected_frac", "flush"):
        assert th[key][:agree] == jh[key][:agree], key
    np.testing.assert_allclose(th["loss"][:agree], jh["loss"][:agree],
                               rtol=1e-4)
    assert np.isfinite(th["f1"]).all()
    if agree == 2:
        _assert_trees_close(jrun.state.trainable, trun.state.trainable, 1e-4)
        np.testing.assert_allclose(trun.state.dbar, jrun.state.dbar,
                                   rtol=1e-3, atol=1e-9)


def test_unported_options_raise(setup):
    """Every option of the reference is ported; both runtimes refuse what
    the reference's refuse: ``alloc="random"`` under a modality schedule
    and a schedule of another (N, M) than the fleet's, and the vectorized
    one selective upload outside grad mode "dispatch"."""
    from repro_torch.sim import streaming_schedule

    _, _, _, tds, ttask, ttr0 = setup
    fleet = t_fleet(2, 0, 0, M=4)
    sched = streaming_schedule(fleet.modality_mask, 0.3, 40.0, 0)
    wrong = streaming_schedule(np.ones((3, 4), bool), 0.3, 40.0, 0)
    for run_cls in (TA.AsyncFedRun, TA.VectorizedAsyncFedRun):
        with pytest.raises(ValueError, match="random"):
            run_cls.create(ttask, ttr0, TS.get("async_relief", alloc="random"),
                           fleet, TA.AsyncFedConfig(rounds=1,
                                                    modality_schedule=sched))
        with pytest.raises(ValueError, match="does not match fleet"):
            run_cls.create(ttask, ttr0, TS.async_relief(), fleet,
                           TA.AsyncFedConfig(rounds=1,
                                             modality_schedule=wrong))
        for strat in (TS.relief_selective(), TS.fedmfs_selective()):
            run_cls.create(ttask, ttr0, strat, fleet,
                           TA.AsyncFedConfig(rounds=1,
                                             modality_schedule=sched))
    for grad_mode in ("cohort", "none"):
        with pytest.raises(ValueError, match="selective upload"):
            TA.VectorizedAsyncFedRun.create(
                ttask, ttr0, TS.relief_selective(), fleet,
                TA.AsyncFedConfig(rounds=1, grad_mode=grad_mode))
    with pytest.raises(ValueError, match="uplink_codec"):
        TA.AsyncFedRun.create(ttask, ttr0, TS.async_relief(), fleet,
                              TA.AsyncFedConfig(rounds=1, uplink_codec="int4"))


def test_entry_point_runs_on_cpu(capsys):
    """The slice end to end through its entry point, small model, CPU."""
    from repro_torch.launch import train_async_har

    hist = train_async_har.main(["--device", "cpu", "--small", "--rounds", "1",
                                 "--codec", "int8"])
    assert len(hist["flush"]) == 2 and np.isfinite(hist["loss"]).all()
    assert 0.0 <= hist["f1"][-1] <= 1.0
    assert "2 flushes (8 updates)" in capsys.readouterr().out


def test_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.kernels.runtime import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
