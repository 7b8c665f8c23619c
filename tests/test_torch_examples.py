"""The port's counterparts of the reference's example scripts
(``launch/fleet_scale_sim.py``, ``quickstart.py``, ``baseline_duel.py``,
``serve_backbone.py``) against the reference on the CPU, and the three
earlier ported examples' configurations against theirs.

The scripts are ``main()``s, so the reference's side is each script's own
construction reproduced here with ``repro`` calls, cited by line. Both
packages get the reference's initial weights (``convert.params_from_numpy``
through ``MMTask.create(params=...)``, also inside the port's ``main``s)
and the same prompts.

Tolerances: the fleet simulation's numbers and the greedy tokens exactly;
losses rtol 1e-4 (fp32 sums in another order, as tests/test_torch_sync.py);
simulated round time, energy and upload rtol 1e-9 (the same float64 cost
model); F1 within 1e-3 absolute (a prediction flipped by the losses'
rounding moves the macro-F1 by ~1e-3 on these test sets).
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import strategies as JS  # noqa: E402
from repro.core.async_engine import AsyncFedConfig as JAFC  # noqa: E402
from repro.core.async_engine import VectorizedAsyncFedRun as JVec  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro.data import get_provider as j_provider  # noqa: E402
from repro.data import make_har_dataset as j_dataset  # noqa: E402
from repro.data import mm_config_for as j_cfg  # noqa: E402
from repro.launch import step_fns as JSF  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.sim import FleetConfig as JFleetConfig  # noqa: E402
from repro.sim import ScenarioSpec as JSpec  # noqa: E402
from repro.sim import build_scenario as j_scenario  # noqa: E402
from repro.sim import make_fleet as j_fleet  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.strategies import ALL_BASELINES  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.data import mm_config_for as t_cfg  # noqa: E402
from repro_torch.launch import baseline_duel, fleet_scale_sim  # noqa: E402
from repro_torch.launch import quickstart, serve_backbone  # noqa: E402
from repro_torch.launch import train_async_har, train_relief_har  # noqa: E402

# the numbers of fleet_scale_sim's summary that its host wall sets
WALL_KEYS = ("wall_s", "events_per_s", "flushes_per_s")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process: torch runs 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_fleets_equal(jf, tf):
    for f in dataclasses.fields(JFleetConfig):
        if f.compare:
            np.testing.assert_array_equal(np.asarray(getattr(tf, f.name)),
                                          np.asarray(getattr(jf, f.name)),
                                          err_msg=f.name)


# ---------------------------------------------------------------------------
# fleet_scale_sim
# ---------------------------------------------------------------------------


def _ref_fleet_sim(n, flushes, buffer, churn, arrival, jitter, seed):
    """examples/fleet_scale_sim.py:42-60 -> (summary, run)."""
    spec = JSpec(
        "fleet_scale", n_clients=n, strategy="async_relief",
        strategy_args=(("buffer_size", buffer),), rounds=1,
        local_epochs=1, steps_per_epoch=1, batch_size=4, eval_every=0,
        jitter_sigma=jitter, grad_mode="none", seed=seed)
    fleet = JFleetConfig.from_scenario(spec)
    cfg = j_provider(spec.dataset).mm_config(spec.backbone,
                                             small=spec.small_model)
    task, tr0 = JTask.create(cfg, jax.random.PRNGKey(seed))
    fed = JAFC.from_scenario(spec, churn_rate=churn, arrival_rate=arrival)
    run = JVec.create(task, tr0, spec.build_strategy(), fleet, fed)
    run.run(None, total_updates=flushes * min(buffer, n))
    return fleet_scale_sim.summary(run, 1.0), run


def test_fleet_scale_sim_equals_reference():
    """N = 10^4, K = 64, 20 flushes, churn 0.01, arrivals 0.02, jitter
    0.1: every number of the summary but the host wall's, the per-flush
    staleness, every client's update count and liveness exactly equal."""
    args = (10_000, 20, 64, 0.01, 0.02, 0.1, 0)
    want, jrun = _ref_fleet_sim(*args)
    n, flushes, buffer, churn, arrival, jitter, seed = args
    trun = fleet_scale_sim.build(n, buffer, churn, arrival, jitter, seed,
                                 "cpu")
    got = fleet_scale_sim.simulate(trun, flushes)
    assert got.keys() == want.keys()
    for k in got.keys() - set(WALL_KEYS):
        assert got[k] == want[k], k
    assert got["flushes"] == flushes
    assert got["completions"] >= flushes * buffer
    np.testing.assert_array_equal(trun.history["staleness_mean"],
                                  jrun.history["staleness_mean"])
    np.testing.assert_array_equal(trun.fstate.updates, jrun.fstate.updates)
    np.testing.assert_array_equal(trun.fstate.alive, jrun.fstate.alive)
    assert 0 < got["alive_frac"] <= 1


def test_fleet_scale_sim_main_on_cpu(capsys):
    s = fleet_scale_sim.main(["--n", "500", "--flushes", "5", "--buffer",
                              "16", "--churn-rate", "0.01", "--device",
                              "cpu"])
    out = capsys.readouterr().out
    assert s["flushes"] == 5 and s["completions"] >= 80
    assert np.isfinite(s["sim_time_s"]) and s["staleness_max"] >= 0
    assert "population: alive" in out and "events/s" in out


# ---------------------------------------------------------------------------
# quickstart and baseline_duel: the sync FedRun on the narrow CNN
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def b1():
    """The scripts' narrow CNN on PAMAP2: the reference's task, its initial
    weights (as numpy) and the reference runs' shared compiled update."""
    cfg = dict(quickstart.MODEL)
    assert cfg == dict(backbone="cnn", d_feat=16, d_fused=64,
                       cnn_ch=(16, 32))  # examples/quickstart.py:33-34
    jtask, jtr0 = JTask.create(j_cfg("pamap2", **cfg), jax.random.PRNGKey(0))
    return jtask, jtr0, jax.tree.map(np.asarray, jtask.params(jtr0)), {}


def _main_from(b1, mod, argv):
    """``mod.main(argv + ["--device", "cpu"])`` with the reference's initial
    weights in place of those drawn from ``--seed``; everything else is
    main's own construction -> (result, printed text)."""
    params = b1[2]

    class FromReference:
        @staticmethod
        def create(cfg, generator=None, device=None):
            return TTask.create(cfg, params=params, device=device)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(mod, "MMTask", FromReference)
        res = mod.main(argv + ["--device", "cpu"])
    return res, out.getvalue()


@pytest.fixture(scope="module")
def quickstart_main(b1):
    """quickstart's main at 2 rounds (one run for the module's tests)."""
    return _main_from(b1, quickstart, ["--rounds", "2"])


@pytest.fixture(scope="module")
def duel_main(b1):
    """baseline_duel's main at 1 round: all eleven methods."""
    return _main_from(b1, baseline_duel, ["--rounds", "1"])


def _jrun(b1, name, fleet, fed):
    """A reference ``FedRun`` whose compiled local update is shared by
    every reference run of the module (it depends on the task and
    ``prox_mu`` only; each compile takes ~10 s here)."""
    jtask, jtr0, _, shared = b1
    run = JE.FedRun.create(jtask, jtr0, JS.get(name), fleet, fed)
    run.local_update = shared.setdefault(run.strategy.prox_mu,
                                         run.local_update)
    return run


def _assert_history_close(th, jh):
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    for key in ("round_time_s", "energy_j", "upload_mb"):
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-9,
                                   err_msg=key)
    assert th["f1_round"] == jh["f1_round"]
    np.testing.assert_allclose(th["f1"], jh["f1"], atol=1e-3, rtol=0)


def test_quickstart_matches_reference(b1, quickstart_main):
    """quickstart's main at 2 rounds from the reference's tr0
    (examples/quickstart.py:29-44): FedAvg then RELIEF."""
    rounds = 2
    _, _, tfleet, tfed, _ = quickstart.build(rounds, 0, "cpu")
    jds = j_dataset("pamap2", windows_per_subject=160, seed=0)
    jfleet = j_fleet(3, 3, 2, M=4)
    jfed = JE.FedConfig(rounds=rounds, eval_every=max(rounds // 4, 1),
                        utilization=2e-5, seed=0)
    assert dataclasses.asdict(tfed) == dataclasses.asdict(jfed)
    _assert_fleets_equal(jfleet, tfleet)
    got = quickstart_main[0]["histories"]
    assert list(got) == list(quickstart.METHODS)
    for name in quickstart.METHODS:
        _assert_history_close(got[name],
                              _jrun(b1, name, jfleet, jfed).run(jds))


def test_quickstart_main_on_cpu(quickstart_main):
    res, out = quickstart_main
    s = res["summary"]
    assert s["relief"]["round_time_s"] < s["fedavg"]["round_time_s"]
    assert s["speedup"] > 1 and 0 < s["energy_saving"] < 1
    assert "=> training with relief" in out and "quickstart summary" in out


# three aggregation rules: FedAvg's weights, the modality cohorts
# (harmony) and the per-dimension average over the holders (pilot)
DUEL = ("fedavg", "harmony", "pilot")


def test_baseline_duel_matches_reference(b1, duel_main):
    """baseline_duel's main at 1 round (examples/baseline_duel.py:25-45)
    for three methods whose aggregation rules differ."""
    _, _, tfleet, tfed, _ = baseline_duel.build("pamap2", 1, 0, "cpu")
    jds = j_dataset("pamap2", windows_per_subject=120, seed=0)
    jfleet = j_fleet(3, 3, 2, M=4)
    jfed = JE.FedConfig(rounds=1, eval_every=1, utilization=2e-5, seed=0)
    assert dataclasses.asdict(tfed) == dataclasses.asdict(jfed)
    _assert_fleets_equal(jfleet, tfleet)
    rows = {r[0]: r for r in duel_main[0]}
    for name in DUEL:
        _, f1, t, e, mb = rows[name]
        h = _jrun(b1, name, jfleet, jfed).run(jds)
        assert f1 == pytest.approx(h["f1"][-1], abs=1e-3), name
        for got, key in ((t, "round_time_s"), (e, "energy_j"),
                         (mb, "upload_mb")):
            assert got == pytest.approx(float(np.mean(h[key])),
                                        rel=1e-9), (name, key)


def test_baseline_duel_main_runs_all_eleven(duel_main):
    rows, out = duel_main
    assert [r[0] for r in rows] == list(ALL_BASELINES) + ["relief"]
    assert all(0 <= r[1] <= 1 and r[2] > 0 for r in rows)
    assert "speedup" in out


# ---------------------------------------------------------------------------
# serve_backbone
# ---------------------------------------------------------------------------


def _ref_serve(jcfg, jp, prompts, steps):
    """examples/serve_backbone.py:38-55 on the given weights and prompts."""
    B, P = prompts.shape[:2]
    serve_step = jax.jit(JSF.make_serve_step(jcfg))
    caches = japi.init_caches(jcfg, B, P + steps)
    prompts = jnp.asarray(prompts)
    tok = prompts[:, :1]
    for pos in range(P):
        tok, caches = serve_step(jp, caches, prompts[:, pos:pos + 1],
                                 jnp.int32(pos))
    out = []
    for pos in range(P, P + steps):
        tok, caches = serve_step(jp, caches, tok, jnp.int32(pos))
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "phi3-medium-14b",
                                  "musicgen-large"])
def test_serve_backbone_tokens_equal_reference(arch):
    """SMOKE at B=2, P=8, 6 steps: the port's greedy tokens equal the
    reference loop's, with the same prompts and converted parameters."""
    jcfg = jbase.get_arch(arch).SMOKE
    tcfg = tbase.get_arch(arch).SMOKE
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = serve_backbone.draw_prompts(tcfg, 2, 8, seed=0)
    want_shape = (2, 8, 4) if arch == "musicgen-large" else (2, 8)
    assert tuple(prompts.shape) == want_shape
    res = serve_backbone.serve(tcfg, tp, prompts, 6)
    want = _ref_serve(jcfg, jp, prompts.numpy(), 6)
    assert res["tokens"].shape == want.shape == (2, 6) + want_shape[2:]
    np.testing.assert_array_equal(res["tokens"].numpy(), want)


def test_serve_backbone_main_on_cpu(capsys):
    res = serve_backbone.main(["--arch", "phi3-medium-14b", "--batch", "2",
                               "--prompt-len", "4", "--decode-steps", "3",
                               "--device", "cpu"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert "continuation[0]" in capsys.readouterr().out


@pytest.mark.parametrize("mod", [fleet_scale_sim, quickstart, baseline_duel,
                                 serve_backbone])
def test_entry_points_raise_without_a_card(mod):
    """``--device`` defaults to cuda; without a card the entry point raises
    (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--n", "50", "--flushes", "1"] if mod is fleet_scale_sim
                 else ["--rounds", "1"] if mod in (quickstart, baseline_duel)
                 else ["--batch", "1", "--prompt-len", "2",
                       "--decode-steps", "1"])


# ---------------------------------------------------------------------------
# the earlier ported examples' configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backbone", ["b1", "b2"])
def test_train_relief_har_small_mhealth_is_the_reference_example(backbone):
    """``--dataset mhealth --small`` builds exactly the mm_config, fleet and
    FedConfig of examples/train_relief_har.py:40-63 (whose defaults are
    MHEALTH and this narrow model; the port's default is the paper's full
    width on PAMAP2)."""
    run, _ = train_relief_har.build("mhealth", backbone, "relief", 200, 0.1,
                                    small=True, seed=0, device="cpu")
    jcfg = j_cfg(
        "mhealth", backbone="cnn" if backbone == "b1" else "transformer",
        d_feat=16, d_fused=64,
        **({"cnn_ch": (16, 32)} if backbone == "b1" else
           {"enc_layers": 2, "enc_d": 32, "enc_ff": 64}))
    assert dataclasses.asdict(run.task.cfg) == dataclasses.asdict(jcfg)
    _assert_fleets_equal(j_fleet(3, 3, 4, M=4), run.fleet)
    jfed = JE.FedConfig(rounds=200, eval_every=10, seed=0, utilization=2e-5,
                        dropout_prob=0.1)
    assert dataclasses.asdict(run.fed) == dataclasses.asdict(jfed)


def test_train_async_har_small_is_the_reference_example():
    """``--small`` builds exactly the mm_config, fleet and AsyncFedConfig of
    examples/train_async_har.py:45-57 (the reference's scenario takes the
    small model; the port's default is the full-width Backbone 1)."""
    run, _ = train_async_har.build(small=True, device="cpu")
    spec = JSpec(
        "train_async_har", dataset="pamap2", windows_per_subject=200,
        fleet=(3, 3, 2), hetero_scale=100.0, strategy="async_relief",
        strategy_args=(("buffer_size", 4), ("staleness_exponent", 0.5)),
        uplink_codec="none", rounds=50, eval_every=25, t_overhead=1e-3,
        jitter_sigma=0.0, seed=0)
    sc = j_scenario(spec)
    jcfg = j_provider("pamap2").mm_config(spec.backbone,
                                          small=spec.small_model)
    assert dataclasses.asdict(run.task.cfg) == dataclasses.asdict(jcfg)
    _assert_fleets_equal(sc.fleet, run.fleet)
    for f in dataclasses.fields(run.fed):
        assert getattr(run.fed, f.name) == getattr(sc.fed, f.name), f.name
    assert run.strategy.buffer_size == sc.strategy.buffer_size == 4
    assert run.strategy.staleness_exponent == 0.5
