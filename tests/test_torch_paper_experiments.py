"""The rest of the paper's experiments in the port's runner
(``launch/experiments.py``: Table III ``ablation``, Tables IV-V
``sensitivity``, Fig. 5 ``convergence``, Fig. 6 ``permodality``, Fig. 8
``device_profile``, Figs. 2-3 ``motivation``) against the reference's
scripts under ``benchmarks/``, on the CPU.

Each table or figure is computed from runs: both sides get the same canned
run dicts (real 2-round port runs) through a patched ``run_spec``, with
the reference script's ``RESULTS_DIR`` at a temp directory, and must give
exactly the same rows and files. The runs themselves (v1; v2 under the
forward-aware timing model; v3 at a 10x compute gap) are held against a
reference ``FedRun`` built by ``benchmarks/common.py`` ``_build``, with the
reference's weights; Tables IV-V's fleets and FedConfigs field by field;
and Figs. 2-3 against the reference script's own instrumented run."""
import dataclasses
import hashlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import bench_ablation as JA  # noqa: E402
from benchmarks import bench_convergence as JCV  # noqa: E402
from benchmarks import bench_device_profile as JDP  # noqa: E402
from benchmarks import bench_motivation as JMO  # noqa: E402
from benchmarks import bench_permodality as JPM  # noqa: E402
from benchmarks import bench_sensitivity as JSE  # noqa: E402
from benchmarks import common as JB  # noqa: E402
from repro.configs import relief_har as JC  # noqa: E402
from repro.core.tasks import MMTask as JTask  # noqa: E402
from repro_torch.configs import relief_har as TC  # noqa: E402
from repro_torch.core.tasks import MMTask as TTask  # noqa: E402
from repro_torch.launch import experiments as X  # noqa: E402

ROUNDS, WINDOWS = 2, 40
# simulated time and energy are numpy float64 on both sides; losses are
# fp32 sums in another order
SIM_RTOL, LOSS_RTOL = 1e-9, 1e-4
# Figs. 2-3 after 3 rounds: cosines of fp32 updates that differ by their
# rounding (~1e-6 relative); divergences are variances of those updates
COS_ATOL, DIV_RTOL = 1e-4, 1e-3

# the runs held against the reference: (method, BenchSpec overrides)
REAL = [("v1", {}), ("v2", {"sim_mode": "fwd_aware"}),
        ("v3", {"hetero_scale": 10.0})]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ref_spec(spec: X.BenchSpec) -> JB.BenchSpec:
    jspec = JB.BenchSpec(**dataclasses.asdict(spec))
    assert jspec.key() == spec.key()
    return jspec


@pytest.fixture(scope="module")
def runs():
    """(reference history, port metrics) per REAL entry: B1 small, PAMAP2,
    2 rounds; the reference runs share one compiled local update."""
    shared, out = {}, {}
    for method, kw in REAL:
        spec = X.BenchSpec(method, "pamap2", "b1", ROUNDS, windows=WINDOWS,
                           **kw)
        run, ds, task = JB._build(_ref_spec(spec))
        run.local_update = shared.setdefault("lu", run.local_update)
        params = jax.tree.map(np.asarray, task.params(run.state.trainable))
        hist = run.run(ds)
        out[method] = hist, X.run_spec(spec, verbose=False, params=params,
                                       device="cpu", cache_dir=None)
    return out


@pytest.mark.parametrize("method", [m for m, _ in REAL])
def test_short_runs_match_reference(runs, method):
    """v1, v2 under the forward-aware timing model and v3 at a 10x compute
    gap: simulated round times, energy and upload to rtol 1e-9, losses to
    rtol 1e-4."""
    h, got = runs[method]
    np.testing.assert_allclose(got["round_times"], h["round_time_s"],
                               rtol=SIM_RTOL)
    for key in ("round_time_s", "energy_j", "upload_mb", "selected_frac"):
        np.testing.assert_allclose(got[key], float(np.mean(h[key])),
                                   rtol=SIM_RTOL, err_msg=key)
    np.testing.assert_allclose(got["loss_curve"], h["loss"], rtol=LOSS_RTOL)
    assert got["f1_rounds"] == h["f1_round"]


# ---------------------------------------------------------------------------
# the tables and figures, from the same canned runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def canned(runs):
    """spec key -> one of the real port runs, the same for both sides."""
    pool = [runs[m][1] for m, _ in REAL]

    def pick(key: str) -> dict:
        return pool[int(hashlib.md5(key.encode()).hexdigest(), 16)
                    % len(pool)]
    return pick


def _patch_both(monkeypatch, canned, module, tmp_path):
    """Serve canned runs to the reference script and to the port; -> the
    keys each asked for, in order of first request."""
    asked = {"ref": [], "port": []}

    def ref_run_spec(spec):
        asked["ref"].append(spec.key())
        return canned(spec.key())

    def port_run_spec(spec, device=None, cache_dir=None):
        assert device == "cpu" and cache_dir is None
        asked["port"].append(spec.key())
        return canned(spec.key())

    monkeypatch.setattr(module, "run_spec", ref_run_spec)
    monkeypatch.setattr(module, "RESULTS_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(X, "run_spec", port_run_spec)
    return asked


def _firsts(keys):
    return list(dict.fromkeys(keys))


def _same_rows(got, want):
    assert [list(r.items()) for r in got] == [list(r.items()) for r in want]


CASES = {  # name -> (reference script, its run() kwargs, port call, files)
    "ablation": (JA, dict(rounds=ROUNDS, backbones=("b1", "b2")),
                 lambda **kw: X.ablation(ROUNDS, backbones=("b1", "b2"),
                                         **kw), ["table_ablation.csv"]),
    "sensitivity": (JSE, dict(rounds=ROUNDS),
                    lambda **kw: X.sensitivity(ROUNDS, **kw),
                    ["table_sensitivity_pamap2_b1.csv"]),
    "sensitivity_N100": (JSE, dict(rounds=100, dataset="mhealth",
                                   backbone="b2"),
                         lambda **kw: X.sensitivity(100, dataset="mhealth",
                                                    backbone="b2", **kw),
                         ["table_sensitivity_mhealth_b2.csv"]),
    "convergence": (JCV, dict(rounds=ROUNDS),
                    lambda **kw: X.convergence(ROUNDS, **kw),
                    ["fig_convergence.csv"]),
    "permodality": (JPM, dict(rounds=ROUNDS),
                    lambda **kw: X.permodality(ROUNDS, **kw),
                    ["fig_permodality.csv"]),
    "device_profile": (JDP, dict(rounds=20),
                       lambda **kw: X.device_profile(20, **kw),
                       ["device_profile.json"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_rows_match_reference_script(canned, monkeypatch, tmp_path, name):
    """The same runs give exactly the reference script's rows (keys, order,
    values) and the same CSV or JSON file, from the same runs asked for in
    the same order (the port asks once for a run the reference asks for
    twice)."""
    module, ref_kw, port, files = CASES[name]
    asked = _patch_both(monkeypatch, canned, module, tmp_path)
    want = module.run(**ref_kw)
    got = port(device="cpu", cache_dir=None, out_dir=tmp_path / "port")
    if isinstance(want, dict):
        assert list(got) == list(want)
        for b in want:
            assert list(got[b].items()) == list(want[b].items())
    else:
        _same_rows(got, want)
    assert asked["port"] == _firsts(asked["ref"])
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f


def _sensitivity_ref_specs(monkeypatch, canned):
    specs = []

    def record(spec):
        specs.append(spec)
        return canned(spec.key())
    monkeypatch.setattr(JSE, "run_spec", record)
    monkeypatch.setattr(JSE, "save_csv", lambda *a, **k: None)
    JSE.run(rounds=100)
    return specs


def test_sensitivity_settings_match_reference(canned, monkeypatch):
    """Tables IV-V ask for the reference's specs at 100 rounds (N = 8, 20,
    50 and 100), in its order; for each setting the port builds the same
    fleet and FedConfig, field by field, as the reference's ``_build``."""
    ref_specs = _sensitivity_ref_specs(monkeypatch, canned)
    settings = X.sensitivity_specs(100)
    specs = [s for _, _, group in settings for s in group]
    assert [s.key() for s in specs] == [s.key() for s in ref_specs]
    assert [(f, s) for f, s, _ in settings] == [
        ("hetero", "mild_10x"), ("hetero", "moderate_55x"),
        ("hetero", "extreme_100x"), ("scale", "N=8"), ("scale", "N=20"),
        ("scale", "N=50"), ("scale", "N=100")]
    for _, _, (spec, *_) in settings:
        jrun, _, _ = JB._build(_ref_spec(spec))
        trun, _, _ = X.build_bench(spec, device="cpu")
        assert trun.fleet.N == jrun.fleet.N == (spec.n_clients or 8)
        for f in dataclasses.fields(jrun.fleet):
            a, b = getattr(trun.fleet, f.name), getattr(jrun.fleet, f.name)
            if f.compare:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f.name)
        assert dataclasses.asdict(trun.fed) == dataclasses.asdict(jrun.fed)


# ---------------------------------------------------------------------------
# Figs. 2-3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def motivation_pair(tmp_path_factory):
    """The reference script's Figs. 2-3 (PAMAP2_B1_SMALL, 3 rounds) and the
    port's from the reference's weights."""
    tmp = tmp_path_factory.mktemp("motivation")
    mp = pytest.MonkeyPatch()
    mp.setattr(JMO, "RESULTS_DIR", str(tmp))
    try:
        want = JMO.run(rounds=3, force=True)
    finally:
        mp.undo()
    task, tr0 = JTask.create(JC.PAMAP2_B1_SMALL, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, task.params(tr0))
    got = X.motivation(3, device="cpu", cache_dir=None, params=params)
    return want, got


def test_motivation_matches_reference(motivation_pair):
    """Fig. 2's mean cosines by block and pair type to atol 1e-4; Fig. 3's
    divergence by block and phase and Observation 2's Mag/Acc ratios to
    rtol 1e-3. An Acc-only client's absent blocks give 0.0 on both."""
    want, got = motivation_pair
    f2w, f2g = want["fig2_block_cosine"], got["fig2_block_cosine"]
    assert list(f2g) == list(f2w) == ["full_full", "full_acconly"]
    for pt in f2w:
        assert list(f2g[pt]) == list(f2w[pt])
        np.testing.assert_allclose(list(f2g[pt].values()),
                                   list(f2w[pt].values()), atol=COS_ATOL,
                                   err_msg=pt)
    assert f2g["full_acconly"]["A_mag"] == f2w["full_acconly"]["A_mag"] == 0.0
    f3w, f3g = want["fig3_divergence_phases"], got["fig3_divergence_phases"]
    assert list(f3g) == list(f3w) == ["A_acc", "A_gyro", "A_mag", "A_hr"]
    for blk in f3w:
        assert len(f3g[blk]) == 3
        np.testing.assert_allclose(f3g[blk], f3w[blk], rtol=DIV_RTOL,
                                   err_msg=blk)
    np.testing.assert_allclose(got["obs2_rare_to_common_ratio"],
                               want["obs2_rare_to_common_ratio"],
                               rtol=DIV_RTOL)
    assert got["device"] == "cpu" and got["host_wall_s"] > 0


def test_block_cosines_match_reference():
    """``block_cosines`` on the same stacked fusion update: the same blocks
    and float32 values, 0.0 for an Acc-only client's zero blocks."""
    jtask, jtr0 = JTask.create(JC.PAMAP2_B1_SMALL, jax.random.PRNGKey(0))
    ttask, _ = TTask.create(TC.PAMAP2_B1_SMALL, device="cpu",
                            params=jax.tree.map(np.asarray,
                                                jtask.params(jtr0)))
    fusion = np.random.default_rng(5).normal(
        size=(8,) + jtr0["base"]["fusion_w0"].shape).astype(np.float32)
    fusion[6:, 16:] = 0.0  # clients 6-7 hold acc only
    for pairs in (X.FULL_PAIRS, X.CROSS_PAIRS):
        want = JMO.block_cosines({"base": {"fusion_w0": fusion}},
                                 jtask.layout, pairs)
        got = X.block_cosines({"base": {"fusion_w0": torch.from_numpy(
            fusion)}}, ttask.layout, pairs)
        assert got == want
    assert got["A_mag"] == [0.0, 0.0, 0.0]


def test_motivation_caches_its_json(tmp_path, monkeypatch):
    """The JSON goes to the run cache directory (read back without running
    again), never under ``benchmarks/``."""
    first = X.motivation(1, device="cpu", cache_dir=tmp_path)
    files = list(tmp_path.glob("motivation_b1_small_r1_s0_cpu*.json"))
    assert len(files) == 1

    def boom(*a, **k):
        raise AssertionError("ran again")
    monkeypatch.setattr(X, "FedRun", boom)
    assert X.motivation(1, device="cpu", cache_dir=tmp_path) == first


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_real_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """``ablation`` (PAMAP2 only) and ``motivation`` run for real on the
    CPU with ``--rounds 2``, their outputs in the (patched) cache
    directory; ``--no-cache`` reads and writes no run."""
    monkeypatch.setattr(X, "CACHE_DIR", tmp_path)
    rows = X.main(["ablation", "--rounds", "2", "--datasets", "pamap2",
                   "--device", "cpu"])
    assert [r["variant"] for r in rows] == X.ABLATION_VARIANTS
    assert all(0.0 <= r["f1_pamap2"] <= 1.0 and r["speedup"] > 0
               for r in rows)
    assert (tmp_path / "table_ablation.csv").is_file()
    assert len(list((tmp_path / "runs").glob("*.json"))) == 5
    out = X.main(["motivation", "--rounds", "2", "--device", "cpu",
                  "--no-cache"])
    assert all(-1.0 <= v <= 1.0 for pt in out["fig2_block_cosine"].values()
               for v in pt.values())
    assert not list(tmp_path.glob("motivation_*.json"))
    text = capsys.readouterr().out
    assert "[experiments] device: cpu" in text and "Table III" in text
    assert "Fig. 3" in text and "s/round) on cpu" in text


@pytest.mark.parametrize("argv,call", [
    (["sensitivity", "--dataset", "mhealth"],
     ("sensitivity", dict(dataset="mhealth", backbone="b1"))),
    (["convergence", "--backbone", "b1,b2", "--full"],
     ("convergence", dict(backbones=("b1", "b2"), small=False))),
    (["permodality", "--seed", "3"],
     ("permodality", dict(backbones=("b1",), seed=3))),
    (["device-profile"], ("device_profile", dict(backbones=("b1", "b2")))),
])
def test_cli_subcommands_on_cpu(tmp_path, monkeypatch, argv, call):
    """The other subcommands with ``--rounds 2 --device cpu``: each calls
    its function with the script's defaults and the flags given, outputs
    to the cache directory (``--no-cache``: no run cache)."""
    monkeypatch.setattr(X, "CACHE_DIR", tmp_path)
    seen = {}
    name, want = call

    def fake(rounds, **kw):
        seen.update(kw, rounds=rounds)
        return []
    monkeypatch.setattr(X, name, fake)
    for extra, cache in (([], tmp_path), (["--no-cache"], None)):
        X.main(argv + ["--rounds", "2", "--device", "cpu"] + extra)
        assert seen["rounds"] == 2 and seen["cache_dir"] == cache
        assert seen["out_dir"] == tmp_path
        assert seen["device"] == torch.device("cpu")
        for k, v in ({"seed": 0, "small": True} | want).items():
            assert seen[k] == v, k


def test_cli_rejects_a_backbone_list_where_the_script_takes_one():
    with pytest.raises(SystemExit):
        X.main(["motivation", "--backbone", "b1,b2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        X.main(["ablation", "--backbone", "b3", "--device", "cpu"])
