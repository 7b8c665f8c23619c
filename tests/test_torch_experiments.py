"""The port's experiment runner (``launch/experiments.py``: Tables I-II and
the scenario matrix) against the JAX reference, on the CPU: ``run_spec``
for fedavg and relief on PAMAP2 Backbones 1 and 2 (small width, 2 rounds)
against a reference ``FedRun`` built as the reference's benchmark harness
builds it, the table's derived columns, the run cache,
``metrics.time_to_accuracy``, ``multimodal.split_modalities`` and the
command line with ``--device cpu``.

Both packages get the same numpy data and the reference's initial weights;
the reference runs of one backbone share one compiled local update."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import metrics as JM  # noqa: E402
from repro.models import multimodal as JMM  # noqa: E402
from repro_torch.core import metrics as TM  # noqa: E402
from repro_torch.launch import experiments as X  # noqa: E402
from repro_torch.models import multimodal as TMM  # noqa: E402

ROUNDS, WINDOWS = 2, 40
# simulated time, energy and upload are numpy float64 on both sides;
# losses are fp32 sums in another order; a macro-F1 moves only where a
# test window's top two logits lie within that rounding of each other
SIM_RTOL, LOSS_RTOL, F1_ATOL = 1e-9, 1e-4, 0.02


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """JAX's thread pool shares the process, so torch's CPU ops run 2
    threads: with all 8 they contend with it and run ~4x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference_run(spec: X.BenchSpec, shared: dict):
    """The reference's FedRun, dataset and task for ``spec``, built from
    ``repro`` alone in the order of the reference's benchmark harness
    (``benchmarks/common.py`` ``_build``)."""
    from repro.core import strategies
    from repro.core.engine import FedConfig, FedRun
    from repro.core.tasks import MMTask
    from repro.data import get_provider
    from repro.sim import ScenarioSpec, build_fleet

    sspec = ScenarioSpec(
        name=spec.key(), dataset=spec.dataset, missing="none",
        windows_per_subject=spec.windows,
        fleet=(3, 3, 2 if spec.dataset == "pamap2" else 4),
        n_clients=spec.n_clients, hetero_scale=spec.hetero_scale,
        strategy=spec.method,
        backbone="cnn" if spec.backbone == "b1" else "transformer",
        small_model=spec.small, rounds=spec.rounds,
        eval_every=max(spec.rounds // 10, 1), t_overhead=0.1,
        utilization=2e-5, seed=spec.seed)
    provider = get_provider(spec.dataset)
    fleet = build_fleet(sspec)
    ds = provider.build(seed=spec.seed, n_clients=fleet.N,
                        windows_per_subject=spec.windows)
    cfg = provider.mm_config(sspec.backbone, small=spec.small)
    task, tr0 = MMTask.create(cfg, jax.random.PRNGKey(spec.seed))
    fed = FedConfig.from_scenario(sspec, sim_mode=spec.sim_mode)
    run = FedRun.create(task, tr0, strategies.get(spec.method), fleet, fed)
    run.local_update = shared.setdefault((spec.backbone,
                                          run.strategy.prox_mu),
                                         run.local_update)
    return run, ds, task, jax.tree.map(np.asarray, task.params(tr0))


@pytest.fixture(scope="module")
def pairs():
    """(reference metrics, port metrics) per (backbone, method)."""
    shared, out = {}, {}
    for backbone in ("b1", "b2"):
        for method in ("fedavg", "relief"):
            spec = X.BenchSpec(method, "pamap2", backbone, ROUNDS,
                               windows=WINDOWS)
            run, ds, task, params = _reference_run(spec, shared)
            hist = run.run(ds)
            per_mod = task.eval_per_modality(
                run.state.trainable, np.concatenate(ds.test_x),
                np.concatenate(ds.test_y))
            ref = dict(hist=hist, per_mod=per_mod,
                       rare=JM.rare_modality_f1(per_mod,
                                                X.RARE_MODALITIES["pamap2"]),
                       names=task.layout.names)
            out[backbone, method] = ref, X.run_spec(
                spec, verbose=False, params=params, device="cpu",
                cache_dir=None)
    return out


@pytest.mark.parametrize("backbone", ["b1", "b2"])
@pytest.mark.parametrize("method", ["fedavg", "relief"])
def test_run_spec_matches_reference(pairs, backbone, method):
    ref, got = pairs[backbone, method]
    h = ref["hist"]
    assert got["f1_rounds"] == h["f1_round"]
    assert got["group_names"] == ref["names"]
    np.testing.assert_allclose(got["round_times"], h["round_time_s"],
                               rtol=SIM_RTOL)
    for key, src in (("round_time_s", "round_time_s"),
                     ("energy_j", "energy_j"), ("upload_mb", "upload_mb"),
                     ("selected_frac", "selected_frac")):
        np.testing.assert_allclose(got[key], float(np.mean(h[src])),
                                   rtol=SIM_RTOL, err_msg=key)
    np.testing.assert_allclose(got["loss_curve"], h["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["divergence_curves"],
                               np.asarray(h["divergence"]), rtol=1e-3,
                               atol=1e-9)
    np.testing.assert_allclose(got["f1_curve"], h["f1"], atol=F1_ATOL)
    assert got["f1"] == got["f1_curve"][-1]
    assert sorted(got["per_modality_f1"]) == sorted(ref["per_mod"])
    for m, v in ref["per_mod"].items():
        np.testing.assert_allclose(got["per_modality_f1"][m], v,
                                   atol=F1_ATOL, err_msg=m)
    np.testing.assert_allclose(got["rare_mod_f1"], ref["rare"],
                               atol=F1_ATOL)
    assert got["device"] == "cpu" and got["host_wall_s"] > 0


def test_bench_spec_keys_match_reference():
    """The same fields and the same cache keys as the reference harness's
    BenchSpec (keys computed by the reference)."""
    assert [f.name for f in dataclasses.fields(X.BenchSpec)] == [
        "method", "dataset", "backbone", "rounds", "seed", "hetero_scale",
        "n_clients", "sim_mode", "windows", "small"]
    assert X.BenchSpec("relief").key() == "relief_pamap2_b1_r30_s0_352c0355"
    assert X.BenchSpec("fedavg", "mhealth", "b2", 200, 3,
                       small=False).key() == \
        "fedavg_mhealth_b2_r200_s3_ee818882"


def test_main_table_columns(pairs, monkeypatch):
    """main_table's rows from the runs it is given: speedup, TTA and the
    energy saving against FedAvg on the same dataset; FedAvg runs once."""
    calls = []

    def fake(spec, device=None, cache_dir=None):
        calls.append(spec.method)
        return pairs["b2", spec.method][1]

    monkeypatch.setattr(X, "run_spec", fake)
    rows = X.main_table("b2", ROUNDS, methods=["fedavg", "relief"],
                        datasets=("pamap2",), device="cpu", cache_dir=None)
    assert calls == ["fedavg", "relief"]
    base, rel = pairs["b2", "fedavg"][1], pairs["b2", "relief"][1]
    assert [r["method"] for r in rows] == [X.METHOD_LABELS["fedavg"],
                                           X.METHOD_LABELS["relief"]]
    r = rows[1]
    assert r["speedup"] == base["round_time_s"] / rel["round_time_s"]
    assert r["energy_save_pct"] == 100 * (1 - rel["energy_j"]
                                          / base["energy_j"])
    tta = X.tta_rounds(rel["f1_curve"], rel["f1_rounds"], 0.95 * base["f1"])
    assert r["tta_rounds"] == (tta if tta is not None else "-")
    assert rows[0]["speedup"] == 1.0 and rows[0]["energy_save_pct"] == 0.0
    text = X.fmt_table(rows, X.TABLE_COLUMNS, "t")
    assert "RELIEF (ours) | pamap2" in text


def test_run_cache_round_trip(tmp_path, monkeypatch):
    """A finished run is written under the cache directory and read back
    on the next call without running again; ``force`` runs it again."""
    spec = X.BenchSpec("fedavg", "pamap2", "b1", 1, windows=WINDOWS)
    first = X.run_spec(spec, verbose=False, device="cpu", cache_dir=tmp_path)
    files = list((tmp_path / "runs").glob(f"{spec.key()}_cpu*.json"))
    assert len(files) == 1

    def boom(*a, **k):
        raise AssertionError("ran again")

    monkeypatch.setattr(X, "build_bench", boom)
    again = X.run_spec(spec, verbose=False, device="cpu", cache_dir=tmp_path)
    assert again["f1_curve"] == first["f1_curve"]
    with pytest.raises(AssertionError, match="ran again"):
        X.run_spec(spec, verbose=False, device="cpu", cache_dir=tmp_path,
                   force=True)


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.55, 0.9, 2.0])
def test_time_to_accuracy_matches_reference(threshold):
    g = np.random.default_rng(4)
    curve = list(np.sort(g.random(9)))
    times = list(g.random(9) * 3.0)
    got = TM.time_to_accuracy(curve, times, threshold)
    want = JM.time_to_accuracy(curve, times, threshold)
    assert got == want
    assert (got is None) == (threshold > max(curve))


@pytest.mark.parametrize("dataset", ["pamap2", "mhealth", "ucf101_av"])
def test_split_modalities_matches_reference(dataset):
    from repro.data import get_provider as j_provider
    from repro_torch.data import get_provider as t_provider

    jcfg = j_provider(dataset).mm_config("cnn", small=True)
    tcfg = t_provider(dataset).mm_config("cnn", small=True)
    x = np.random.default_rng(1).normal(
        size=(3, jcfg.window, jcfg.total_channels)).astype(np.float32)
    want = JMM.split_modalities(jcfg, x)
    got = TMM.split_modalities(tcfg, torch.as_tensor(x))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_cli_table_on_cpu(capsys):
    rows = X.main(["table", "--backbone", "b1", "--rounds", "1",
                   "--methods", "fedavg,relief", "--datasets", "pamap2",
                   "--no-cache", "--device", "cpu"])
    assert [r["method"] for r in rows] == [X.METHOD_LABELS["fedavg"],
                                           X.METHOD_LABELS["relief"]]
    assert all(0.0 <= r["f1"] <= 1.0 for r in rows)
    out = capsys.readouterr().out
    assert "[experiments] device: cpu" in out and "Table I (Backbone b1" in out


def test_cli_scenarios_on_cpu(capsys):
    rows = X.main(["scenarios", "--scenarios", "stream30", "--methods",
                   "async_accessible,fedmfs_selective", "--updates", "8",
                   "--windows", "40", "--device", "cpu"])
    assert [r["method"] for r in rows] == ["async_accessible",
                                           "fedmfs_selective"]
    assert all(r["flushes"] == 2 for r in rows)
    assert rows[1]["upload_mb"] < rows[0]["upload_mb"]
    assert "selective gate: stream30" in capsys.readouterr().out
