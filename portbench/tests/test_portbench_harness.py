"""The harness: cells found by name, the required names and keys, the
result line, no JAX, and planted faults that make ``correct`` false.

    python -m pytest -q portbench/tests
"""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from _small import HERE, ROOT, har, harness, limits, lm

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
CELLS = [w["name"] for w in BENCH["workloads"]]
calibrate = harness.load_module(HERE / "calibrate.py", "portbench_calibrate")
run_py = harness.load_module(HERE / "run.py", "portbench_run")


def test_benchmark_keys_names_and_units():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group, keys in ((BENCH["configs"], {"name", "source", "file",
                                            "reduced", "why"}),
                        (BENCH["workloads"], {"name", "config", "traffic",
                                              "chips", "why"})):
        for entry in group:
            assert set(entry) == keys
    for m in metrics:
        assert set(m) - {"workloads", "bound", "layer", "moves"} == {
            "name", "unit", "better", "source"}
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in metrics])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]] + [
            k for c in BENCH["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    config = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert json.loads((ROOT / config["file"]).read_text())["name"] == \
        config["name"]
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    assert (HERE / "runners" / f"{traffic['kind']}.py").is_file()
    assert json.loads((HERE / "limits" / f"{cell}.json").read_text())
    e2e = run_py.cell_metrics(BENCH, cell, trace=False)
    layer = run_py.cell_metrics(BENCH, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {x["name"] for x in e2e}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(monkeypatch, trace):
    monkeypatch.setattr(harness, "device_line", lambda count, peak: {
        "platform": "gpu", "kind": "card", "count": count,
        "memory_peak_bytes": peak})
    cell = {x["name"]: x for x in BENCH["workloads"]}[CELLS[0]]
    prof = {"busy_s": 0.5, "window_s": 1.0, "kernels": {},
            "n_device_ops": 10, "device_ops": [["k", 0.5]],
            "idle_gaps": [["aten::mm", 0.1]]}
    res = {"e2e": {"setup_s": 1.0, "round_device_s": 2.0},
           "obs": {"profile": prof if trace else None, "span_rounds": 2,
                   "span_total": {"local_update": 3.0}},
           "readings": {k: 0.0 for k in limits(CELLS[0])},
           "attempted": 3, "failed": 0, "peak": 123}
    ctx = type("C", (), {"trace": trace})()
    line = run_py.result_line(BENCH, cell, ctx, res, limits(CELLS[0]))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == want + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert line["metrics"]["local_update_s.round"]["value"] == 1.5
    else:
        assert set(line["metrics"]) == {"setup_s", "round_device_s"}
    json.dumps(line)


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0, 10)], 10e-9),
    ([(5, 10), (0, 3), (2, 4), (20, 30), (25, 26)], 19e-9),
    ([(0, 100), (10, 20), (30, 40), (90, 120)], 120e-9),
])
def test_device_busy_is_the_union_of_device_intervals(intervals, busy):
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, s, e, kind):
            self.s, self.e, self.kind = s, e, kind

        def device_type(self):
            return self.kind

        def start_ns(self):
            return self.s

        def end_ns(self):
            return self.e

    evs = [Ev(s, e, DeviceType.CUDA) for s, e in intervals]
    evs.append(Ev(0, 10**6, DeviceType.CPU))  # a host event never counts
    prof = type("P", (), {})()
    prof.profiler = type("A", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: evs})()
    assert harness.device_busy(prof) == pytest.approx(busy, abs=1e-15)


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, (path, tops)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'portbench/tests');"
            "import _small; ctx, d = _small.har(); d.run(ctx);"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            f" & {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELLS[0], "--seed", "5000000000", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 3 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("fault", ["halfbatch", "unchanged"])
def test_a_training_fault_is_not_correct(fault):
    ctx, runner = har(plant=getattr(calibrate, {"halfbatch": "halve"}.get(
        fault, fault)))
    res = runner.run(ctx)
    checks = harness.checks(res["readings"], limits(CELLS[0]))
    assert not all(c["ok"] for c in checks.values()), checks


@pytest.mark.parametrize("fault", ["alter_tokens", "stale_cache"])
def test_a_serving_fault_is_not_correct(fault):
    ctx, runner = lm(plant=getattr(calibrate, fault))
    res = runner.run(ctx)
    checks = harness.checks(res["readings"], limits(CELLS[1]))
    assert not all(c["ok"] for c in checks.values()), checks
