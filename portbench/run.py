"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name through
``BENCHMARK.json`` at the root of the checkout: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``kind`` names the general runner in
``runners/``), ``limits/<workload>.json`` (the limit of each number that
decides ``correct``) and, with ``--trace 1``, one reader per per-layer
metric, ``metrics/<metric>.py``. It measures the PyTorch port
(``src/repro_torch``) on CUDA cards and nothing else: without a card, or
with fewer than the cell asks for, it exits 3 and prints no result; if the
JAX package or JAX itself is loaded once the window has closed, it exits 4.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        _fail(2, f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail(2, f"the program (src/repro_torch) is not in {ROOT}")
    # every cache the program or a library keeps lives in the checkout
    cache = HERE / "out" / "cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(HERE), str(ROOT / "src")]

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        _fail(3, f"{args.workload} needs {cell['chips']} CUDA card(s); "
                 f"{torch.cuda.device_count()} available")

    import harness

    ctx = types.SimpleNamespace(
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        t0=T0, device=torch.device("cuda", 0), chips=cell["chips"],
        config=harness.read_json(ROOT / config["file"]),
        traffic=harness.read_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        plant=None)
    limits = harness.read_json(HERE / "limits" / f"{args.workload}.json")
    runner = harness.load_module(
        HERE / "runners" / f"{ctx.traffic['kind']}.py",
        f"portbench_runner_{ctx.traffic['kind']}")
    line = result_line(bench, cell, ctx, runner.run(ctx), limits)

    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        _fail(4, f"the run loaded {', '.join(found)}: the benchmark "
                 "measures the PyTorch port alone")
    for name, c in line["checks"].items():
        harness.say(f"check {name} = {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


def result_line(bench: dict, cell: dict, ctx, res: dict, limits: dict
                ) -> dict:
    import harness

    metrics = {}
    wanted = cell_metrics(bench, cell["name"], ctx.trace)
    if ctx.trace:
        sys.path.insert(0, str(HERE / "metrics"))
        for m in wanted:
            reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py",
                                         "portbench_metric_"
                                         + m["name"].replace(".", "_"))
            v = reader.read(res["obs"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in wanted:
            metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                  "unit": m["unit"]}
    checks = harness.checks(res["readings"], limits)
    device = harness.device_line(cell["chips"], res["peak"])
    line = {"correct": all(c["ok"] for c in checks.values()),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    prof = res["obs"].get("profile")
    if ctx.trace and prof:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


if __name__ == "__main__":
    sys.exit(main())
