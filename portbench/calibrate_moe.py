"""Readings that set the limits of ``correct`` in an MoE serving cell:
``calibrate.py``'s modes (``program``, ``control``, ``token``, ``stale``)
and three faults of the expert layer planted in the program: ``drops``
(today's "sparse" path at capacity factor 1.0, which drops the assignments
past an expert's capacity in a prefill), ``top1`` (every token to its one
best expert) and ``unnormalised`` (the top-2 gates left as the softmax gave
them, not renormalised to sum to 1).

    python3 portbench/calibrate_moe.py --workload <name> --mode <mode> --seeds 1,2,3 [--seconds 20] [--rate R]

One JSON line per seed on standard output. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

import harness  # noqa: E402

calibrate = harness.load_module(HERE / "calibrate.py", "portbench_calibrate")
MODES = ("program", "control", "token", "stale", "drops", "top1",
         "unnormalised")


def plant_drops() -> None:
    """Fault: the expert layer drops past a capacity of 1.0 x the mean."""
    from repro_torch.models import moe

    def sparse(p, x, top_k, activation):
        cap = moe.capacity(x.shape[1], top_k, p["wi"].shape[0], 1.0)
        return moe._sparse(p, x, top_k, cap, activation)
    moe._dropless = sparse


def plant_unnormalised() -> None:
    """Fault: the top-k gates are the softmax's, not renormalised."""
    from repro_torch.models import moe
    route = moe.route

    def raw(p, x, top_k):
        probs, _, ids = route(p, x, top_k)
        return probs, probs.gather(-1, ids), ids
    moe.route = raw


def top1(engine) -> None:
    """Fault: the engine routes every token to its one best expert."""
    engine.cfg = dataclasses.replace(engine.cfg, top_k=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rate", type=float, default=None,
                    help="arrivals per second in place of the traffic's "
                         "(the sweep that finds what the engine sustains)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_moe: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    harness.say(harness.power_limit())
    {"drops": plant_drops, "unnormalised": plant_unnormalised}.get(
        args.mode, lambda: None)()
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx, runner = calibrate.context(args.workload, seed, args.seconds,
                                        dev)
        if args.rate is not None:
            ctx.traffic["arrival"]["rate_per_s"] = args.rate
        t0 = time.perf_counter()
        if args.mode == "top1":
            ctx.plant = top1
            res = runner.run(ctx)
            r = dict(res["readings"], attempted=res["attempted"],
                     engine_tok_s=res["e2e"]["engine_tok_s"],
                     arrived=res["obs"]["arrived"],
                     backlog=res["obs"]["backlog"])
        else:
            r = calibrate.readings(ctx, runner, {
                "drops": "program", "unnormalised": "program"}.get(
                    args.mode, args.mode))
        r["peak"] = torch.cuda.max_memory_allocated(dev)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "s": time.perf_counter() - t0,
                          "readings": r}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
