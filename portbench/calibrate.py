"""Readings that set the limits of ``correct``, at a cell's own size, over
many seeds in one process: the program's (``program``), the control's
(``control``: the plain reference one precision below the configuration's,
put in the program's place; ``witness``: the fp32 reference against the
fp64 one, for how far rounding alone moves a number) and each fault's, planted in the program
(``halfbatch``: every local step on half of each batch, the mean over the
rest; ``unchanged``: a local update that returns its state unchanged;
``token``: every decoded token altered where it is produced;
``stale``: a decode step that leaves the KV cache as it found it).

    python3 portbench/calibrate.py --workload <name> --mode <mode> --seeds 1,2,3 [--seconds 20] [--rate R]

One JSON line per seed on standard output. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

import harness  # noqa: E402

MODES = ("program", "control", "witness", "halfbatch", "unchanged", "token",
         "stale")


def context(workload: str, seed: int, seconds: float, device) -> tuple:
    bench = harness.read_json(HERE.parent / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    ctx = types.SimpleNamespace(
        seed=seed, seconds=seconds, trace=False, t0=time.perf_counter(),
        device=device, chips=cell["chips"],
        config=harness.read_json(HERE.parent / config["file"]),
        traffic=harness.read_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        plant=None, control=False)
    kind = ctx.traffic["kind"]
    return ctx, harness.load_module(HERE / "runners" / f"{kind}.py",
                                    f"portbench_runner_{kind}")


def halve(run) -> None:
    """Fault: the local update sees half of each batch, the mean over it."""
    update = run.local_update

    def half(start, batches, *a, **kw):
        B = batches["x"].shape[2]
        return update(start, {k: v[:, :, :B // 2] for k, v in batches.items()},
                      *a, **kw)
    run.local_update = half


def unchanged(run) -> None:
    """Fault: the local update returns the state it started from."""
    from repro_torch.tree import tree_map
    update = run.local_update

    def same(start, *a, **kw):
        deltas, losses = update(start, *a, **kw)
        return tree_map(torch.zeros_like, deltas), losses
    run.local_update = same


def alter_tokens(engine) -> None:
    """Fault: every decoded token is the next id after the greedy one."""
    decode, vocab = engine._decode, engine.cfg.vocab
    engine._decode = lambda: (decode() + 1) % vocab


def stale_cache(engine) -> None:
    """Fault: a decode step returns the cache as it found it."""
    from repro_torch.tree import tree_map
    decode = engine._decode

    def stale():
        saved = tree_map(torch.clone, engine.caches)
        out = decode()
        engine.caches = saved
        return out
    engine._decode = stale


def readings(ctx, runner, mode: str) -> dict:
    if ctx.traffic["kind"] == "fed_round":
        if mode in ("control", "witness"):
            # control: TF32 against fp32; witness: fp32 against fp64
            hi, lo = (("fp32", "tf32") if mode == "control"
                      else ("fp64", "fp32"))
            _, data, params, settings = runner.build(ctx)
            recs = runner.reference(ctx, params, data, settings, hi)
            low = runner.reference(ctx, params, data, settings, lo)
            return runner.readings_of(settings[0], params,
                                      runner.produced_by(low, settings[0]),
                                      recs)
        ctx.plant = {"halfbatch": halve, "unchanged": unchanged}.get(mode)
        run, data, params, settings, got = runner.drive(ctx)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        return runner.readings_of(settings[0], params, got,
                                  runner.reference(ctx, params, data,
                                                   settings))
    ctx.plant = {"token": alter_tokens, "stale": stale_cache}.get(mode)
    ctx.control = mode == "control"
    res = runner.run(ctx)
    return dict(res["readings"], attempted=res["attempted"],
                engine_tok_s=res["e2e"]["engine_tok_s"],
                arrived=res["obs"]["arrived"], backlog=res["obs"]["backlog"])


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
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    harness.say(harness.power_limit())
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx, runner = context(args.workload, seed, args.seconds, dev)
        if args.rate is not None:
            ctx.traffic["arrival"]["rate_per_s"] = args.rate
        t0 = time.perf_counter()
        r = readings(ctx, runner, args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "s": time.perf_counter() - t0,
                          "readings": r}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
