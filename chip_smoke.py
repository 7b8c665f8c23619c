#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing its lines before the last:
  1. card     name and power limit (nvidia-smi), TF32 switched off
  2. build    every CUDA source of the path, one nvcc each, all at once;
              build time and ptxas register/smem lines
  3. kernels  each kernel vs its plain version (ref.py) at the path shape,
              ragged shapes, an empty cohort and fleet scale; max abs error,
              CUDA-event time per call, the byte/flop bound
  4. main     the asynchronous RELIEF runtime (AsyncFedRun) on full-width
              PAMAP2 Backbone 1, paper fleet (3,3,2), 100x compute gap,
              K=4, a=0.5, through the entry point's ``build``: one cold-start
              flush, then a few flushes with the fp32 uplink and a few with
              int8, with launch counts zeroed just before those and read
              just after, and host time split into dispatch and flush
  5. check    a small run on the card (kernels) against the same run on the
              CPU (plain versions), both uplinks
Then one JSON line of per-kernel numbers, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero,
and without a card, or without the repository's ``src/`` beside it, the
script exits nonzero before printing a result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM: device memory rate and fp32 (non-tensor-core) peak, from NVIDIA's
# data sheet; both kernels do fp32 arithmetic on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Tolerance per output element: |kernel - plain| <= ATOL + RTOL*|plain| +
# SUM_RTOL*S, where S is the same reduction over absolute values. Both sides
# are fp32 sums over N clients taken in different orders; their difference
# scales with S (at fleet scale an element whose sum cancels to ~0 still
# carries ~1e-7*S of rounding from either side), while a dropped or doubled
# client moves the result by one term, well above SUM_RTOL*S for N < 10^5.
ATOL = RTOL = 1e-4
SUM_RTOL = 1e-5

KERNELS = {
    "cohort_agg_divergence": dict(
        replaces="src/repro/kernels/cohort_agg/kernel.py:72"),
    "cohort_agg_divergence_quant": dict(
        replaces="src/repro/kernels/cohort_agg/kernel.py:130"),
}
PATH_SHAPE = (4, 112, 128)  # K=4 buffered clients x fusion_w0 [112, 128]
CASES = [("path", PATH_SHAPE, False), ("ragged", (9, 100, 1), False),
         ("ragged", (16, 96, 8), False), ("empty", PATH_SHAPE, True),
         ("fleet", (16384, 1024, 4), False)]


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# -- phase 1 ----------------------------------------------------------------


def card(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(smi)
    say(f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | TF32 off (cudnn and matmul)")
    return smi


# -- phase 2 ----------------------------------------------------------------


def build_kernels(runtime, sources) -> None:
    t0 = time.perf_counter()
    builds = runtime.build(sources)
    say(f"[build] {len(builds)} source(s) in {time.perf_counter() - t0:.1f}s "
        "wall (one nvcc each, started together)")
    for b in builds.values():
        say(f"[build] {b.source.relative_to(ROOT)}: "
            + (f"{b.seconds:.1f}s" if b.seconds else "already built"))
        for line in b.log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                say(f"[build]   {line.strip()}")


# -- phase 3 ----------------------------------------------------------------


def _events(torch, run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_ms(torch, fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """-> (device ms, call ms) per call. Device: ``iters`` calls captured in
    one CUDA graph and replayed, so host launch cost drops out. Call: CUDA
    events around ``iters`` eager calls, host enqueue included (what a
    caller pays when the host, not the card, is the bottleneck)."""
    side = torch.cuda.Stream()  # warm up off the capture stream, as
    side.wait_stream(torch.cuda.current_stream())  # graph capture wants
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    call = _events(torch, lambda: [fn() for _ in range(iters)]) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _events(torch, graph.replay) / iters
    del graph
    return device, call


def bound(kernel: str, N: int, D: int, r: int) -> tuple[float, str]:
    """Least time (ms) for the work: each input read once, each output
    written once, over the memory rate; flops over the fp32 peak."""
    out_bytes = 8 * D * (r + 1)  # agg, mean [D, r] + sq, cnt [D], fp32
    if kernel == "cohort_agg_divergence":
        nbytes = 4 * N * D * r + 8 * N * D + out_bytes
        flops = 7 * N * D * r + N * D
    else:  # int8 codes + per-client scale and staleness
        nbytes = N * D * r + 8 * N * D + 8 * N + out_bytes
        flops = 9 * N * D * r + N * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, ops, ref) -> dict:
    results = {k: {} for k in KERNELS}
    for label, (N, D, r), empty in CASES:
        g = torch.Generator(device="cuda").manual_seed(N * 7 + D * 3 + r)
        kw = dict(device="cuda", generator=g)
        x = torch.randn((N, D, r), **kw)
        W = torch.rand((N, D), **kw) * (torch.rand((N, D), **kw) < 0.7)
        C = (torch.rand((N, D), **kw) < 0.6).float()
        if empty:
            W.zero_()
            C.zero_()
        q = torch.randint(-127, 128, (N, D, r), dtype=torch.int8, **kw)
        s = torch.rand((N,), **kw) * 0.1 + 1e-3
        st = torch.randint(0, 6, (N,), **kw).float()
        exps = [0.5, 0.0] if label == "path" else [0.5]
        calls = {"cohort_agg_divergence": [(
            "", lambda: ops.cohort_agg_divergence(x, W, C),
            lambda: ref.cohort_agg_divergence_ref(x, W, C),
            lambda: ref.cohort_agg_divergence_ref(x.abs(), W, C))]}
        calls["cohort_agg_divergence_quant"] = [(
            f" a={a}",
            lambda a=a: ops.cohort_agg_divergence_quant(q, s, W, C, st, a),
            lambda a=a: ref.cohort_agg_divergence_quant_ref(q, s, W, C, st, a),
            lambda a=a: ref.cohort_agg_divergence_quant_ref(q.abs(), s, W, C,
                                                            st, a))
            for a in exps]
        for name, variants in calls.items():
            for tag, kern, plain, abs_sum in variants:
                got, want, scale = kern(), plain(), abs_sum()
                torch.cuda.synchronize()
                errs = []
                for o, a, b, S in zip(("agg", "sq", "mean", "cnt"), got, want,
                                      scale):
                    if not torch.isfinite(a).all():
                        fail(f"{name} {label} {o}: non-finite output")
                    err = (a - b).abs()
                    if (err > ATOL + RTOL * b.abs() + SUM_RTOL * S).any():
                        fail(f"{name} {label} {(N, D, r)} {o}: max abs err "
                             f"{err.max().item():.3e} exceeds {ATOL} + "
                             f"{RTOL}*|plain| + {SUM_RTOL}*sum|terms|")
                    errs.append((o, err.max().item()))
                iters = 20 if label == "fleet" else 200
                ms, call_ms = time_ms(torch, kern, iters)
                plain_ms, plain_call = time_ms(torch, plain,
                                               5 if label == "fleet" else iters)
                b_ms, by = bound(name, N, D, r)
                say(f"[kernel] {name}{tag} {label} N,D,r={N},{D},{r} "
                    f"splits {ops.split_count(N, D, r, x.device)}: "
                    + " ".join(f"{o} {e:.2e}" for o, e in errs)
                    + f" | device {ms * 1e3:.2f} us/call (plain "
                    f"{plain_ms * 1e3:.2f} us), bound {b_ms * 1e3:.3f} us "
                    f"({by}) = {b_ms / ms:.1%} of device time | eager call "
                    f"{call_ms * 1e3:.2f} us (plain {plain_call * 1e3:.2f} us)")
                if label == "path" and not tag.endswith("0.0"):
                    results[name] = dict(
                        max_abs_err=max(e for _, e in errs), ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
    return results


# -- phase 4 ----------------------------------------------------------------


def _time_phases(torch, run) -> dict:
    """Wrap the run's client dispatch (local training of the dispatched
    clients) and server flush (aggregation) with synchronized host timers."""
    spent = {"_dispatch": [0.0, 0, 0], "_flush": [0.0, 0, 0]}  # s, calls,
    # clients dispatched
    for name in spent:
        inner = getattr(run, name)

        def wrapped(*args, _inner=inner, _acc=spent[name], **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _acc[2] += len(args[0]) if args else 0
            out = _inner(*args, **kw)
            torch.cuda.synchronize()
            _acc[0] += time.perf_counter() - t
            _acc[1] += 1
            return out

        setattr(run, name, wrapped)
    return spent


def main_path(torch, ops, train_async_har, updates: int) -> dict:
    # cold start first (cuDNN algorithm choice, first vmap traces), outside
    # the counted window
    run, ds = train_async_har.build(codec="none", device="cuda")
    t0 = time.perf_counter()
    run.run(ds, total_updates=4)
    torch.cuda.synchronize()
    say(f"[main] cold start: first flush {time.perf_counter() - t0:.2f}s "
        "host wall")
    ops.reset_launches()
    flushes = {}
    for codec in ("none", "int8"):
        run, ds = train_async_har.build(codec=codec, device="cuda")
        spent = _time_phases(torch, run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = run.run(ds, total_updates=updates)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (d_s, d_n, d_k), (f_s, f_n, _) = spent["_dispatch"], spent["_flush"]
        say(f"[main] codec={codec} time: dispatch {d_s:.3f}s over {d_n} calls"
            f" / {d_k} clients ({d_s / max(d_k, 1) * 1e3:.1f} ms per client "
            f"update of 20 Adam steps), flush {f_s * 1e3:.1f} ms over {f_n} "
            f"flushes ({f_s / max(f_n, 1) * 1e3:.2f} ms each), rest "
            f"{wall - d_s - f_s:.3f}s (event loop + one macro-F1 eval)")
        losses = hist["loss"]
        if not all(math.isfinite(v) for v in losses):
            fail(f"main path codec={codec}: non-finite loss {losses}")
        if len(hist["f1"]) != 1 or not 0.0 <= hist["f1"][0] <= 1.0:
            fail(f"main path codec={codec}: bad macro-F1 {hist['f1']}")
        flushes[codec] = run.state.round
        say(f"[main] codec={codec}: {run.state.round} flushes, "
            f"{run.trace.completions} updates, simulated "
            f"{run.state.sim_time:.4f}s, host wall {wall:.2f}s (after "
            f"synchronize), losses {[round(v, 4) for v in losses]}, "
            f"macro-F1 {hist['f1'][0]:.4f}, "
            f"G={run.task.layout.G} groups, fusion_w0 "
            f"{tuple(run.state.trainable['base']['fusion_w0'].shape)}")
    launches = dict(ops.LAUNCHES)
    say(f"[main] kernel launches during the main path: {launches}")
    for name, codec in (("cohort_agg_divergence", "none"),
                        ("cohort_agg_divergence_quant", "int8")):
        if launches[name] < max(flushes[codec], 1):
            fail(f"{name} launched {launches[name]} times over "
                 f"{flushes[codec]} flushes")
    return launches


# -- phase 5 ----------------------------------------------------------------


def reference_check(torch) -> None:
    """One flush of a homogeneous fleet (K = N = 4, a = 0) at a small model:
    kernels on the card vs plain versions on the CPU, same seed."""
    from repro_torch.core import strategies
    from repro_torch.core.async_engine import AsyncFedConfig, AsyncFedRun
    from repro_torch.core.tasks import MMTask
    from repro_torch.data import make_har_dataset, mm_config_for
    from repro_torch.sim import make_fleet
    from repro_torch.tree import leaves_with_path

    ds = make_har_dataset("pamap2", windows_per_subject=60, seed=0)
    cfg = mm_config_for("pamap2", backbone="cnn", d_feat=8, d_fused=32,
                        cnn_ch=(8, 16))
    for codec in ("none", "int8"):
        out = {}
        for dev in ("cuda", "cpu"):
            task, tr0 = MMTask.create(cfg, torch.Generator().manual_seed(0),
                                      device=dev)
            run = AsyncFedRun.create(
                task, tr0,
                strategies.async_relief(buffer_size=4, staleness_exponent=0.0),
                make_fleet(4, 0, 0, M=4),
                AsyncFedConfig(rounds=1, local_epochs=1, steps_per_epoch=2,
                               batch_size=8, eval_every=100, seed=0,
                               uplink_codec=codec))
            hist = run.run(ds, total_updates=4)
            out[dev] = (hist["loss"], {k: v.cpu() for k, v in
                                       leaves_with_path(run.state.trainable)})
        (lc, tc), (lp, tp) = out["cuda"], out["cpu"]
        err = max((tc[k] - tp[k]).abs().max().item() for k in tp)
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        say(f"[check] codec={codec}: card vs CPU after one flush: trainable "
            f"max abs err {err:.2e} (atol 1e-4), loss rel err {rel:.2e} "
            f"(rtol 1e-4)")
        if err > 1e-4 or rel > 1e-4:
            fail(f"card run disagrees with the CPU run (codec={codec})")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    t_start = time.perf_counter()
    card(torch)
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cohort_agg import ops, ref
    from repro_torch.launch import train_async_har

    build_kernels(runtime, [ops.SOURCE])
    results = check_kernels(torch, ops, ref)
    launches = main_path(torch, ops, train_async_har, updates=12)
    reference_check(torch)
    lines = []
    for name, meta in KERNELS.items():
        lines.append(dict(
            name=name, route="cuda", source=str(ops.SOURCE.relative_to(ROOT)),
            replaces=meta["replaces"], launches=launches[name],
            library_ms=None, **results[name]))
    say(f"[chip_smoke] all phases passed in "
        f"{time.perf_counter() - t_start:.1f}s")
    say(json.dumps({"kernels": lines}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
