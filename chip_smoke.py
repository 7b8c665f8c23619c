#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing its lines (and its wall time) before the last:
  1. card     name and power limit (nvidia-smi), TF32 switched off
  2. build    every CUDA source of the paths, one nvcc each, all at once;
              build time and ptxas register/smem lines
  3. kernels  each cohort-agg kernel vs its plain version (ref.py) at the
              path shape, ragged shapes, an empty cohort and fleet scale;
              max abs error, CUDA-event time per call, the byte/flop bound
  4. main     the asynchronous RELIEF runtime (AsyncFedRun) on full-width
              PAMAP2 Backbone 1, paper fleet (3,3,2), 100x compute gap,
              K=4, a=0.5, through the entry point's ``build``: one cold-start
              flush, then a few flushes with the fp32 uplink and a few with
              int8, with launch counts zeroed just before those and read
              just after, and host time split into dispatch and flush
  5. check    a small run on the card (kernels) against the same run on the
              CPU (plain versions), both uplinks
  6. serve kernels  flash attention and the gathered multi-LoRA projection
              vs their plain versions at the serving path's shapes
              (phi3-medium-14b decode and prefill, the wq/wv/wo
              projections), plus window/softcap and ragged cases and a
              bitwise batch-invariance check; error, device time (CUDA
              graph), eager call time, plain time, bound, library time
  7. serve    ``serve.run_batched`` on phi3-medium-14b FULL (40 layers,
              bf16, random weights drawn on the card): B=8, P=512, 32
              decode steps, flash attention; launch counts zeroed just
              before and read just after
  8. engine   ``serve.run_engine`` on the same weights: 16 adapters with
              modality masks, 16 slots, 32 requests with prompts of 64-256
              tokens and 32 new tokens each; gathered projection launches
              counted the same way (``python -m
              repro_torch.launch.profile_serve`` profiles a few decode
              steps of each mode: busy time, idle share, launches)
  9. serve check  a float32 phi3-shaped model of 2 layers: engine tokens on
              the card equal the CPU's and the card's per-request baseline;
              batched-serve logits and tokens on the card equal the CPU's
Then one JSON line of per-kernel numbers, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero,
and without a card, or without the repository's ``src/`` beside it, the
script exits nonzero before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM, NVIDIA's data sheet: device memory rate, fp32 (non-tensor-core)
# peak and dense bf16 tensor-core peak. A bound takes the peak of the
# inputs' type: bf16 work could run on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# Tolerance per output element: |kernel - plain| <= ATOL + RTOL*|plain| +
# SUM_RTOL*S, where S is the same reduction over absolute values. Both sides
# are fp32 sums over N clients taken in different orders; their difference
# scales with S (at fleet scale an element whose sum cancels to ~0 still
# carries ~1e-7*S of rounding from either side), while a dropped or doubled
# client moves the result by one term, well above SUM_RTOL*S for N < 10^5.
ATOL = RTOL = 1e-4
SUM_RTOL = 1e-5

KERNELS = {
    "cohort_agg_divergence": "src/repro/kernels/cohort_agg/kernel.py:72",
    "cohort_agg_divergence_quant":
        "src/repro/kernels/cohort_agg/kernel.py:130",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:72",
    "mdlora_matmul_multi": "src/repro/kernels/mdlora/kernel.py:70",
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


# -- phase 6 ----------------------------------------------------------------

# decode at the batched path's mid-run occupancy: its 544-slot ring holds
# 513-544 filled slots over the 32 steps
FA_CASES = [  # label, B, S, T, K, G, hd, filled, window, softcap, bf16?
    ("decode", 8, 1, 544, 10, 4, 128, 528, None, None, True),
    ("prefill", 8, 512, 544, 10, 4, 128, 512, None, None, True),
    ("decode fp32", 8, 1, 544, 10, 4, 128, 528, None, None, False),
    ("prefill fp32", 8, 512, 544, 10, 4, 128, 512, None, None, False),
    ("window+softcap", 2, 256, 300, 4, 2, 128, 300, 64, 50.0, True),
    ("ragged T", 2, 37, 97, 3, 3, 64, 90, None, None, False),
]
# |kernel - plain| <= atol + rtol*|plain|, the plain version computed in
# fp32 on the same input values. Both accumulate in fp32; a bf16 output
# rounds once, by at most 2^-9 of its value. Outputs range from ~0.05 (decode:
# a softmax-weighted mean of ~500 random v rows) to ~4 (early prefill rows see
# a few keys), so the bound is relative, with an atol for the smallest
FA_TOL = {True: (4e-3, 2**-8), False: (2e-5, 0.0)}  # by bf16?
MD_CASES = [  # label, B, D, F, A, r, masked, bf16?
    ("wq", 16, 5120, 5120, 16, 8, False, True),
    ("wv", 16, 5120, 1280, 16, 8, False, True),
    ("wo", 16, 5120, 5120, 16, 8, True, True),
    ("wo fp32", 16, 5120, 5120, 16, 8, True, False),
]
MD_TOL_FP32 = (1e-4, 1e-4)
MD_TOL_BF16 = (2e-2, 1e-2)  # against the plain version's bf16 output
FUSION_BLOCK = 512  # phi3: G * head_dim = 4 * 128 columns per KV group


L2_BYTES = 50e6  # H100 L2 cache


def _rotating(sets: list, fn):
    """A call of ``fn`` on the next input set in turn. Timed calls cycle
    through copies that together exceed the L2 twice, so each call finds
    its inputs in device memory, as a layer of the real path does."""
    turn = [0]

    def call():
        i = turn[0]
        turn[0] = (i + 1) % len(sets)
        return fn(*sets[i])
    return call


def _copies(torch, tensors) -> list:
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    n = max(1, math.ceil(2 * L2_BYTES / nbytes))
    return [tuple(tensors)] + [
        tuple(None if t is None else t.clone() for t in tensors)
        for _ in range(n - 1)]


def _flops_peak(torch, t) -> float:
    return BF16_FLOPS_PER_S if t.dtype == torch.bfloat16 else FP32_FLOPS_PER_S


def _bound(nbytes: int, flops: int, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fa_inputs(torch, B, S, T, K, G, hd, filled, bf16, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = dict(device="cuda", generator=g)
    q = torch.randn((B, S, K, G, hd), **kw).to(dt)
    k = torch.randn((B, T, K, hd), **kw).to(dt)
    v = torch.randn((B, T, K, hd), **kw).to(dt)
    ar = torch.arange(T, device="cuda", dtype=torch.int32)
    kp = torch.where(ar < filled, ar, -1)  # a ring: filled slots, then -1
    kp = kp[torch.randperm(T, device="cuda", generator=g)]
    qp = torch.arange(filled - S, filled, device="cuda", dtype=torch.int32)
    return q, k, v, qp, kp


def check_flash(torch, fa_ops, fa_ref) -> dict:
    import torch.nn.functional as F

    out = {}
    for (label, B, S, T, K, G, hd, filled, window, cap, bf16) in FA_CASES:
        q, k, v, qp, kp = _fa_inputs(torch, B, S, T, K, G, hd, filled, bf16,
                                     B + S + T)
        sets = _copies(torch, (q, k, v))
        kern = _rotating(sets, lambda q, k, v: fa_ops.flash_attention(
            q, k, v, qp, kp, window, cap))
        plain = _rotating(sets, lambda q, k, v: fa_ref.flash_attention_ref(
            q, k, v, qp, kp, window, cap))
        got = fa_ops.flash_attention(q, k, v, qp, kp, window, cap)
        want = fa_ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                          qp, kp, window, cap)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"flash_attention {label}: non-finite output")
        diff = (got.float() - want).abs()
        err = diff.max().item()
        atol, rtol = FA_TOL[bf16]
        if (diff > atol + rtol * want.abs()).any():
            fail(f"flash_attention {label}: max abs err {err:.3e} exceeds "
                 f"{atol} + {rtol}*|plain|")
        iters = 200 if S == 1 else 20
        ms, call_ms = time_ms(torch, kern, iters)
        plain_ms, _ = time_ms(torch, plain, 5)
        mask = fa_ref.attention_mask(qp, kp, window)
        pairs = int(mask.sum().item()) * B * K * G
        seen = int(mask.any(0).sum().item())  # slots some query row can see
        nbytes = (2 * q.numel() + 2 * B * seen * K * hd) * q.element_size() \
            + 4 * (S + T)
        b_ms, by = _bound(nbytes, 4 * hd * pairs, _flops_peak(torch, q))
        lib_ms = None
        if cap is None:  # SDPA has no softcap: timed on the other cases
            heads = [(q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, hd),
                      k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous()) for q, k, v in sets]
            lib = _rotating(heads, lambda q, k, v:
                            F.scaled_dot_product_attention(
                                q, k, v, attn_mask=mask, enable_gqa=True))
            lib_ms, _ = time_ms(torch, lib, iters)
            del heads
        say(f"[flash] {label} B={B} S={S} T={T} K={K} G={G} hd={hd} "
            f"{'bf16' if bf16 else 'fp32'}: max abs err {err:.2e} (atol "
            f"{atol} + {rtol:.4g}*|plain fp32|) | device {ms * 1e3:.2f} us/call (graph), eager call "
            f"{call_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"library (SDPA) "
            + ("n/a" if lib_ms is None else f"{lib_ms * 1e3:.2f} us")
            + f" | bound {b_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB "
            f"with K/V of the {seen} visible slots, "
            f"{4 * hd * pairs / 1e9:.2f} GFLOP) = {b_ms / ms:.1%}")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=by, library_ms=lib_ms)
        del sets, kern, plain
    return out


def _md_inputs(torch, md_ops, B, D, F, A, r, masked, bf16, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    dt = torch.bfloat16 if bf16 else torch.float32
    x = torch.randn((B, D), **kw).to(dt)
    w0 = (torch.randn((D, F), **kw) / math.sqrt(D)).to(dt)
    a = torch.randn((A, D, r), **kw) / math.sqrt(D)
    b = torch.randn((A, r, F), **kw) * 0.05
    idx = torch.randint(0, A, (B,), device="cuda", generator=g,
                        dtype=torch.int32)
    mask = None
    if masked:
        mm = (torch.rand((B, D // FUSION_BLOCK), **kw) < 0.8).float()
        mm[:, 0] = 1.0
        mask = md_ops.block_row_masks([FUSION_BLOCK] * (D // FUSION_BLOCK),
                                      mm).contiguous()
    return x, w0, a, b, idx, mask


def check_mdlora(torch, md_ops, md_ref) -> dict:
    out = {}
    for label, B, D, F, A, r, masked, bf16 in MD_CASES:
        x, w0, a, b, idx, mask = _md_inputs(torch, md_ops, B, D, F, A, r,
                                            masked, bf16, D + F)
        sets = _copies(torch, (x, w0, a, b, mask))
        kern = _rotating(sets, lambda x, w0, a, b, mask:
                         md_ops.mdlora_matmul_multi(x, w0, a, b, idx, mask,
                                                    2.0))
        plain = _rotating(sets, lambda x, w0, a, b, mask:
                          md_ref.mdlora_matmul_multi_ref(x, w0, a, b, idx,
                                                         mask, 2.0))
        got = md_ops.mdlora_matmul_multi(x, w0, a, b, idx, mask, 2.0)
        want = md_ref.mdlora_matmul_multi_ref(x, w0, a, b, idx, mask, 2.0)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        atol, rtol = MD_TOL_BF16 if bf16 else MD_TOL_FP32
        if not torch.isfinite(got).all() or (
                err > atol + rtol * want.float().abs()).any():
            fail(f"mdlora_matmul_multi {label}: max abs err "
                 f"{err.max().item():.3e} exceeds {atol} + {rtol}*|plain|")
        ms, call_ms = time_ms(torch, kern, 200)
        plain_ms, _ = time_ms(torch, plain, 20)
        used = int(idx.unique().numel())  # adapters this batch reads
        es = x.element_size()
        nbytes = (B * D + D * F + B * F) * es + 4 * used * r * (D + F) \
            + 4 * B + (4 * B * D if masked else 0)
        flops = 2 * B * D * F + 2 * B * r * (D + F) + (B * D if masked else 0)
        b_ms, by = _bound(nbytes, flops, _flops_peak(torch, x))
        say(f"[mdlora] {label} B={B} D={D} F={F} A={A} ({used} used) r={r} "
            f"{'masked' if masked else 'no mask'} "
            f"{'bf16' if bf16 else 'fp32'}: max abs err "
            f"{err.max().item():.2e} | device {ms * 1e3:.2f} us/call "
            f"(graph), eager call {call_ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, library n/a | bound "
            f"{b_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB) = "
            f"{b_ms / ms:.1%}")
        out[label] = dict(max_abs_err=err.max().item(), ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                          library_ms=None)
        if label == "wo":  # bitwise batch invariance
            for i in (0, 5, B - 1):
                one = md_ops.mdlora_matmul_multi(
                    x[i:i + 1], w0, a, b, idx[i:i + 1], mask[i:i + 1], 2.0)
                if not torch.equal(one[0], got[i]):
                    fail(f"mdlora_matmul_multi: row {i} alone differs from "
                         "the same row in the batch")
            perm = torch.randperm(B, device="cuda")
            yp = md_ops.mdlora_matmul_multi(
                x[perm].contiguous(), w0, a, b, idx[perm].contiguous(),
                mask[perm].contiguous(), 2.0)
            if not torch.equal(yp, got[perm]):
                fail("mdlora_matmul_multi: a permuted batch does not give "
                     "the permuted rows bitwise")
            say("[mdlora] batch invariance: rows 0, 5, 15 alone and a "
                "permuted batch equal the batch's rows bitwise")
        del sets, kern, plain
    return out


# -- phases 7-8 -------------------------------------------------------------

SERVE = dict(batch=8, prompt_len=512, decode_steps=32)
ENGINE = dict(n_adapters=16, batch=16, n_requests=32, prompt_len=256,
              min_prompt_len=64, decode_steps=32)


def _launch_counts(fa_ops, md_ops) -> tuple[int, int]:
    return (fa_ops.LAUNCHES["flash_attention"],
            md_ops.LAUNCHES["mdlora_matmul_multi"])


def _reset(fa_ops, md_ops) -> None:
    fa_ops.reset_launches()
    md_ops.reset_launches()


def serve_batched(torch, serve, fa_ops, md_ops, cfg, params) -> int:
    # cold start (cuBLAS handles, allocator growth) outside the window
    serve.run_batched(cfg, params, batch=SERVE["batch"],
                      prompt_len=SERVE["prompt_len"], decode_steps=2,
                      device="cuda")
    _reset(fa_ops, md_ops)
    res = serve.run_batched(cfg, params, device="cuda", **SERVE)
    fa, md = _launch_counts(fa_ops, md_ops)
    want = cfg.n_layers * (1 + SERVE["decode_steps"])
    say(f"[serve] kernel launches: flash_attention {fa} (expected {want} = "
        f"{cfg.n_layers} layers x (1 prefill + {SERVE['decode_steps']} "
        f"decode steps)), mdlora_matmul_multi {md} (expected 0)")
    if fa != want or md != 0:
        fail("batched serve did not launch the kernels as its path requires")
    if not torch.isfinite(res["prefill_logits"]).all():
        fail("batched serve: non-finite logits")
    B, P, n = SERVE["batch"], SERVE["prompt_len"], SERVE["decode_steps"]
    say(f"[serve] {cfg.arch} FULL ({cfg.n_layers} layers, {cfg.dtype}) "
        f"B={B} P={P}: prefill {res['prefill_s'] * 1e3:.1f} ms "
        f"({B * P / res['prefill_s']:.0f} prompt tok/s); decode {n} steps "
        f"in {res['decode_s']:.3f} s = {res['decode_ms_per_step']:.2f} ms "
        f"per step, {res['tok_s']:.1f} tok/s; tokens in [0, {cfg.vocab}), "
        f"logits finite; sample {res['tokens'][0, :8].tolist()}")
    return fa


def serve_engine(torch, serve, fa_ops, md_ops, cfg, params) -> int:
    serve.run_engine(cfg, params, n_adapters=2, batch=2, n_requests=2,
                     prompt_len=64, decode_steps=2, device="cuda")
    _reset(fa_ops, md_ops)
    res = serve.run_engine(cfg, params, device="cuda", **ENGINE)
    fa, md = _launch_counts(fa_ops, md_ops)
    steps = len(res["decode_step_times"])
    want = 3 * cfg.n_layers * steps
    say(f"[engine] kernel launches: mdlora_matmul_multi {md} (expected "
        f"{want} = wq, wv, wo x {cfg.n_layers} layers x {steps} decode "
        f"steps), flash_attention {fa} (expected 0: per-row positions take "
        "the plain attention)")
    if md != want or fa != 0:
        fail("the engine did not launch the kernels as its path requires")
    st = sorted(res["decode_step_times"])
    n_req = ENGINE["n_requests"]
    if len(res["outputs"]) != n_req or res["generated_tokens"] != \
            n_req * ENGINE["decode_steps"]:
        fail(f"engine served {len(res['outputs'])} requests, "
             f"{res['generated_tokens']} tokens")
    if not all(0 <= t < cfg.vocab for v in res["outputs"].values()
               for t in v):
        fail("engine: token ids outside the vocab")
    say(f"[engine] {cfg.arch} FULL: {n_req} requests ({ENGINE['n_adapters']}"
        f" adapters, {ENGINE['batch']} slots, prompts "
        f"{ENGINE['min_prompt_len']}-{ENGINE['prompt_len']} tokens, "
        f"{ENGINE['decode_steps']} new tokens each): {res['generated_tokens']}"
        f" tokens in {res['wall_s']:.2f} s = {res['tok_s']:.1f} tok/s; "
        f"latency p50 {res['latency_p50_s']:.3f} s, p99 "
        f"{res['latency_p99_s']:.3f} s; {steps} decode steps, p50 "
        f"{st[len(st) // 2] * 1e3:.2f} ms, max {st[-1] * 1e3:.2f} ms; "
        f"{res['n_steps']} engine steps")
    return md


# -- phase 9 ----------------------------------------------------------------

CHECK_ATOL = 1e-4  # fp32 logits, sums in another order over 2 layers


def serve_check(torch, serve, serving_engine, api, fa_ops, md_ops, tree_map,
                full) -> None:
    cfg = dataclasses.replace(
        full, arch="phi3-medium-14b-check", n_layers=2, d_model=512,
        n_heads=8, n_kv_heads=2, head_dim=64, d_ff=1792, vocab=2048,
        dtype="float32", param_dtype="float32", attn_impl="pallas")
    cpu = api.init_model(torch.Generator().manual_seed(3), cfg, "cpu")
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    kw = dict(n_adapters=4, batch=4, n_requests=10, prompt_len=40,
              min_prompt_len=8, decode_steps=8, seed=1)
    _reset(fa_ops, md_ops)
    eg = serve.run_engine(cfg, gpu, device="cuda", **kw)
    ec = serve.run_engine(cfg, cpu, device="cpu", **kw)
    naive = serving_engine.naive_serve(gpu, cfg, eg["registry"],
                                       eg["requests"], eg["max_len"])
    bkw = dict(batch=4, prompt_len=40, decode_steps=8, seed=1)
    bg = serve.run_batched(cfg, gpu, device="cuda", **bkw)
    bc = serve.run_batched(cfg, cpu, device="cpu", **bkw)
    fa, md = _launch_counts(fa_ops, md_ops)
    err = (bg["prefill_logits"] - bc["prefill_logits"]).abs().max().item()
    say(f"[check] fp32 phi3-shaped model (2 layers, d 512, 8 heads / 2 KV, "
        f"hd 64): engine tokens card == CPU: {eg['outputs'] == ec['outputs']}"
        f", card engine == card naive_serve: "
        f"{eg['outputs'] == naive['outputs']} ({len(eg['outputs'])} "
        f"requests, {eg['generated_tokens']} tokens); batched serve prefill "
        f"logits card vs CPU max abs err {err:.2e} (atol {CHECK_ATOL}), "
        f"tokens equal: {(bg['tokens'] == bc['tokens']).all()}; card "
        f"launches flash {fa}, mdlora {md}")
    if fa == 0 or md == 0:
        fail("serve check: the card runs did not go through the kernels")
    if eg["outputs"] != ec["outputs"] or eg["outputs"] != naive["outputs"]:
        fail("serve check: engine tokens differ (card vs CPU or vs naive)")
    if err > CHECK_ATOL or not (bg["tokens"] == bc["tokens"]).all():
        fail("serve check: batched serve on the card differs from the CPU")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    t_start = time.perf_counter()
    card(torch)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cohort_agg import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mdlora import ops as md_ops
    from repro_torch.kernels.mdlora import ref as md_ref
    from repro_torch.launch import serve, serving_engine, train_async_har
    from repro_torch.models import api
    from repro_torch.tree import tree_map

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        say(f"[time] phase {name}: {time.perf_counter() - t0:.1f}s wall")
        return out

    sources = {"cohort_agg_divergence": ops.SOURCE,
               "cohort_agg_divergence_quant": ops.SOURCE,
               "flash_attention": fa_ops.SOURCE,
               "mdlora_matmul_multi": md_ops.SOURCE}
    phase("build", build_kernels, runtime, sorted(set(sources.values())))
    results = phase("kernels", check_kernels, torch, ops, ref)
    launches = phase("main", main_path, torch, ops, train_async_har, 12)
    phase("check", reference_check, torch)
    fa_res = phase("serve kernels (flash)", check_flash, torch, fa_ops,
                   fa_ref)
    md_res = phase("serve kernels (mdlora)", check_mdlora, torch, md_ops,
                   md_ref)
    results["flash_attention"] = fa_res["decode"]
    results["mdlora_matmul_multi"] = md_res["wq"]
    full = dataclasses.replace(get_arch("phi3-medium-14b").FULL,
                               attn_impl="pallas")
    t0 = time.perf_counter()
    params = serve.init_params(full, 0, "cuda")
    torch.cuda.synchronize()
    say(f"[serve] {full.arch} FULL: {api.param_count(params) / 1e9:.2f} B "
        f"parameters, {torch.cuda.memory_allocated() / 1e9:.1f} GB on the "
        f"card, drawn in {time.perf_counter() - t0:.1f}s")
    launches["flash_attention"] = phase(
        "serve", serve_batched, torch, serve, fa_ops, md_ops, full, params)
    launches["mdlora_matmul_multi"] = phase(
        "engine", serve_engine, torch, serve, fa_ops, md_ops, full, params)
    del params
    torch.cuda.empty_cache()
    phase("serve check", serve_check, torch, serve, serving_engine, api,
          fa_ops, md_ops, tree_map, full)
    lines = []
    for name, replaces in KERNELS.items():
        lines.append(dict(
            name=name, route="cuda",
            source=str(sources[name].relative_to(ROOT)), replaces=replaces,
            launches=launches[name], **{"library_ms": None, **results[name]}))
    say(f"[chip_smoke] all phases passed in "
        f"{time.perf_counter() - t_start:.1f}s")
    say(json.dumps({"kernels": lines}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
