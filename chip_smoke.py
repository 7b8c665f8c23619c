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
              max abs error against the one-pass plain version and the
              split-order one (the kernel's order of sums), CUDA-event time
              per call, the byte/flop bound; each call's plan (rows per
              tile, lanes, splits) and launches per call (asserted 1 for
              both uplinks), counted by the profiler in a child process
              (``--launch-counts``, run right after the build, as for
              phases 6, 10 and 14); two fleet calls bitwise equal; and
              Backbone 2's fusion shapes (4, 112, 8) and (64, 112, 8)
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
              (phi3-medium-14b decode and prefill, hymba-1.5b's head layout
              and window, the wq/wv/wo projections), plus window/softcap
              and ragged cases and a bitwise batch-invariance check; each
              flash case names its path (bf16 prefill, bf16 split-KV decode
              and its chunk count, fp32); error, device time (CUDA graph),
              eager call time, plain time, bound, library time (SDPA for
              attention), and each bf16 flash instantiation's dynamic
              shared memory; the projection's kernel launches per call
              (the profiler, in a child process, for this and phase 10)
              and cuBLAS's base product x @ W0 alone
  7. serve    ``serve.run_batched`` on phi3-medium-14b FULL (40 layers,
              bf16, random weights drawn on the card): B=8, P=512, 32
              decode steps, flash attention (40 prefill and 1,280 decode
              calls of the op, asserted by path); launch counts zeroed just
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
 10. ssd kernel  the SSD chunked scan vs its plain version at the prefill
              step's shapes (mamba2-1.3b and hymba-1.5b heads, B=4, S=4096,
              bf16 and fp32) and an odd small shape, two calls bitwise
              equal, its path and launches per call, bf16 y's error beside
              y's own rounding; with an initial state; and vs the
              token-by-token recurrence
 11. mamba2   mamba2-1.3b FULL (48 layers, bf16, random weights drawn on the
              card): ``step_fns.make_prefill_step`` at B=4, S=4096 (one SSD
              launch per layer), then ``serve.run_batched`` at B=8, P=64, 32
              decode steps (token-loop prefill, O(1) decode; no kernel)
 12. hymba    hymba-1.5b FULL (32 layers): the same prefill step, then
              ``serve.run_engine`` with 16 adapters, fusion masks over the
              (attention, SSD) blocks, 8 slots, 16 requests of 8-32 prompt
              tokens and 16 new tokens each (the gathered projection on wq,
              wv and the fusion wo)
 13. recurrent check  mamba2 and hymba SMOKE in fp32: prefill-step logits on
              the card equal the CPU's; hymba engine tokens on the card equal
              the CPU's and the card's per-request baseline
 14. fused kernel  the fused block-LoRA projection (Backbone 2's fusion
              layer) vs its plain version at the training path's shape (8
              clients x 32 rows, 112 -> 128, r 8, the fleet's masks, W0
              shared), an evaluation batch, a ragged shape and 1024 clients;
              two calls bitwise equal, one launch per call (asserted); the
              autograd Function's vmap(grad) vs the plain expression's;
              error, device time, eager call time, plain time, bound and
              cuBLAS's base product alone. Each case names its path: fp32
              via 3xTF32 mma.sync, bf16 via mma.sync; the operations bound
              of an fp32 call counts its products three times over the TF32
              tensor-core peak (the fp32 peak of the CUDA cores no longer
              bounds it), beside the unchanged bytes
 15. sync     the synchronous RELIEF round (FedRun) on full-width PAMAP2
              Backbone 2, paper fleet (3,3,2), through
              ``train_relief_har.build``: three rounds of relief and three of
              fedavg, launch counts zeroed just before each and read just
              after (rounds x E x steps + the evaluation's batches); then
              a relief round of one local epoch (4 steps) under the
              profiler in a child process (``--profile-sync``; device busy
              time, idle share, launches, top kernels): in this one the
              profiler's hooks slowed every later host-bound phase
 16. sync check  one PAMAP2_B2_SMALL relief round on the card against the
              same round on the CPU, and PAMAP2_B2 FULL logits card vs CPU
 17. async b2  the asynchronous runtime (AsyncFedRun) on full-width PAMAP2
              Backbone 2 through ``train_async_har.build(backbone="b2")``:
              paper fleet, 100x gap, K=4, a=0.5, E=5 x 4 steps of batch 32;
              a cold-start flush, then 12 updates with the fp32 uplink and
              12 with int8; host wall split into dispatch and flush; the
              aggregation launches equal the flushes of each codec, the
              fused projection's equal dispatch calls x 20 steps + the
              evaluation's batches
 18. robust   the same runtime under faults (one sign-flipping attacker in
              the mag cohort, 10% dropout, 10% stalls): relief_trimmed,
              relief_median and relief_krum with 12 updates each (fp32) and
              relief_krum with int8 (dequantized first); one fp32
              aggregation launch per flush, dropped cycles
 19. fleet    (a) VectorizedAsyncFedRun in grad_mode "dispatch" against the
              heap runtime on the card, B2 FULL, paper fleet: equal flush
              histories; (b) grad_mode "cohort" at N = 10,000 (K=64, a ring
              of 8 snapshots, churn 0.01, arrivals 0.02, jitter 0.1), 4
              flushes per codec: host ms per flush, one aggregation launch
              per flush
 20. async check  PAMAP2_B2_SMALL, 2 flushes, on the card against the CPU
              from the same seed and weights: relief fp32, relief int8 and
              relief_krum under phase 18's faults
 21. scenarios  the scenario matrix (``sim.make_run``) on full-width PAMAP2
              Backbone 2, paper fleet (3,3,2), K=4, 8 absorbed updates per
              run on the heap runtime: static30 x async_relief (fp32),
              static30 x relief_selective (int8, comm budget 0.5), and the
              twins stream30 x async_accessible and x fedmfs_selective
              (the same dispatches: equal completions, the selective one
              under 0.75 of the twin's upload bytes); then stream30 x
              async_relief on the vectorized runtime (grad mode
              "dispatch") against its heap twin, flush histories equal.
              Aggregation launches equal each codec's flushes, the fused
              projection's dispatch calls x 20 steps + the evaluation's
              batches; host wall, ms per dispatch call and per flush
 22. experiments  the experiment runner's Table II (``experiments.
              main_table``) on PAMAP2 B2 FULL, fedavg and relief, 3 rounds
              each: the table row (F1, rare F1, speedup, TTA, MB/r, J/r,
              Esave%) and the fused projection's launches (rounds x 20 +
              the evaluations' and the per-modality evaluation's batches)
 23. scenario check  PAMAP2_B2_SMALL, stream30 x fedmfs_selective, fp32,
              2 flushes, on the card against the CPU from the same seed:
              every dispatch's upload rows S_up and the flush histories
              equal, losses to rtol 1e-4, the trainable to atol 1e-4
 24. paper experiments  Table III (``experiments.ablation``) on PAMAP2 B2
              FULL (fedavg, relief, v1-v3) and Fig. 8
              (``experiments.device_profile``) on MHEALTH B2 FULL (fedavg
              and relief under both timing models), 2 rounds per run,
              nothing cached: each run's line with its device and host
              time, the rows, the fused projection's launches (per run:
              rounds x 20 + (evaluations + 4 per-modality) x batches);
              kernels 1, 2 and 4 none
 25. motivation  Figs. 2-3 (``experiments.motivation``): the instrumented
              FedAvg, 3 rounds, on PAMAP2 B1 FULL (the script's model: no
              fusion LoRA, so no fused-kernel launch) and B2 FULL (3 rounds
              x 2 local updates x 8 steps); the cosines by block (finite, in
              [-1, 1]) and the divergence by block and phase
 26. checkpoint  ``train_relief_har``'s run on PAMAP2 B2 FULL: 2 rounds and
              a save, a fresh run resumed from it (trainable and dbar
              bitwise equal on the card and after a restore onto the CPU),
              a third round and its loss; a leftover half-written
              ``step_<n>.tmp.*`` directory, which ``latest_step()`` ignores
 27. zoo kernels  flash attention and the gathered projection vs their
              plain versions at the rest of the zoo's shapes, as phase 6
              reports them: mixtral's 4096-token window over a ring that
              has wrapped (decode and prefill) and its path shape,
              granite-34b's MQA (G = 48: its decode calls take the prefill
              path), musicgen's MHA (hd 64), llava's G = 7 at a 3072-position
              prefill; the projection at mixtral's wq, wv, wo and
              granite-34b's wv (F = 128)
 28. moe serve  mixtral-8x7b at full width, 20 of its 32 layers (58.6 GB of
              bf16 weights drawn on the card): ``serve.run_batched`` at B=8,
              P=512, 32 decode steps (flash attention's calls by path
              asserted), then ``serve.run_engine`` as phase 8 (16 adapters,
              16 slots, 32 requests; the gathered projection's launches
              asserted)
 29. zoo serve  ``serve.run_batched`` at B=8, P=512, 32 steps on granite-3-8b
              and musicgen-large (all layers, musicgen's prompts and tokens
              with 4 codebooks), granite-34b (20 of 88 layers),
              mixtral-8x22b (8 of 56) and llava-next-34b (30 of 60; B=4,
              2880 stub patch embeddings + 192 text tokens); flash
              attention's calls by path asserted per arch; each model freed
              before the next
 30. zoo check  a float32 two-layer model of each new family at d 512, card
              vs CPU: batched prefill logits and tokens, mixtral's engine
              tokens; one fp32 MoE layer at a prefill shape with capacity
              drops: routings that differ (asserted 0), the kept (token,
              expert) set and the output
 31. lora train  ``launch/train.py``'s backbone mode on phi3-medium-14b FULL
              (40 layers, bf16, random weights drawn on the card) at the
              reference's defaults: LoRA, B=8, S=128, lr 1e-3, the config's
              remat "dots", 8 steps: the loss of every step, ms per step
              (step 1 apart), tokens/s, peak memory, the reference's LoRA
              count 4*N*tokens over the bf16 peak; finite losses, the base
              bitwise unchanged, every LoRA leaf moved; then one more step
              from the same state with remat "dots" and with "none": both
              peaks, the losses within 1e-3. The train step's attention is
              the reference's "xla" (plain): no kernel launches (asserted)
 32. full train  the same on mamba2-1.3b FULL (48 layers), every parameter
              trained (--train-mode full), B=8, S=512, 4 steps; its step
              with remat "none" at B=2 (at B=8 it does not fit the card)
 33. train check  two ``make_train_step`` steps of each family's fp32 SMOKE
              config (phi3, gemma2, mixtral, llava, musicgen, mamba2,
              hymba) on the card against the CPU, remat "dots" and "none":
              losses at rtol 1e-5, parameters within Adam's 2 * lr * steps,
              mixtral's routings equal
 34. federated  ``launch/train.py --mode federated --backbone b2``, 2 rounds
              (the fused block-LoRA kernel: rounds x 20 local steps +
              evaluation batches, asserted), host s per round
 35. guard    flash attention, the gathered projection, the SSD scan and the
              raw fused projection raise under autograd on the card; the
              fused projection trains through its Function; the LoRA
              fine-tune example at SMOKE (its loss falls) and
              ``train.py --smoke``'s save-and-resume (losses bitwise equal
              to the uninterrupted run's)
 36. autotune the autotuner's timed branch (``kernels/cohort_agg/
              autotune.py``) sweeps kernels 1-2's AggPlans at the path
              shape (4, 112, 128) and 16384 x 1024 x 4, kernel 3's
              persistent block count at its path shape and kernel 4's split
              plan at phi3's wq (bf16): each candidate's time, the chosen
              and the default plan's device time; every candidate's output
              held against the plain version (kernel 3: bitwise equal
              across counts); the sweep's launches join the kernels line
 37. dryrun   ``launch/dryrun.py``'s trace of phases 31-32's exact
              configurations on a fake one-rank mesh, in a child process
              started after phase 1 (the fake process group is global to
              a process): predicted peak per device vs the measured
              ``max_memory_allocated`` (asserted within 15%), counted
              FLOPs vs ``model_flops``, t_compute / t_memory vs the
              measured ms per step; and phi3-medium-14b train_4k on the
              (16, 16) fake mesh without probes: status, GiB per device
 38. examples sync  ``launch/quickstart`` at its 12 rounds (PAMAP2, the
              narrow CNN, paper fleet, FedAvg then RELIEF: F1, simulated
              speedup, energy saving, upload, host s per round; RELIEF's
              round shorter, as the reference asserts) and
              ``launch/baseline_duel`` at 2 rounds (all eleven methods, host
              s per method); Backbone 1: 0 kernel launches (asserted)
 39. serve backbone  ``launch/serve_backbone``'s loop (the prompt
              prefilled through the decode step, then greedy decode) at
              B=4, P=32, 24 steps: on phase 7's phi3-medium-14b FULL
              weights with flash attention (run right after phase 8, while
              they sit on the card: 40 layers x 56 steps = 2,240 split-KV
              decode calls of a 56-slot ring that starts empty, asserted),
              on phase 12's hymba-1.5b FULL weights (right after phase 12;
              0 kernel launches, asserted), and a float32 phi3-shaped model
              of 2 layers card (kernel) vs CPU (plain), tokens equal (after
              phase 9); ms per prefill-through-decode step, ms per decode
              step, tok/s
 40. fleet sim  ``launch/fleet_scale_sim`` (grad mode "none": host numpy,
              no kernel) at N = 10^6, K = 64, 50 flushes, churn 0.01,
              arrivals 0.02, jitter 0.1, and at N = 10^4, K = 64, 200
              flushes without churn: wall, events/s, flushes/s, staleness
              p50/p95/max, the alive share; completions >= flushes x K and a
              finite simulated time (asserted)
Each path's launch counts are zeroed just before it and read just after.
Then one JSON line of per-kernel numbers, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero,
and without a card, or without the repository's ``src/`` beside it, the
script exits nonzero before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
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
TF32_FLOPS_PER_S = 495e12
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
    "flash_attention_prefill":
        "src/repro/kernels/flash_attention/kernel.py:72",
    "mdlora_matmul_multi": "src/repro/kernels/mdlora/kernel.py:70",
    "ssd": "src/repro/kernels/ssd/kernel.py:65",
    "mdlora_matmul": "src/repro/kernels/mdlora/kernel.py:117",
}
PATH_SHAPE = (4, 112, 128)  # K=4 buffered clients x fusion_w0 [112, 128]
# Backbone 2's fusion leaf a [112, 8]: K=4 buffered clients (the paper
# fleet, phases 17-19a) and K=64 (the fleet-scale cohort flush, phase 19b)
B2_PATH, B2_FLEET = (4, 112, 8), (64, 112, 8)
CASES = [("path", PATH_SHAPE, False), ("ragged", (9, 100, 1), False),
         ("ragged", (16, 96, 8), False), ("empty", PATH_SHAPE, True),
         ("fleet", (16384, 1024, 4), False), ("b2 path", B2_PATH, False),
         ("b2 fleet", B2_FLEET, False)]


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
            if ("ptxas info" in line and ("Used" in line or "Compiling" in
                                          line)) or "spill" in line:
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


def check_kernels(torch, ops, ref, counts) -> dict:
    results = {k: {} for k in KERNELS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        p = ops.plan_agg(N, D, r, sms)
        calls = {"cohort_agg_divergence": [(
            "", lambda: ops.cohort_agg_divergence(x, W, C),
            lambda: ref.cohort_agg_divergence_ref(x, W, C),
            lambda: ref.cohort_agg_divergence_split_ref(x, W, C, p.splits,
                                                        p.lanes),
            lambda: ref.cohort_agg_divergence_ref(x.abs(), W, C))]}
        calls["cohort_agg_divergence_quant"] = [(
            f" a={a}",
            lambda a=a: ops.cohort_agg_divergence_quant(q, s, W, C, st, a),
            lambda a=a: ref.cohort_agg_divergence_quant_ref(q, s, W, C, st, a),
            lambda a=a: ref.cohort_agg_divergence_quant_split_ref(
                q, s, W, C, st, a, p.splits, p.lanes),
            lambda a=a: ref.cohort_agg_divergence_quant_ref(q.abs(), s, W, C,
                                                            st, a))
            for a in exps]
        for name, variants in calls.items():
            for tag, kern, plain, split, abs_sum in variants:
                got, scale = kern(), abs_sum()
                errs = {}  # yardstick -> [(output, max abs err)]
                for yard, want in (("plain", plain()), ("split", split())):
                    torch.cuda.synchronize()
                    errs[yard] = []
                    for o, a, b, S in zip(("agg", "sq", "mean", "cnt"), got,
                                          want, scale):
                        if not torch.isfinite(a).all():
                            fail(f"{name} {label} {o}: non-finite output")
                        err = (a - b).abs()
                        if (err > ATOL + RTOL * b.abs() + SUM_RTOL * S).any():
                            fail(f"{name} {label} {(N, D, r)} {o} vs the "
                                 f"{yard} plain version: max abs err "
                                 f"{err.max().item():.3e} exceeds {ATOL} + "
                                 f"{RTOL}*|plain| + {SUM_RTOL}*sum|terms|")
                        errs[yard].append((o, err.max().item()))
                split_err = max(e for _, e in errs["split"])
                errs = errs["plain"]
                if label == "fleet":  # no atomics: the same bits again
                    if not all(torch.equal(a, b) for a, b in zip(got, kern())):
                        fail(f"{name} fleet: two calls differ")
                iters = 20 if label == "fleet" else 200
                ms, call_ms = time_ms(torch, kern, iters)
                plain_ms, plain_call = time_ms(torch, plain,
                                               5 if label == "fleet" else iters)
                b_ms, by = bound(name, N, D, r)
                n_launch = counts[f"{name} {label} {(N, D, r)}"]
                if n_launch != 1:
                    fail(f"{name} {label}: {n_launch} launches per call, "
                         "expected 1")
                say(f"[kernel] {name}{tag} {label} N,D,r={N},{D},{r} "
                    f"plan {p.rows} rows x {p.tiles(D)} tiles, {p.lanes} "
                    f"lanes, {p.splits} splits, {n_launch} launch(es) per "
                    "call: " + " ".join(f"{o} {e:.2e}" for o, e in errs)
                    + f" (vs split order {split_err:.2e})"
                    + (" bitwise repeatable" if label == "fleet" else "")
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


def _time_phases(torch, run, names=("_dispatch", "_flush")) -> dict:
    """Wrap the run's client dispatch (local training of the dispatched
    clients) and server flush (aggregation) with synchronized host timers;
    ``names`` are the two methods (the vectorized runtime's are
    ``_dispatch_vec`` and ``_flush_vec``), keyed in the result as
    ``_dispatch`` and ``_flush``."""
    spent = {}
    for key, name in zip(("_dispatch", "_flush"), names):
        spent[key] = [0.0, 0, 0]  # s, calls, clients dispatched
        inner = getattr(run, name)

        def wrapped(*args, _inner=inner, _acc=spent[key],
                    _count=key == "_dispatch", **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _acc[2] += len(args[0]) if _count else 0
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
    # hymba-1.5b's head layout (hd 64, 5 KV heads of 5) and its 1024-token
    # window, which hides the oldest cached keys from every query
    ("hymba prefill", 4, 512, 1600, 5, 5, 64, 1536, 1024, None, True),
    ("hymba decode", 8, 1, 1600, 5, 5, 64, 1536, 1024, None, True),
]
# |kernel - plain| <= atol + rtol*|plain|, the plain version computed in
# fp32 on the same input values. Both accumulate in fp32; a bf16 output
# rounds once, by at most 2^-9 of its value. Outputs range from ~0.05 (decode:
# a softmax-weighted mean of ~500 random v rows) to ~4 (early prefill rows see
# a few keys), so the bound is relative, with an atol for the smallest
FA_TOL = {True: (4e-3, 2**-8), False: (2e-5, 0.0)}  # by bf16?
PHI3_BLOCKS = [512] * 10  # phi3: G * head_dim = 4 * 128 columns per KV group
HYMBA_BLOCKS = [1600, 3200]  # hymba's fusion input: attention, SSD heads
MD_CASES = [  # label, B, D, F, A, r, fusion blocks (None: no mask), bf16?
    ("wq", 16, 5120, 5120, 16, 8, None, True),
    ("wv", 16, 5120, 1280, 16, 8, None, True),
    ("wo", 16, 5120, 5120, 16, 8, PHI3_BLOCKS, True),
    ("wo fp32", 16, 5120, 5120, 16, 8, PHI3_BLOCKS, False),
    # hymba-1.5b: D = 1600 and 4800 are not multiples of the 256-wide
    # staging chunk, and the block edge at 1600 falls inside one
    ("hymba wq", 16, 1600, 1600, 16, 8, None, True),
    ("hymba wv", 16, 1600, 320, 16, 8, None, True),
    ("hymba wo", 16, 4800, 1600, 16, 8, HYMBA_BLOCKS, True),
    ("hymba wo fp32", 16, 4800, 1600, 16, 8, HYMBA_BLOCKS, False),
]
MD_TOL_FP32 = (1e-4, 1e-4)
MD_TOL_BF16 = (2e-2, 1e-2)  # against the plain version's bf16 output


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


LAUNCH_COUNTS = "--launch-counts"  # the child mode of launch_counts()


def _launches_per_call(torch, fn) -> int:
    """CUDA kernel launches one call of ``fn`` makes: the runtime's launch
    calls the profiler records on the host (a copy or memset is not one),
    after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunchKernel"))


def launch_counts_child() -> None:
    """The child mode: one JSON line {case: launches per call} for the
    cohort-agg kernels' CASES, the fused projection's FUSED_CASES, the
    gathered projection's MD_CASES and ZOO_MD_CASES and the SSD scan's
    SSD_CASES."""
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.kernels.cohort_agg import ops
    from repro_torch.kernels.mdlora import ops as md_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    out = {}
    for label, (N, D, r), _ in CASES:
        g = torch.Generator(device="cuda").manual_seed(0)
        kw = dict(device="cuda", generator=g)
        W, C = torch.rand((N, D), **kw), torch.ones((N, D), device="cuda")
        q = torch.randint(-127, 128, (N, D, r), dtype=torch.int8, **kw)
        s, st = torch.rand((N,), **kw), torch.ones((N,), device="cuda")
        x = q.float()
        out[f"cohort_agg_divergence {label} {(N, D, r)}"] = _launches_per_call(
            torch, lambda: ops.cohort_agg_divergence(x, W, C))
        out[f"cohort_agg_divergence_quant {label} {(N, D, r)}"] = \
            _launches_per_call(torch, lambda: ops.cohort_agg_divergence_quant(
                q, s, W, C, st, 0.5))
    for label, K, T, D, F, r, share, bf16 in FUSED_CASES:
        args = _fused_inputs(torch, md_ops, K, T, D, F, r, share, bf16, 0)
        out[f"fused {label}"] = _launches_per_call(
            torch, lambda: md_ops.mdlora_matmul(*args, 2.0))
    for label, B, D, F, A, r, blocks, bf16 in MD_CASES + ZOO_MD_CASES:
        x, w0, a, b, idx, mask = _md_inputs(torch, md_ops, B, D, F, A, r,
                                            blocks, bf16, D + F)
        out[f"mdlora {label}"] = _launches_per_call(
            torch, lambda: md_ops.mdlora_matmul_multi(x, w0, a, b, idx, mask,
                                                      2.0))
    for label, b, s, h, p, n, Q, bf16 in SSD_CASES:
        args = _ssd_inputs(torch, b, s, h, p, n, bf16, 0)
        out[f"ssd {label}"] = _launches_per_call(
            torch, lambda: ssd_ops.ssd(*args, Q))
    print(json.dumps(out), flush=True)


def launch_counts() -> dict:
    """Launches per call of each kernel case, counted by the
    profiler in a child process: in this one, the profiler's hooks would
    slow every host-bound phase after it."""
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          LAUNCH_COUNTS], capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        fail(f"launch counting failed ({res.returncode}):\n"
             f"{res.stderr[-4000:]}")
    counts = json.loads(res.stdout.strip().splitlines()[-1])
    say(f"[launches] per call, profiled in a child process: {counts}")
    return counts


def _fa_inputs(torch, B, S, T, K, G, hd, filled, bf16, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = dict(device="cuda", generator=g)
    q = torch.randn((B, S, K, G, hd), **kw).to(dt)
    k = torch.randn((B, T, K, hd), **kw).to(dt)
    v = torch.randn((B, T, K, hd), **kw).to(dt)
    ar = torch.arange(T, device="cuda", dtype=torch.int32)
    if filled > T:  # a ring that has wrapped: position p at slot p % T
        kp = torch.empty_like(ar)
        kp[(ar + filled - T) % T] = ar + filled - T
    else:  # filled slots in no order, then -1
        kp = torch.where(ar < filled, ar, -1)
        kp = kp[torch.randperm(T, device="cuda", generator=g)]
    qp = torch.arange(filled - S, filled, device="cuda", dtype=torch.int32)
    return q, k, v, qp, kp


def check_flash(torch, fa_ops, fa_ref, cases=FA_CASES) -> dict:
    import torch.nn.functional as F

    say("[flash] bf16 dynamic shared memory per launch (prefill / decode): "
        + ", ".join(f"hd<={hd} {fa_ops.smem_bytes(hd, 'prefill')} / "
                    f"{fa_ops.smem_bytes(hd, 'decode')} B"
                    for hd in (32, 64, 128, 256)))
    out = {}
    for (label, B, S, T, K, G, hd, filled, window, cap, bf16) in cases:
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
        n_split = fa_ops.plan_splits(q.shape, T)
        path = ("fp32" if not bf16 else "prefill" if n_split == 0
                else f"decode, {n_split} chunks")
        say(f"[flash] {label} B={B} S={S} T={T} K={K} G={G} hd={hd} "
            f"{'bf16' if bf16 else 'fp32'} ({path}): max abs err {err:.2e} "
            f"(atol {atol} + {rtol:.4g}*|plain fp32|) | device "
            f"{ms * 1e3:.2f} us/call (graph), eager call "
            f"{call_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"library (SDPA) "
            + ("n/a" if lib_ms is None else
               f"{lib_ms * 1e3:.2f} us (kernel/SDPA {ms / lib_ms:.2f})")
            + f" | bound {b_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB "
            f"with K/V of the {seen} visible slots, "
            f"{4 * hd * pairs / 1e9:.2f} GFLOP) = {b_ms / ms:.1%}")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=by, library_ms=lib_ms)
        del sets, kern, plain
    return out


def _md_inputs(torch, md_ops, B, D, F, A, r, blocks, bf16, seed):
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
    if blocks:
        mm = (torch.rand((B, len(blocks)), **kw) < 0.8).float()
        mm[:, 0] = 1.0
        mask = md_ops.block_row_masks(blocks, mm).contiguous()
    return x, w0, a, b, idx, mask


def check_mdlora(torch, md_ops, md_ref, counts, cases=MD_CASES) -> dict:
    out = {}
    for label, B, D, F, A, r, blocks, bf16 in cases:
        masked = blocks is not None
        x, w0, a, b, idx, mask = _md_inputs(torch, md_ops, B, D, F, A, r,
                                            blocks, bf16, D + F)
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
        # yardstick, not a port: cuBLAS's base product alone on the same
        # (masked) input, x*m materialized outside the timing
        xms = [(x if m is None else (x.float() * m).to(x.dtype), w)
               for x, w, _, _, m in sets]
        cublas_ms, _ = time_ms(torch, _rotating(xms, lambda x, w: x @ w),
                               200)
        per_call = counts[f"mdlora {label}"]
        used = int(idx.unique().numel())  # adapters this batch reads
        es = x.element_size()
        nbytes = (B * D + D * F + B * F) * es + 4 * used * r * (D + F) \
            + 4 * B + (4 * B * D if masked else 0)
        flops = 2 * B * D * F + 2 * B * r * (D + F) + (B * D if masked else 0)
        b_ms, by = _bound(nbytes, flops, _flops_peak(torch, x))
        say(f"[mdlora] {label} B={B} D={D} F={F} A={A} ({used} used) r={r} "
            f"{f'masked in {len(blocks)} blocks' if masked else 'no mask'} "
            f"{'bf16' if bf16 else 'fp32'}: max abs err "
            f"{err.max().item():.2e} | device {ms * 1e3:.2f} us/call "
            f"(graph), eager call {call_ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, library n/a (cuBLAS x @ W0 alone "
            f"{cublas_ms * 1e3:.2f} us) | {per_call} kernel launch(es) per "
            f"call | bound {b_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB)"
            f" = {b_ms / ms:.1%}")
        if bf16 and per_call != 1:
            fail(f"mdlora_matmul_multi {label}: a bf16 call launched "
                 f"{per_call} kernels, not 1")
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
        del sets, kern, plain, xms
    return out


# -- phases 7-8 -------------------------------------------------------------

SERVE = dict(batch=8, prompt_len=512, decode_steps=32)
ENGINE = dict(n_adapters=16, batch=16, n_requests=32, prompt_len=256,
              min_prompt_len=64, decode_steps=32)


def _counts(kops) -> dict:
    """Launch counts of the serving kernels: ``kops`` holds the flash,
    mdlora and ssd ops modules."""
    out = {}
    for ops in kops:
        out.update(ops.LAUNCHES)
    return out


def _reset_all(kops) -> None:
    for ops in kops:
        ops.reset_launches()


def _flash_paths(fa_ops, cfg, steps: int) -> dict:
    """Flash calls by path of a batched serve: each layer's prefill call
    takes the prefill path; a decode call has S*G = G rows and takes the
    split-KV decode path when G <= DECODE_ROWS, else the prefill path
    (granite-34b's MQA: G = 48)."""
    G = cfg.n_heads // cfg.n_kv_heads
    want = {"fp32": 0, "prefill": cfg.n_layers, "decode": 0}
    want["decode" if G <= fa_ops.DECODE_ROWS else "prefill"] += \
        cfg.n_layers * steps
    return want


def serve_batched(torch, serve, kops, cfg, params, shape=SERVE,
                  patches=None) -> dict:
    """``serve.run_batched`` at ``shape`` (``patches`` first, for llava)
    -> flash attention's calls by path, asserted against ``_flash_paths``
    and against ``cfg.n_layers x (1 + decode steps)`` calls in all."""
    fa_ops = kops[0]
    # cold start (cuBLAS handles, allocator growth) outside the window
    serve.run_batched(cfg, params, batch=shape["batch"],
                      prompt_len=shape["prompt_len"], decode_steps=2,
                      device="cuda", patches=patches)
    _reset_all(kops)
    res = serve.run_batched(cfg, params, device="cuda", patches=patches,
                            **shape)
    n = _counts(kops)
    by_path = dict(fa_ops.PATH_LAUNCHES)
    fa, md = n["flash_attention"], n["mdlora_matmul_multi"]
    want = cfg.n_layers * (1 + shape["decode_steps"])
    say(f"[serve] {cfg.arch} kernel launches: flash_attention {fa} (expected "
        f"{want} = {cfg.n_layers} layers x (1 prefill + "
        f"{shape['decode_steps']} decode steps)), mdlora_matmul_multi {md} "
        "(expected 0)")
    if fa != want or md != 0:
        fail("batched serve did not launch the kernels as its path requires")
    paths = _flash_paths(fa_ops, cfg, shape["decode_steps"])
    say(f"[serve] {cfg.arch} flash_attention calls by path: {by_path} "
        f"(expected {paths}: G = {cfg.n_heads // cfg.n_kv_heads} rows per "
        f"decode call, DECODE_ROWS = {fa_ops.DECODE_ROWS})")
    if by_path != paths:
        fail("batched serve did not take the prefill and decode paths")
    if not torch.isfinite(res["prefill_logits"]).all():
        fail("batched serve: non-finite logits")
    B, P, n = shape["batch"], shape["prompt_len"], shape["decode_steps"]
    pre = 0 if patches is None else patches.shape[1]
    say(f"[serve] {cfg.arch} FULL width ({cfg.n_layers} layers, {cfg.dtype})"
        f" B={B} P={P}" + (f" after {pre} patches" if pre else "")
        + f": prefill {res['prefill_s'] * 1e3:.1f} ms "
        f"({B * (pre + P) / res['prefill_s']:.0f} prompt positions/s); "
        f"decode {n} steps in {res['decode_s']:.3f} s = "
        f"{res['decode_ms_per_step']:.2f} ms per step, {res['tok_s']:.1f} "
        f"tok/s; tokens in [0, {cfg.vocab}), logits finite; sample "
        f"{res['tokens'][0].reshape(-1)[:8].tolist()}")
    return by_path


def serve_engine(torch, serve, kops, cfg, params) -> int:
    serve.run_engine(cfg, params, n_adapters=2, batch=2, n_requests=2,
                     prompt_len=64, decode_steps=2, device="cuda")
    _reset_all(kops)
    res = serve.run_engine(cfg, params, device="cuda", **ENGINE)
    n = _counts(kops)
    fa, md = n["flash_attention"], n["mdlora_matmul_multi"]
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


def _check_config(full):
    """A float32 phi3-shaped model of 2 layers at d 512 (phases 9, 39)."""
    return dataclasses.replace(
        full, arch="phi3-medium-14b-check", n_layers=2, d_model=512,
        n_heads=8, n_kv_heads=2, head_dim=64, d_ff=1792, vocab=2048,
        dtype="float32", param_dtype="float32", attn_impl="pallas")


def _check_model(torch, api, tree_map, full) -> tuple:
    """``_check_config``'s model from seed 3 -> (cfg, CPU params, the same
    params on the card)."""
    cfg = _check_config(full)
    cpu = api.init_model(torch.Generator().manual_seed(3), cfg, "cpu")
    return cfg, cpu, tree_map(lambda t: t.to("cuda"), cpu)


def serve_check(torch, serve, serving_engine, api, kops, tree_map,
                full) -> None:
    cfg, cpu, gpu = _check_model(torch, api, tree_map, full)
    kw = dict(n_adapters=4, batch=4, n_requests=10, prompt_len=40,
              min_prompt_len=8, decode_steps=8, seed=1)
    _reset_all(kops)
    eg = serve.run_engine(cfg, gpu, device="cuda", **kw)
    ec = serve.run_engine(cfg, cpu, device="cpu", **kw)
    naive = serving_engine.naive_serve(gpu, cfg, eg["registry"],
                                       eg["requests"], eg["max_len"])
    bkw = dict(batch=4, prompt_len=40, decode_steps=8, seed=1)
    bg = serve.run_batched(cfg, gpu, device="cuda", **bkw)
    bc = serve.run_batched(cfg, cpu, device="cpu", **bkw)
    n = _counts(kops)
    fa, md = n["flash_attention"], n["mdlora_matmul_multi"]
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


# -- phase 10 ---------------------------------------------------------------

# the SSD scan at the prefill step's shapes (B=4, S=4096): mamba2-1.3b's 64
# heads of 64 with state 128, hymba-1.5b's 50 heads with state 16
SSD_CASES = [  # label, b, s, h, p, n, chunk, bf16?
    ("mamba2", 4, 4096, 64, 64, 128, 64, True),
    ("mamba2 fp32", 4, 4096, 64, 64, 128, 64, False),
    ("hymba", 4, 4096, 50, 64, 16, 64, True),
    ("hymba fp32", 4, 4096, 50, 64, 16, 64, False),
    ("odd", 2, 96, 3, 24, 8, 32, False),
]
# |kernel - plain| <= atol + rtol |plain| + (SSD_SUM_RTOL + SSD_CUM_ULPS u
# C) S, with the plain version in fp32 on the same values, S the same scan
# over |x|, |B|, |C|, u = 2^-24 and C the largest log-decay of a chunk,
# max |cum|. Both sides sum over n, Q and the chunks in other orders, so
# their difference grows with S; and both take exp(cum_i - cum_j) from
# running sums that reach C (~1000 at the models' A = 1..16 and dt ~ 0.7 over
# 64 steps), each rounded in its own order, so every decayed term carries a
# relative error of a few ulps of C. S bounds the sum of |terms| ~10x over;
# a dropped or doubled term moves y by more than a thirtieth of S. bf16 y
# is rounded once (2^-9 of its value); the atol covers y near zero
SSD_TOL = {True: (1e-3, 2**-8), False: (1e-4, 1e-4)}  # by bf16?
SSD_SUM_RTOL = 1e-6
SSD_CUM_ULPS = 16


def _ssd_inputs(torch, b, s, h, p, n, bf16, seed):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A_log as the models
    initialize it, log(linspace(1, 16, h))."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    dt_ = torch.bfloat16 if bf16 else torch.float32
    x = torch.randn((b, s, h, p), **kw).to(dt_)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), **kw))
    A_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    Bm = torch.randn((b, s, n), **kw).to(dt_)
    Cm = torch.randn((b, s, n), **kw).to(dt_)
    return x, dt, A_log, Bm, Cm


def _ssd_work(b, s, h, p, n, Q, es) -> tuple[int, int]:
    """(bytes, flops) the scan needs: x, dt, A_log, B, C read once, y and
    the final state written once; C·Bᵀ once per (batch row, chunk) over the
    causal pairs, then per head the intra-chunk product over the causal
    pairs, the carried state's term and the state update."""
    nbytes = 2 * b * s * h * p * es + 4 * b * s * h + 4 * h \
        + 2 * b * s * n * es + 4 * b * h * p * n
    pairs = Q * (Q + 1) // 2
    nc = s // Q
    flops = 2 * b * nc * (pairs * n + h * (pairs * p + 2 * Q * p * n))
    return nbytes, flops


def ssd_initial_state(torch, ssd_ops, ssd_ref, x, dt, A_log, Bm, Cm, Q,
                      label) -> None:
    """The kernel from a carried state against the plain version from the
    same state, at the unchanged tolerance (S over |state| too)."""
    b, s, h, p = x.shape
    g = torch.Generator(device="cuda").manual_seed(s + h)
    s0 = torch.randn((b, h, p, Bm.shape[-1]), device="cuda", generator=g)
    y, fs = ssd_ops.ssd(x, dt, A_log, Bm, Cm, Q, initial_state=s0)
    f = lambda t: t.float()  # noqa: E731
    want = ssd_ref.ssd_ref(f(x), dt, A_log, f(Bm), f(Cm), Q, s0)
    scale = ssd_ref.ssd_ref(f(x).abs(), dt, A_log, f(Bm).abs(), f(Cm).abs(),
                            Q, s0.abs())
    C = (torch.exp(A_log) * dt).reshape(b, s // Q, Q, h).sum(2).max()
    sum_rtol = SSD_SUM_RTOL + SSD_CUM_ULPS * 2**-24 * C.item()
    errs = []
    for o, a, w, S, (atol, rtol) in zip(
            ("y", "state"), (y, fs), want, scale,
            (SSD_TOL[x.dtype == torch.bfloat16], SSD_TOL[False])):
        err = (a.float() - w).abs()
        if not torch.isfinite(a).all() or \
                (err > atol + rtol * w.abs() + sum_rtol * S).any():
            fail(f"ssd {label} with an initial state: {o} max abs err "
                 f"{err.max().item():.3e}")
        errs.append(f"{o} {err.max().item():.2e}")
    first = (want[0] - ssd_ref.ssd_ref(f(x), dt, A_log, f(Bm), f(Cm),
                                       Q)[0]).abs()[:, :Q].max().item()
    say(f"[ssd] {label} from an initial state N(0, 1): max abs err "
        f"{', '.join(errs)} (same tolerance); the state moves the first "
        f"chunk's y by up to {first:.2e}")


def check_ssd(torch, ssd_ops, ssd_ref, ssm, counts) -> dict:
    out = {}
    for label, b, s, h, p, n, Q, bf16 in SSD_CASES:
        x, dt, A_log, Bm, Cm = _ssd_inputs(torch, b, s, h, p, n, bf16,
                                           b + s + h + p + n)
        got = ssd_ops.ssd(x, dt, A_log, Bm, Cm, Q)
        again = ssd_ops.ssd(x, dt, A_log, Bm, Cm, Q)
        f = lambda t: t.float()  # noqa: E731
        want = ssd_ref.ssd_ref(f(x), dt, A_log, f(Bm), f(Cm), Q)
        scale = ssd_ref.ssd_ref(f(x).abs(), dt, A_log, f(Bm).abs(),
                                f(Cm).abs(), Q)
        exact = ssd_ref.ssd_ref(x.double(), dt, A_log, Bm, Cm, Q,
                                compute_dtype=torch.float64)
        C = (torch.exp(A_log) * dt).reshape(b, s // Q, Q, h).sum(2).max()
        sum_rtol = SSD_SUM_RTOL + SSD_CUM_ULPS * 2**-24 * C.item()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], again[0])
                and torch.equal(got[1], again[1])):
            fail(f"ssd {label}: two calls differ")
        errs, vs64 = [], []
        for o, a, w, S, e, (atol, rtol) in zip(
                ("y", "state"), got, want, scale, exact,
                (SSD_TOL[bf16], SSD_TOL[False])):
            if not torch.isfinite(a).all():
                fail(f"ssd {label} {o}: non-finite output")
            err = (a.float() - w).abs()
            if (err > atol + rtol * w.abs() + sum_rtol * S).any():
                fail(f"ssd {label} {o}: max abs err {err.max().item():.3e} "
                     f"exceeds {atol} + {rtol:.4g}*|plain| + "
                     f"{sum_rtol:.3g}*S")
            errs.append((o, err.max().item()))
            vs64.append(f"{o} kernel {(a.double() - e).abs().max().item():.2e}"
                        f" plain {(w.double() - e).abs().max().item():.2e}")
        rel = ""
        if bf16:  # y is stored in bf16: its own rounding is the yardstick
            e16 = exact[0].to(torch.bfloat16).double()
            top = want[0].abs().max().item()
            w16 = want[0].to(torch.bfloat16).double()
            rel = (f"; bf16 y: max abs err / max |y| {errs[0][1] / top:.2e} "
                   f"(max |y| {top:.1f}), vs fp64 rounded to bf16: kernel "
                   f"{(got[0].double() - e16).abs().max().item():.2e}, "
                   "plain rounded to bf16 "
                   f"{(w16 - e16).abs().max().item():.2e}")
        del exact
        sets = _copies(torch, (x, dt, Bm, Cm))
        kern = _rotating(sets, lambda x, dt, Bm, Cm: ssd_ops.ssd(
            x, dt, A_log, Bm, Cm, Q))
        plain = _rotating(sets, lambda x, dt, Bm, Cm: ssd_ref.ssd_ref(
            x, dt, A_log, Bm, Cm, Q))
        big = b * s > 1024
        per_call = counts[f"ssd {label}"]
        path = ("chunk walk (tensor cores)"
                if ssd_ops.chunk_walk(Q, p, n, x.dtype) else "scores + scan")
        ms, call_ms = time_ms(torch, kern, 10 if big else 200)
        plain_ms, _ = time_ms(torch, plain, 3 if big else 20)
        nbytes, flops = _ssd_work(b, s, h, p, n, Q, x.element_size())
        b_ms, by = _bound(nbytes, flops, _flops_peak(torch, x))
        say(f"[ssd] {label} b={b} s={s} h={h} p={p} n={n} chunk={Q} "
            f"{'bf16' if bf16 else 'fp32'}: max abs err "
            + " ".join(f"{o} {e:.2e}" for o, e in errs)
            + f" (atol {SSD_TOL[bf16][0]} + {SSD_TOL[bf16][1]:.4g}*|plain"
            f" fp32| + {sum_rtol:.3g}*S, C {C.item():.0f}); vs the plain "
            f"version in fp64: {', '.join(vs64)}{rel}; two calls bitwise "
            f"equal | {path}, {per_call} kernel launch(es) per call | device "
            f"{ms * 1e3:.2f} us/call (graph), eager call {call_ms * 1e3:.2f}"
            f" us, plain {plain_ms * 1e3:.2f} us, library n/a | bound "
            f"{b_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP) = {b_ms / ms:.1%}")
        out[label] = dict(max_abs_err=max(e for _, e in errs), ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                          library_ms=None)
        del sets, kern, plain
        if label in ("mamba2", "hymba"):
            ssd_initial_state(torch, ssd_ops, ssd_ref, x, dt, A_log, Bm, Cm,
                              Q, label)
    # the sequential recurrence, at a small shape
    x, dt, A_log, Bm, Cm = _ssd_inputs(torch, 1, 64, 2, 8, 4, False, 0)
    y, fs = ssd_ops.ssd(x, dt, A_log, Bm, Cm, 16)
    state = torch.zeros((1, 2, 8, 4), device="cuda")
    err = 0.0
    for t in range(64):
        yt, state = ssm.ssd_decode_step(state, x[:, t], dt[:, t], A_log,
                                        Bm[:, t], Cm[:, t])
        err = max(err, (y[:, t] - yt).abs().max().item())
    err = max(err, (fs - state).abs().max().item())
    say(f"[ssd] vs the token-by-token recurrence (b=1 s=64 h=2 p=8 n=4 "
        f"chunk=16 fp32): max abs err {err:.2e} (atol 1e-4)")
    if err > 1e-4:
        fail("ssd disagrees with the sequential recurrence")
    return out


# -- phases 11-12 -------------------------------------------------------------

PREFILL = dict(batch=4, seq=4096)
MAMBA_SERVE = dict(batch=8, prompt_len=64, decode_steps=32)
HYMBA_ENGINE = dict(n_adapters=16, batch=8, n_requests=16, prompt_len=32,
                    min_prompt_len=8, decode_steps=16)


def model_params(torch, serve, api, cfg) -> dict:
    """Random weights of ``cfg`` drawn on the card from seed 0."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = serve.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    say(f"[{cfg.arch}] FULL width ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.dtype}): {api.param_count(params) / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card, drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    return params


def prefill_step(torch, step_fns, kops, cfg, params) -> int:
    """``step_fns.make_prefill_step`` at B=4, S=4096: one SSD launch per
    layer."""
    B, S = PREFILL["batch"], PREFILL["seq"]
    step = step_fns.make_prefill_step(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda",
                           dtype=torch.int32)
    step(params, {"tokens": tokens[:, :cfg.ssd_chunk]})  # cold start
    torch.cuda.synchronize()
    _reset_all(kops)
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _counts(kops)
    say(f"[{cfg.arch}] prefill step B={B} S={S}: kernel launches {n} "
        f"(expected ssd {cfg.n_layers} = one per layer, the others 0)")
    if n["ssd"] != cfg.n_layers or n["flash_attention"] or \
            n["mdlora_matmul_multi"]:
        fail(f"{cfg.arch} prefill step did not launch the SSD kernel once "
             "per layer")
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not torch.isfinite(logits).all():
        fail(f"{cfg.arch} prefill step: bad logits {tuple(logits.shape)}")
    say(f"[{cfg.arch}] prefill step B={B} S={S}: {wall * 1e3:.1f} ms host "
        f"wall after synchronize ({B * S / wall:.0f} prompt tok/s); "
        f"last-position logits {tuple(logits.shape)} finite")
    return n["ssd"]


def mamba_serve(torch, serve, kops, cfg, params) -> None:
    serve.run_batched(cfg, params, batch=MAMBA_SERVE["batch"], prompt_len=4,
                      decode_steps=2, device="cuda")  # cold start
    _reset_all(kops)
    res = serve.run_batched(cfg, params, device="cuda", **MAMBA_SERVE)
    n = _counts(kops)
    B, P, steps = (MAMBA_SERVE["batch"], MAMBA_SERVE["prompt_len"],
                   MAMBA_SERVE["decode_steps"])
    say(f"[{cfg.arch}] batched serve: kernel launches {n} (expected none: "
        "the prefill is the token loop of decode steps, and decode is the "
        "O(1) recurrence)")
    if any(n.values()):
        fail(f"{cfg.arch} batched serve launched a kernel off its path")
    if not torch.isfinite(res["prefill_logits"]).all():
        fail(f"{cfg.arch} batched serve: non-finite logits")
    state_bytes = 4 * cfg.n_layers * B * cfg.d_inner * cfg.ssm_state
    say(f"[{cfg.arch}] batched serve B={B} P={P}: prefill (token loop) "
        f"{res['prefill_s'] * 1e3:.1f} ms ({B * P / res['prefill_s']:.0f} "
        f"prompt tok/s); decode {steps} steps in {res['decode_s']:.3f} s = "
        f"{res['decode_ms_per_step']:.2f} ms per step, {res['tok_s']:.1f} "
        f"tok/s; SSM state {state_bytes / 1e6:.0f} MB fp32 read and written "
        f"per step; sample {res['tokens'][0, :8].tolist()}")


def hymba_engine(torch, serve, kops, cfg, params) -> int:
    serve.run_engine(cfg, params, n_adapters=2, batch=2, n_requests=2,
                     prompt_len=8, decode_steps=2, device="cuda")
    _reset_all(kops)
    res = serve.run_engine(cfg, params, device="cuda", **HYMBA_ENGINE)
    n = _counts(kops)
    steps = len(res["decode_step_times"])
    want = 3 * cfg.n_layers * steps
    say(f"[{cfg.arch}] engine: kernel launches {n} (expected "
        f"mdlora_matmul_multi {want} = wq, wv, fusion wo x {cfg.n_layers} "
        f"layers x {steps} decode steps; the others 0: admissions prefill "
        "by the token loop, and the attention is the plain chunked one)")
    if n["mdlora_matmul_multi"] != want or n["flash_attention"] or n["ssd"]:
        fail("the hymba engine did not launch the kernels as its path "
             "requires")
    n_req = HYMBA_ENGINE["n_requests"]
    if len(res["outputs"]) != n_req or res["generated_tokens"] != \
            n_req * HYMBA_ENGINE["decode_steps"]:
        fail(f"hymba engine served {len(res['outputs'])} requests, "
             f"{res['generated_tokens']} tokens")
    if not all(0 <= t < cfg.vocab for v in res["outputs"].values()
               for t in v):
        fail("hymba engine: token ids outside the vocab")
    st = sorted(res["decode_step_times"])
    E = HYMBA_ENGINE
    say(f"[{cfg.arch}] engine FULL: {n_req} requests ({E['n_adapters']} "
        f"adapters, fusion masks over blocks {HYMBA_BLOCKS}, {E['batch']} "
        f"slots, prompts {E['min_prompt_len']}-{E['prompt_len']} tokens, "
        f"{E['decode_steps']} new tokens each): {res['generated_tokens']} "
        f"tokens in {res['wall_s']:.2f} s = {res['tok_s']:.1f} tok/s; "
        f"latency p50 {res['latency_p50_s']:.3f} s, p99 "
        f"{res['latency_p99_s']:.3f} s; {steps} decode steps, p50 "
        f"{st[len(st) // 2] * 1e3:.2f} ms, max {st[-1] * 1e3:.2f} ms; "
        f"{res['n_steps']} engine steps")
    return n["mdlora_matmul_multi"]


# -- phase 13 ---------------------------------------------------------------


def recurrent_check(torch, serve, serving_engine, step_fns, api, kops,
                    tree_map, get_arch) -> None:
    """mamba2 and hymba SMOKE in fp32: prefill-step logits on the card (SSD
    kernel) vs the CPU (plain version); hymba engine tokens on the card
    equal the CPU's and the card's per-request baseline."""
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        cfg = dataclasses.replace(get_arch(arch).SMOKE, attn_impl="pallas")
        cpu = api.init_model(torch.Generator().manual_seed(3), cfg, "cpu")
        gpu = tree_map(lambda t: t.to("cuda"), cpu)
        tok = torch.randint(0, cfg.vocab, (3, 64), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(4))
        step = step_fns.make_prefill_step(cfg)
        _reset_all(kops)
        lg = step(gpu, {"tokens": tok.to("cuda")}).cpu()
        n = _counts(kops)
        lc = step(cpu, {"tokens": tok})
        err = (lg - lc).abs().max().item()
        say(f"[check] {arch} SMOKE fp32 prefill step (B=3, S=64): logits "
            f"card vs CPU max abs err {err:.2e} (atol {CHECK_ATOL}); card "
            f"launches {n}")
        if n["ssd"] != cfg.n_layers or err > CHECK_ATOL:
            fail(f"{arch} prefill step on the card differs from the CPU or "
                 "skipped the SSD kernel")
        if cfg.family != "hybrid":
            continue
        kw = dict(n_adapters=3, batch=2, n_requests=5, prompt_len=12,
                  min_prompt_len=4, decode_steps=6, seed=1)
        _reset_all(kops)
        eg = serve.run_engine(cfg, gpu, device="cuda", **kw)
        n = _counts(kops)
        ec = serve.run_engine(cfg, cpu, device="cpu", **kw)
        naive = serving_engine.naive_serve(gpu, cfg, eg["registry"],
                                           eg["requests"], eg["max_len"])
        say(f"[check] {arch} SMOKE fp32 engine ({len(eg['outputs'])} "
            f"requests over 2 slots, {eg['generated_tokens']} tokens, fusion "
            f"blocks {eg['registry'].block_dims}): tokens card == CPU: "
            f"{eg['outputs'] == ec['outputs']}, card == naive_serve: "
            f"{eg['outputs'] == naive['outputs']}; card launches {n}")
        if n["mdlora_matmul_multi"] == 0:
            fail("hymba engine check: the card run skipped the gathered "
                 "kernel")
        if eg["outputs"] != ec["outputs"] or eg["outputs"] != \
                naive["outputs"]:
            fail("hymba engine check: tokens differ (card vs CPU or naive)")


# -- phase 14 ---------------------------------------------------------------

# the fused projection at the sync path's shapes: PAMAP2_B2's fusion input
# D = 32+32+32+16 = 112 -> d_fused 128, r 8, scale 16/8
PAMAP2_BLOCKS = [32, 32, 32, 16]
FUSED_CASES = [  # label, K, T, D, F, r, shared operands, bf16?
    ("path", 8, 32, 112, 128, 8, ("w0",), False),
    ("path bf16", 8, 32, 112, 128, 8, ("w0",), True),
    ("eval", None, 256, 112, 128, 8, (), False),
    ("ragged", 3, 37, 100, 70, 5, ("w0",), False),
    ("1024 clients", 1024, 32, 112, 128, 8, ("w0",), False),
]
# |kernel - plain| <= atol + rtol |plain|: fp32 sums over D = 112 in
# another order; bf16 y is rounded once (2^-8 of its value)
FUSED_TOL = {False: (1e-4, 1e-4), True: (2e-2, 2**-8)}


def _fused_inputs(torch, md_ops, K, T, D, F, r, share, bf16, seed):
    """x, W0, a, b, row mask as the path gives them: W0 [D, F] shared,
    per-client a/b and row masks from the paper fleet's modality masks
    (``K`` None: one evaluation batch, every operand unbatched)."""
    from repro_torch.sim import make_fleet

    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    dt = torch.bfloat16 if bf16 else torch.float32
    lead = () if K is None else (K,)
    x = torch.randn(lead + (T, D), **kw).to(dt)
    w0 = (torch.randn((D, F), **kw) / math.sqrt(D)).to(dt)
    a = (torch.randn(lead + (D, r), **kw) / math.sqrt(D)).to(dt)
    b = (torch.randn(lead + (r, F), **kw) * 0.05).to(dt)
    blocks = PAMAP2_BLOCKS if D == 112 else [D - 3 * (D // 4)] + [D // 4] * 3
    mm = torch.as_tensor(make_fleet(3, 3, 2, M=4).modality_mask,
                         dtype=torch.float32, device="cuda")
    if K is None:
        mm = torch.ones((1, 4), device="cuda")
    mm = mm[torch.arange(K or 1, device="cuda") % mm.shape[0]]
    mask = md_ops.block_row_masks(blocks, mm).contiguous()
    if K is None:
        mask = mask[0]
    return x, w0, a, b, mask


def _fused_work(K, T, D, F, r, share, es) -> tuple[int, int]:
    """(bytes, flops): each operand read once (a shared one once in all),
    y written once; the base product, the bottleneck, u @ b, the mask and
    the scaled sum."""
    k = K or 1
    n = lambda name: 1 if (K is None or name in share) else k  # noqa: E731
    nbytes = (k * T * D + n("w0") * D * F + n("a") * D * r + n("b") * r * F
              + k * T * F) * es + 4 * n("mask") * D
    flops = k * T * (2 * D * F + 2 * D * r + 2 * r * F + D + 2 * F)
    return nbytes, flops


def _fused_bound(nbytes: int, flops: int, bf16: bool) -> tuple[float, str]:
    """fp32 runs on the tensor cores as 3xTF32: three TF32 products per
    product, over the TF32 peak; bf16 one product over the bf16 peak."""
    if bf16:
        return _bound(nbytes, flops, BF16_FLOPS_PER_S)
    return _bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)


def check_fused(torch, md_ops, md_ref, fused_block_lora, counts) -> dict:
    out = {}
    for label, K, T, D, F, r, share, bf16 in FUSED_CASES:
        x, w0, a, b, mask = _fused_inputs(torch, md_ops, K, T, D, F, r,
                                          share, bf16, T + D + F + r)
        got = md_ops.mdlora_matmul(x, w0, a, b, mask, 2.0)
        again = md_ops.mdlora_matmul(x, w0, a, b, mask, 2.0)
        want = md_ref.mdlora_matmul_ref(x, w0, a, b, mask, 2.0)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"mdlora_matmul {label}: two calls differ")
        err = (got.float() - want.float()).abs()
        atol, rtol = FUSED_TOL[bf16]
        if not torch.isfinite(got).all() or (
                err > atol + rtol * want.float().abs()).any():
            fail(f"mdlora_matmul {label}: max abs err {err.max().item():.3e}"
                 f" exceeds {atol} + {rtol:.4g}*|plain|")
        sets = _copies(torch, (x, w0, a, b, mask))
        kern = _rotating(sets, lambda x, w0, a, b, m:
                         md_ops.mdlora_matmul(x, w0, a, b, m, 2.0))
        plain = _rotating(sets, lambda x, w0, a, b, m:
                          md_ref.mdlora_matmul_ref(x, w0, a, b, m, 2.0))
        xm_sets = [((x * m.unsqueeze(-2)).to(x.dtype), w0)
                   for x, w0, _, _, m in sets]
        base = _rotating(xm_sets, torch.matmul)
        iters = 50 if K == 1024 else 200
        ms, call_ms = time_ms(torch, kern, iters)
        plain_ms, plain_call = time_ms(torch, plain, iters)
        base_ms, _ = time_ms(torch, base, iters)
        nbytes, flops = _fused_work(K, T, D, F, r, share, x.element_size())
        b_ms, by = _fused_bound(nbytes, flops, bf16)
        n_launch = counts[f"fused {label}"]
        if n_launch != 1:
            fail(f"mdlora_matmul {label}: {n_launch} launches per call")
        say(f"[fused] {label} K={K} T={T} D={D} F={F} r={r} shared "
            f"{'/'.join(share) or 'none'} "
            f"{'bf16 via mma.sync' if bf16 else 'fp32 via 3xTF32 mma.sync'}"
            f", {n_launch} launch per call: max "
            f"abs err {err.max().item():.2e} (atol {atol} + {rtol:.4g}"
            f"*|plain|), two calls bitwise equal | device "
            f"{ms * 1e3:.2f} us/call (graph), eager call {call_ms * 1e3:.2f}"
            f" us, plain {plain_ms * 1e3:.2f} us (eager "
            f"{plain_call * 1e3:.2f} us), cuBLAS base product (x*m)@W0 alone"
            f" {base_ms * 1e3:.2f} us, library n/a | bound "
            f"{b_ms * 1e3:.3f} us ({by}: {nbytes / 1e6:.3f} MB, "
            f"{flops / 1e6:.2f} MFLOP) = {b_ms / ms:.1%}")
        out[label] = dict(max_abs_err=err.max().item(), ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                          library_ms=None)
        del sets, xm_sets, kern, plain, base
    # backward: the autograd Function's vmap(grad) vs the plain expression's
    x, w0, a, b, mask = _fused_inputs(torch, md_ops, 8, 32, 112, 128, 8,
                                      ("w0",), False, 1)

    def grads(fn):
        def loss(a_, b_, x_, m_):
            return torch.tanh(fn(x_, w0, a_, b_, m_, 2.0)).square().sum()
        return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
            a, b, x, mask)

    got, want = grads(fused_block_lora), grads(md_ref.mdlora_matmul_ref)
    torch.cuda.synchronize()
    errs = [(n, (g - w).abs().max().item())
            for n, g, w in zip(("da", "db", "dx"), got, want)]
    zero = bool((got[0][mask == 0] == 0).all())
    say("[fused] backward at the path shape, vmap(grad) over 8 clients: "
        "Function (kernel forward) vs plain expression max abs err "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs)
        + f" (atol 1e-4); rows of da for absent blocks exactly 0: {zero}")
    if any(e > 1e-4 for _, e in errs) or not zero:
        fail("the fused projection's gradient disagrees with the plain "
             "expression's")
    return out


# -- phase 15 ---------------------------------------------------------------

SYNC_ROUNDS = 3


def _time_rounds(torch, run) -> list:
    """Wrap ``run.round`` with a synchronized host timer per round."""
    walls, inner = [], run.round

    def timed(dataset):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rec = inner(dataset)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        return rec

    run.round = timed
    return walls


PROFILE_SYNC = "--profile-sync"  # the child mode of sync_path's profile


def profile_sync_child() -> None:
    """The child mode: a warm-up relief round of ``train_relief_har``'s run
    on PAMAP2 B2 FULL at one local epoch, then one more under the profiler
    (its lines on stdout)."""
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.launch import profile_serve, train_relief_har
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run, ds = train_relief_har.build(strategy="relief", device="cuda")
    # one local epoch (4 of a round's 20 steps): the idle share is per step,
    # and the profiler records and sums a fifth of the events
    run = type(run).create(run.task, run.proto, run.strategy, run.fleet,
                           dataclasses.replace(run.fed, local_epochs=1))
    run.round(ds)
    profile_serve.profile_steps("sync relief round (1 local epoch: 4 steps)",
                                lambda: run.round(ds), 1,
                                torch.device("cuda"))


def sync_path(torch, md_ops, train_relief_har) -> int:
    # cold start (cuBLAS handles, first vmap traces) outside the window
    run, ds = train_relief_har.build(device="cuda")
    t0 = time.perf_counter()
    run.round(ds)
    run.evaluate(ds)
    torch.cuda.synchronize()
    say(f"[sync] cold start: one round and one evaluation "
        f"{time.perf_counter() - t0:.2f}s host wall")
    total = 0
    for strategy in ("relief", "fedavg"):
        run, ds = train_relief_har.build(strategy=strategy, device="cuda")
        walls = _time_rounds(torch, run)
        fed = run.fed
        n_test = sum(len(y) for y in ds.test_y)
        want = SYNC_ROUNDS * fed.local_epochs * fed.steps_per_epoch \
            + -(-n_test // 256)
        md_ops.reset_launches()
        hist = run.run(ds, rounds=SYNC_ROUNDS)
        torch.cuda.synchronize()
        n = dict(md_ops.LAUNCHES)
        say(f"[sync] {strategy}: kernel launches {n} (expected mdlora_matmul "
            f"{want} = {SYNC_ROUNDS} rounds x {fed.local_epochs} epochs x "
            f"{fed.steps_per_epoch} steps, one batched call for the 8 "
            f"clients, + {-(-n_test // 256)} evaluation batches of "
            f"{n_test} windows)")
        if n["mdlora_matmul"] != want or n["mdlora_matmul_multi"]:
            fail(f"sync {strategy} did not launch the fused kernel as its "
                 "path requires")
        total += n["mdlora_matmul"]
        if not all(math.isfinite(v) for v in hist["loss"]) or not \
                0.0 <= hist["f1"][-1] <= 1.0:
            fail(f"sync {strategy}: loss {hist['loss']}, F1 {hist['f1']}")
        say(f"[sync] {strategy} on PAMAP2_B2 FULL (G={run.task.layout.G} "
            f"groups, fusion a {tuple(run.state.trainable['lora']['fusion']['a'].shape)}"
            f"), fleet N={run.fleet.N}, dropout {fed.dropout_prob}: host wall"
            f" per round " + ", ".join(f"{w:.3f}" for w in walls) + " s "
            f"(after synchronize); simulated round time "
            + ", ".join(f"{v:.4f}" for v in hist["round_time_s"])
            + " s, energy " + ", ".join(f"{v:.2f}" for v in hist["energy_j"])
            + " J, upload " + ", ".join(f"{v:.4f}" for v in hist["upload_mb"])
            + " MB, selected " + ", ".join(
                f"{v:.3f}" for v in hist["selected_frac"])
            + f"; losses {[round(v, 4) for v in hist['loss']]}, macro-F1 "
            f"{hist['f1'][-1]:.4f} after {SYNC_ROUNDS} rounds")
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          PROFILE_SYNC], capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        fail(f"the profiled sync round failed ({res.returncode}):\n"
             f"{res.stderr[-4000:]}")
    for line in res.stdout.splitlines():
        if line.startswith("[profile]"):
            say(line)
    return total


# -- phase 16 ---------------------------------------------------------------


def sync_check(torch, md_ops, train_relief_har, tree_map) -> None:
    """One PAMAP2_B2_SMALL relief round card vs CPU (same seed and weights),
    then PAMAP2_B2 FULL logits card vs CPU."""
    from repro_torch.tree import leaves_with_path, map_with_path

    out = {}
    for dev in ("cuda", "cpu"):
        run, ds = train_relief_har.build(small=True, device=dev)
        md_ops.reset_launches()
        rec = run.round(ds)
        out[dev] = (rec["loss"], run.state.dbar.copy(),
                    {k: v.cpu() for k, v in
                     leaves_with_path(run.state.trainable)},
                    md_ops.LAUNCHES["mdlora_matmul"])
    (lc, dc, tc, nc), (lp, dp, tp, _) = out["cuda"], out["cpu"]
    err = max((tc[k] - tp[k]).abs().max().item() for k in tp)
    derr = float(abs(dc - dp).max() / abs(dp).max())
    say(f"[check] PAMAP2_B2_SMALL relief round card vs CPU: trainable max "
        f"abs err {err:.2e} (atol 1e-4), dbar max rel err {derr:.2e} (rtol "
        f"1e-4), loss {lc:.6f} vs {lp:.6f}; card launches mdlora_matmul {nc}")
    if nc == 0 or err > 1e-4 or derr > 1e-4 or abs(lc - lp) > 1e-4 * abs(lp):
        fail("the sync round on the card disagrees with the CPU's")
    from repro_torch.configs.relief_har import PAMAP2_B2
    from repro_torch.core.tasks import MMTask
    from repro_torch.models.multimodal import mm_forward

    task, tr = MMTask.create(PAMAP2_B2, torch.Generator().manual_seed(0),
                             device="cpu")
    g = torch.Generator().manual_seed(1)
    tr = map_with_path(  # LoRA b is 0 at init: give every adapter a term
        lambda p, t: t + 0.05 * torch.randn(t.shape, generator=g)
        if p.endswith("['b']") else t, tr)
    x = torch.randn((64, PAMAP2_B2.window, PAMAP2_B2.total_channels),
                    generator=g)
    mm = torch.tensor([[1.0, 1.0, 0.0, 1.0]])
    cpu = task.params(tr)
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    md_ops.reset_launches()
    lg = mm_forward(gpu, PAMAP2_B2, x.to("cuda"), mm.to("cuda")).cpu()
    n = md_ops.LAUNCHES["mdlora_matmul"]
    lc_ = mm_forward(cpu, PAMAP2_B2, x, mm)
    err = (lg - lc_).abs().max().item()
    say(f"[check] PAMAP2_B2 FULL logits (64 windows, mag absent) card vs "
        f"CPU: max abs err {err:.2e} (atol {CHECK_ATOL}); card launches "
        f"mdlora_matmul {n}")
    if n != 1 or err > CHECK_ATOL:
        fail("PAMAP2_B2 FULL logits on the card differ from the CPU's")


# -- phases 17-20 -----------------------------------------------------------

ASYNC_UPDATES = 12  # absorbed client updates per async run (3 flushes)
# one sign-flipping attacker among the three mag holders (the full tier),
# 10% of its cycles dropped and 10% stalled
PHASE_FAULTS = dict(byzantine_frac=1 / 3, corruption="sign_flip",
                    target_modality=3, dropout_prob=0.1, stall_prob=0.1)
FLEET_N, FLEET_K, FLEET_FLUSHES = 10_000, 64, 4


def _eval_batches(ds) -> int:
    return -(-sum(len(y) for y in ds.test_y) // 256)


def _run_async(torch, run, ds, updates, names=("_dispatch", "_flush")):
    """Run ``updates`` absorbed updates with synchronized dispatch and flush
    timers -> (history, host wall s, {phase: [s, calls, clients]})."""
    spent = _time_phases(torch, run, names)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = run.run(ds, total_updates=updates)
    torch.cuda.synchronize()
    return hist, time.perf_counter() - t0, spent


def _say_async(tag, run, hist, wall, spent) -> None:
    (d_s, d_n, d_k), (f_s, f_n, _) = spent["_dispatch"], spent["_flush"]
    say(f"[{tag}] {run.state.round} flushes, {run.trace.completions} updates,"
        f" simulated {run.state.sim_time:.4f}s, host wall {wall:.2f}s: "
        f"dispatch {d_s:.3f}s over {d_n} calls / {d_k} clients "
        f"({d_s / max(d_k, 1) * 1e3:.1f} ms per client update, "
        f"{d_s / max(d_n, 1) * 1e3:.1f} ms per call of 20 steps), flush "
        f"{f_s * 1e3:.1f} ms over {f_n} ({f_s / max(f_n, 1) * 1e3:.2f} ms "
        f"each); losses {[round(v, 4) for v in hist['loss']]}, macro-F1 "
        f"{[round(v, 4) for v in hist['f1']]}")
    if not all(math.isfinite(v) for v in hist["loss"]):
        fail(f"{tag}: non-finite loss {hist['loss']}")


def async_b2(torch, ops, md_ops, train_async_har) -> dict:
    """Phase 17: AsyncFedRun on PAMAP2 B2 FULL, both uplinks."""
    run, ds = train_async_har.build(backbone="b2", device="cuda")
    t0 = time.perf_counter()
    run.run(ds, total_updates=4)
    torch.cuda.synchronize()
    say(f"[async b2] cold start: first flush {time.perf_counter() - t0:.2f}s "
        f"host wall; G={run.task.layout.G} groups, fusion a "
        f"{tuple(run.state.trainable['lora']['fusion']['a'].shape)}")
    launches = {"agg": 0, "quant": 0, "mdlora": 0}
    for codec in ("none", "int8"):
        run, ds = train_async_har.build(backbone="b2", codec=codec,
                                        device="cuda")
        ops.reset_launches()
        md_ops.reset_launches()
        hist, wall, spent = _run_async(torch, run, ds, ASYNC_UPDATES)
        n = {**ops.LAUNCHES, **md_ops.LAUNCHES}
        _say_async(f"async b2 codec={codec}", run, hist, wall, spent)
        steps = run.fed.local_epochs * run.fed.steps_per_epoch
        want = spent["_dispatch"][1] * steps + _eval_batches(ds)
        flushes = run.state.round
        say(f"[async b2] codec={codec} launches {n} (expected "
            f"{'cohort_agg_divergence_quant' if codec == 'int8' else 'cohort_agg_divergence'}"
            f" {flushes} = the flushes; mdlora_matmul {want} = "
            f"{spent['_dispatch'][1]} dispatch calls x {steps} steps + "
            f"{_eval_batches(ds)} evaluation batches)")
        agg, other = ((n["cohort_agg_divergence_quant"],
                       n["cohort_agg_divergence"]) if codec == "int8" else
                      (n["cohort_agg_divergence"],
                       n["cohort_agg_divergence_quant"]))
        if (agg != flushes or other or n["mdlora_matmul"] != want
                or n["mdlora_matmul_multi"]):
            fail(f"async b2 codec={codec} did not launch the kernels its "
                 "path requires")
        launches["quant" if codec == "int8" else "agg"] += agg
        launches["mdlora"] += n["mdlora_matmul"]
    return launches


def _dropped(run) -> int:
    """Dispatched cycles that were neither absorbed nor still in flight."""
    return int(run.fx.tickets.sum()) - run.trace.completions - len(run.queue)


def robust_path(torch, ops, md_ops, train_async_har, FaultModel) -> dict:
    """Phase 18: the robust reducers under faults on B2 FULL."""
    import numpy as np

    launches = {"agg": 0, "mdlora": 0}
    for strategy, codec in (("relief_trimmed", "none"),
                            ("relief_median", "none"),
                            ("relief_krum", "none"), ("relief_krum", "int8")):
        run, ds = train_async_har.build(
            backbone="b2", codec=codec, device="cuda", strategy=strategy,
            faults=FaultModel(**PHASE_FAULTS))
        ops.reset_launches()
        md_ops.reset_launches()
        hist, wall, spent = _run_async(torch, run, ds, ASYNC_UPDATES)
        tag = f"robust {strategy} codec={codec}"
        _say_async(tag, run, hist, wall, spent)
        n = {**ops.LAUNCHES, **md_ops.LAUNCHES}
        say(f"[robust] {strategy} codec={codec}: attacker "
            f"{np.nonzero(run.fx.byz)[0].tolist()}, "
            f"{_dropped(run)} dropped cycles, {run.state.round} flushes, "
            f"launches {n} (one fp32 aggregation per flush: a robust int8 "
            "flush dequantizes first)")
        if (n["cohort_agg_divergence"] != run.state.round
                or n["cohort_agg_divergence_quant"] or run.state.round < 1):
            fail(f"{tag}: aggregation launches {n} over "
                 f"{run.state.round} flushes")
        launches["agg"] += n["cohort_agg_divergence"]
        launches["mdlora"] += n["mdlora_matmul"]
    return launches


def fleet_path(torch, ops, md_ops, train_async_har, async_engine, sim
               ) -> dict:
    """Phase 19: (a) the vectorized runtime against the heap one on the
    card; (b) cohort gradients at fleet scale."""
    import numpy as np

    launches = {"agg": 0, "quant": 0, "mdlora": 0}
    heap, ds = train_async_har.build(backbone="b2", device="cuda")
    tr0 = heap.state.trainable
    vec = async_engine.VectorizedAsyncFedRun.create(
        heap.task, tr0, heap.strategy, heap.fleet,
        dataclasses.replace(heap.fed, grad_mode="dispatch"))
    hists = {}
    for tag, run, names in (("heap", heap, ("_dispatch", "_flush")),
                            ("vectorized", vec,
                             ("_dispatch_vec", "_flush_vec"))):
        ops.reset_launches()
        md_ops.reset_launches()
        hist, wall, spent = _run_async(torch, run, ds, ASYNC_UPDATES, names)
        _say_async(f"fleet {tag}", run, hist, wall, spent)
        hists[tag] = hist
        n = {**ops.LAUNCHES, **md_ops.LAUNCHES}
        if n["cohort_agg_divergence"] != run.state.round:
            fail(f"fleet {tag}: {n} launches over {run.state.round} flushes")
        launches["agg"] += n["cohort_agg_divergence"]
        launches["mdlora"] += n["mdlora_matmul"]
    h0, h1 = hists["heap"], hists["vectorized"]
    same = all(h0[k] == h1[k] for k in ("flush", "sim_time_s",
                                        "staleness_mean", "selected_frac"))
    rel = max(abs(a - b) / abs(a) for a, b in zip(h0["loss"], h1["loss"]))
    say(f"[fleet] heap vs vectorized (dispatch) on the card: flush, "
        f"sim_time_s, staleness_mean, selected_frac equal: {same}; loss max "
        f"rel err {rel:.2e} (rtol 1e-4)")
    if not same or rel > 1e-4:
        fail("the vectorized runtime's history differs from the heap's")

    fleet = sim.scale_fleet(sim.make_fleet(3, 3, 2, M=4), FLEET_N,
                            np.random.default_rng([0, 0x5CA1E]))
    for codec in ("none", "int8"):
        fed = dataclasses.replace(
            heap.fed, grad_mode="cohort", uplink_codec=codec,
            snapshot_ring=8, churn_rate=0.01, arrival_rate=0.02,
            jitter_sigma=0.1)
        run = async_engine.VectorizedAsyncFedRun.create(
            heap.task, tr0,
            dataclasses.replace(heap.strategy, buffer_size=FLEET_K), fleet,
            fed)
        ops.reset_launches()
        md_ops.reset_launches()
        hist, wall, spent = _run_async(torch, run, ds,
                                       FLEET_K * FLEET_FLUSHES,
                                       ("_dispatch_vec", "_flush_vec"))
        n = {**ops.LAUNCHES, **md_ops.LAUNCHES}
        f_s, f_n, _ = spent["_flush"]
        d_s, d_n, _ = spent["_dispatch"]
        name = ("cohort_agg_divergence_quant" if codec == "int8"
                else "cohort_agg_divergence")
        say(f"[fleet] cohort N={FLEET_N} K={FLEET_K} codec={codec}: "
            f"{run.state.round} flushes in host wall {wall:.2f}s, "
            f"{f_s / max(f_n, 1) * 1e3:.1f} ms per flush ({FLEET_K} clients"
            f" x 20 steps + the aggregation), dispatch {d_s:.3f}s over "
            f"{d_n} calls; simulated "
            f"{run.state.sim_time:.4f}s, staleness "
            f"{[round(v, 2) for v in hist['staleness_mean']]}, ring clamped "
            f"{run.ring_clamped}, alive {int(run.fstate.alive.sum())}; "
            f"losses {[round(v, 4) for v in hist['loss']]}; launches {n}")
        if (run.state.round != FLEET_FLUSHES or n[name] != FLEET_FLUSHES
                or not all(math.isfinite(v) for v in hist["loss"])):
            fail(f"fleet cohort codec={codec}: {run.state.round} flushes, "
                 f"launches {n}, losses {hist['loss']}")
        launches["quant" if codec == "int8" else "agg"] += n[name]
        launches["mdlora"] += n["mdlora_matmul"]
    return launches


def _record_scales(run) -> list:
    """Wrap an int8 run's flush so each flush's per-leaf largest dequant
    scale (one int8 step of that leaf) is kept."""
    from repro_torch.tree import leaves_with_path

    log, inner = [], run._flush_arrays

    def wrapped(deltas, *args, **kw):
        log.append({k: v.max().item()
                    for k, v in leaves_with_path(deltas.scales)})
        return inner(deltas, *args, **kw)

    run._flush_arrays = wrapped
    return log


def async_check(torch, train_async_har, FaultModel) -> None:
    """Phase 20: PAMAP2_B2_SMALL, 2 flushes, card against CPU from the same
    seed and weights. fp32: trainable to atol 1e-4. int8: the clients'
    deltas differ in their last bits (3xTF32 on the card), so a code whose
    x/scale lies that close to k + 1/2 rounds the other way: each leaf is
    held to 1e-4 plus one int8 step of that leaf per flush (the largest
    dequant scale of the flush), and the elements beyond 1e-4 are counted."""
    from repro_torch.tree import leaves_with_path

    for strategy, codec, faults in (
            ("async_relief", "none", None), ("async_relief", "int8", None),
            ("relief_krum", "none", PHASE_FAULTS)):
        out = {}
        for dev in ("cuda", "cpu"):
            run, ds = train_async_har.build(
                backbone="b2", small=True, codec=codec, device=dev,
                strategy=strategy,
                faults=FaultModel(**faults) if faults else None)
            scales = _record_scales(run) if codec == "int8" else []
            hist = run.run(ds, total_updates=8)
            out[dev] = (hist, {k: v.cpu() for k, v in
                               leaves_with_path(run.state.trainable)},
                        scales)
        (hc, tc, sc), (hp, tp, _) = out["cuda"], out["cpu"]
        bound = {k: 1e-4 + sum(f[k] for f in sc) for k in tp}
        errs = {k: (tc[k] - tp[k]).abs() for k in tp}
        err = max(e.max().item() for e in errs.values())
        over = sum(int((e > 1e-4).sum()) for e in errs.values())
        bad = [k for k in tp if errs[k].max().item() > bound[k]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(hc["loss"],
                                                      hp["loss"]))
        same = all(hc[k] == hp[k] for k in ("flush", "sim_time_s",
                                            "staleness_mean"))
        say(f"[check] PAMAP2_B2_SMALL {strategy} codec={codec}"
            f"{' under faults' if faults else ''}: card vs CPU after "
            f"{len(hc['flush'])} flushes: trainable max abs err {err:.2e} "
            + (f"({over} of {sum(e.numel() for e in errs.values())} "
               f"elements beyond 1e-4, each leaf within 1e-4 + one int8 "
               f"step per flush, the largest step {max(bound.values()) - 1e-4:.2e})"
               if codec == "int8" else "(atol 1e-4)")
            + f", loss rel err {rel:.2e} (rtol 1e-4), histories equal: "
            f"{same}")
        if len(hc["flush"]) != 2 or not same or bad or rel > 1e-4:
            fail(f"async {strategy} codec={codec} on the card disagrees "
                 f"with the CPU: {bad}")


# -- phases 21-23 -----------------------------------------------------------

SCENARIO_UPDATES = 8  # absorbed client updates per scenario run (2 flushes)
TABLE_ROUNDS = 3


def _scenario_run(sim, name, strategy, codec="none", vectorized=False,
                  **kw):
    """``sim.make_run`` for a library scenario at PAMAP2 B2 FULL width (the
    spec's default training: E=5 x 4 steps of batch 32, K=4)."""
    spec = sim.get_scenario(name, strategy=strategy, backbone="transformer",
                            small_model=False, uplink_codec=codec,
                            total_updates=SCENARIO_UPDATES, **kw)
    return sim.make_run(spec, vectorized, device="cuda")


def scenarios_path(torch, ops, md_ops, sim) -> dict:
    """Phase 21: missing-modality scenarios, live masks and selective
    upload on B2 FULL through kernels 1-3."""
    launches = {"agg": 0, "quant": 0, "mdlora": 0}
    runs = {}
    for tag, name, strategy, codec, vec, kw in (
            ("static30 async_relief", "static30", "async_relief", "none",
             False, {}),
            ("static30 relief_selective", "static30", "relief_selective",
             "int8", False, dict(strategy_args=(("comm_budget", 0.5),))),
            ("stream30 async_accessible", "stream30", "async_accessible",
             "none", False, {}),
            ("stream30 fedmfs_selective", "stream30", "fedmfs_selective",
             "none", False, dict(strategy_args=(("comm_budget", 0.5),))),
            ("stream30 async_relief heap", "stream30", "async_relief",
             "none", False, {}),
            ("stream30 async_relief vectorized", "stream30", "async_relief",
             "none", True, dict(grad_mode="dispatch"))):
        run, sc = _scenario_run(sim, name, strategy, codec, vec, **kw)
        names = (("_dispatch_vec", "_flush_vec") if vec
                 else ("_dispatch", "_flush"))
        ops.reset_launches()
        md_ops.reset_launches()
        hist, wall, spent = _run_async(torch, run, sc.dataset,
                                       SCENARIO_UPDATES, names)
        n = {**ops.LAUNCHES, **md_ops.LAUNCHES}
        _say_async(f"scenarios {tag}", run, hist, wall, spent)
        steps = run.fed.local_epochs * run.fed.steps_per_epoch
        want = spent["_dispatch"][1] * steps + _eval_batches(sc.dataset)
        flushes = run.state.round
        key, other = (("cohort_agg_divergence_quant", "cohort_agg_divergence")
                      if codec == "int8" else
                      ("cohort_agg_divergence", "cohort_agg_divergence_quant"))
        say(f"[scenarios] {tag} codec={codec}: {run.trace.completions} "
            f"updates, upload {run.trace.upload_mb:.6f} MB, selected "
            f"{[round(v, 4) for v in hist['selected_frac']]}, launches {n} "
            f"(expected {key} {flushes} = the flushes; mdlora_matmul {want} "
            f"= {spent['_dispatch'][1]} dispatch calls x {steps} steps + "
            f"{_eval_batches(sc.dataset)} evaluation batches)")
        if (flushes != 2 or n[key] != flushes or n[other]
                or n["mdlora_matmul"] != want or n["mdlora_matmul_multi"]):
            fail(f"scenarios {tag} did not launch the kernels its path "
                 "requires")
        launches["quant" if codec == "int8" else "agg"] += n[key]
        launches["mdlora"] += n["mdlora_matmul"]
        runs[tag] = (run, hist)
    (twin, _), (sel, _) = (runs["stream30 async_accessible"],
                           runs["stream30 fedmfs_selective"])
    ratio = sel.trace.upload_mb / twin.trace.upload_mb
    say(f"[scenarios] stream30 fedmfs_selective vs its twin "
        f"async_accessible: completions {sel.trace.completions} vs "
        f"{twin.trace.completions}, upload {ratio:.4f} of the twin's bytes "
        f"(limit 0.75), simulated {sel.state.sim_time:.4f} vs "
        f"{twin.state.sim_time:.4f}s")
    if sel.trace.completions != twin.trace.completions or ratio >= 0.75:
        fail("selective upload did not cut the twin's upload bytes")
    (_, h0), (_, h1) = (runs["stream30 async_relief heap"],
                        runs["stream30 async_relief vectorized"])
    same = all(h0[k] == h1[k] for k in ("flush", "staleness_mean",
                                        "selected_frac", "sim_time_s"))
    # the vectorized trace adds a timestamp group's uploads in one sum
    up = max(abs(a - b) / abs(a) for a, b in zip(h0["upload_mb"],
                                                 h1["upload_mb"]))
    rel = max(abs(a - b) / abs(a) for a, b in zip(h0["loss"], h1["loss"]))
    say(f"[scenarios] stream30 heap vs vectorized (dispatch): flush, "
        f"staleness_mean, selected_frac, sim_time_s equal: {same}; upload_mb"
        f" max rel err {up:.1e} (rtol 1e-9); loss max rel err {rel:.2e} "
        f"(rtol 1e-4)")
    if not same or up > 1e-9 or rel > 1e-4:
        fail("the vectorized runtime's stream30 history differs from the "
             "heap's")
    return launches


def experiments_path(torch, md_ops, experiments, get_provider) -> int:
    """Phase 22: Table II on PAMAP2 B2 FULL, fedavg and relief."""
    md_ops.reset_launches()
    t0 = time.perf_counter()
    rows = experiments.main_table("b2", TABLE_ROUNDS,
                                  methods=["fedavg", "relief"],
                                  datasets=("pamap2",), small=False,
                                  device="cuda", cache_dir=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = dict(md_ops.LAUNCHES)
    spec = experiments.BenchSpec("relief", "pamap2", "b2", TABLE_ROUNDS,
                                 small=False)
    ds = get_provider("pamap2").build(seed=spec.seed, n_clients=8,
                                      windows_per_subject=spec.windows)
    batches = _eval_batches(ds)
    every = max(TABLE_ROUNDS // 10, 1)  # FedRun.run's evaluation rounds
    evals = sum((r + 1) % every == 0 or r == TABLE_ROUNDS - 1
                for r in range(TABLE_ROUNDS))
    per_run = TABLE_ROUNDS * 20 + (evals + 4) * batches
    for r in rows:
        say(f"[experiments] {r['method']} on {r['dataset']} B2 FULL, "
            f"{TABLE_ROUNDS} rounds (synthetic data): F1 {r['f1']:.4f}, rare "
            f"F1 {r['rare_mod_f1']:.4f}, speedup {r['speedup']:.3f}x, TTA "
            f"{r['tta_rounds']}, {r['comm_mb']:.4f} MB/r, "
            f"{r['energy_j']:.2f} J/r, Esave {r['energy_save_pct']:.2f}%; "
            f"host {r['host_wall_s']:.2f}s on {r['device']}")
    say(f"[experiments] host wall {wall:.2f}s; launches {n} (expected "
        f"mdlora_matmul {2 * per_run} = 2 runs x ({TABLE_ROUNDS} rounds x "
        f"20 steps + ({evals} evaluations + 4 per-modality) x {batches} "
        "batches))")
    if n["mdlora_matmul"] != 2 * per_run or n["mdlora_matmul_multi"]:
        fail("the experiment runner did not launch the fused kernel as its "
             "path requires")
    if not all(0.0 <= r["f1"] <= 1.0 and 0.0 <= r["rare_mod_f1"] <= 1.0
               for r in rows) or rows[0]["speedup"] != 1.0:
        fail(f"experiments: bad table rows {rows}")
    return n["mdlora_matmul"]


def scenario_check(torch, sim, async_engine) -> None:
    """Phase 23: stream30 x fedmfs_selective on PAMAP2_B2_SMALL, fp32, 2
    flushes, card against CPU: S_up rows and histories equal, losses to
    rtol 1e-4, trainable to atol 1e-4."""
    from repro_torch.tree import leaves_with_path

    out = {}
    orig = async_engine._selective_upload
    for dev in ("cuda", "cpu"):
        ups = []

        def record(*a, _ups=ups, **k):
            _ups.append(orig(*a, **k))
            return _ups[-1]

        async_engine._selective_upload = record
        try:
            spec = sim.get_scenario(
                "stream30", strategy="fedmfs_selective",
                backbone="transformer", small_model=True,
                total_updates=SCENARIO_UPDATES)
            run, sc = sim.make_run(spec, device=dev)
            hist = run.run(sc.dataset)
        finally:
            async_engine._selective_upload = orig
        out[dev] = (hist, ups, {k: v.cpu() for k, v in
                                leaves_with_path(run.state.trainable)})
    (hc, uc, tc), (hp, up, tp) = out["cuda"], out["cpu"]
    same_up = len(uc) == len(up) > 0 and all(
        (a == b).all() for a, b in zip(uc, up))
    same = all(hc[k] == hp[k] for k in ("flush", "staleness_mean",
                                        "selected_frac", "sim_time_s",
                                        "upload_mb"))
    err = max((tc[k] - tp[k]).abs().max().item() for k in tp)
    rel = max(abs(a - b) / abs(b) for a, b in zip(hc["loss"], hp["loss"]))
    say(f"[check] PAMAP2_B2_SMALL stream30 fedmfs_selective card vs CPU "
        f"after {len(hc['flush'])} flushes: S_up rows of {len(uc)} "
        f"dispatches equal: {same_up}; histories equal: {same}; trainable "
        f"max abs err {err:.2e} (atol 1e-4), loss rel err {rel:.2e} (rtol "
        "1e-4)")
    if len(hc["flush"]) != 2 or not same_up or not same or err > 1e-4 \
            or rel > 1e-4:
        fail("stream30 fedmfs_selective on the card disagrees with the CPU")


# -- phases 24-26 -----------------------------------------------------------

PAPER_ROUNDS = 2  # rounds per run of Table III and Fig. 8 (phase 24)
MOTIVATION_ROUNDS = 3  # instrumented FedAvg rounds of Figs. 2-3 (phase 25)


def _run_launches(get_provider, spec) -> int:
    """Fused-projection launches of one ``run_spec`` run: rounds x E x
    steps, and (evaluations + one per modality) x evaluation batches."""
    provider = get_provider(spec.dataset)
    ds = provider.build(seed=spec.seed, n_clients=8 if spec.dataset ==
                        "pamap2" else 10, windows_per_subject=spec.windows)
    every = max(spec.rounds // 10, 1)  # FedRun.run's evaluation rounds
    evals = sum((r + 1) % every == 0 or r == spec.rounds - 1
                for r in range(spec.rounds))
    modalities = provider.mm_config("transformer").M
    return spec.rounds * 20 + (evals + modalities) * _eval_batches(ds)


def paper_path(torch, ops, md_ops, experiments, get_provider) -> int:
    """Phase 24: Table III on PAMAP2 B2 FULL (fedavg, relief, v1-v3) and
    Fig. 8 on MHEALTH B2 FULL (fedavg and relief under both timing models),
    ``PAPER_ROUNDS`` rounds per run, nothing cached."""
    total = 0
    for tag, fn, kw, specs in (
            ("ablation", experiments.ablation,
             dict(backbones=("b2",), datasets=("pamap2",)),
             [experiments.BenchSpec(m, "pamap2", "b2", PAPER_ROUNDS,
                                    small=False)
              for m in ["fedavg"] + experiments.ABLATION_VARIANTS]),
            ("device-profile", experiments.device_profile,
             dict(backbones=("b2",)),
             [experiments.BenchSpec(m, "mhealth", "b2", PAPER_ROUNDS,
                                    sim_mode=mode, small=False)
              for mode in ("flop_proportional", "fwd_aware")
              for m in ("fedavg", "relief")])):
        ops.reset_launches()
        md_ops.reset_launches()
        t0 = time.perf_counter()
        out = fn(PAPER_ROUNDS, small=False, device="cuda", cache_dir=None,
                 out_dir=None, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {**ops.LAUNCHES, **md_ops.LAUNCHES}
        want = sum(_run_launches(get_provider, s) for s in specs)
        rows = out if isinstance(out, list) else [
            {"backbone": b, **{k: v for k, v in r.items()
                               if not k.endswith("_f1_at_energy")}}
            for b, r in out.items()]
        for r in rows:
            say(f"[paper] {tag} B2 FULL, {PAPER_ROUNDS} rounds (synthetic "
                f"data): " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in r.items()))
        say(f"[paper] {tag}: {len(specs)} runs, host wall {wall:.2f}s "
            f"({wall / (len(specs) * PAPER_ROUNDS):.3f} s per round with "
            f"its evaluations); launches {n} (expected mdlora_matmul {want} "
            f"= per run {PAPER_ROUNDS} rounds x 20 steps + ({PAPER_ROUNDS} "
            "evaluations + 4 per-modality) x evaluation batches; kernels 1, "
            "2 and 4 none)")
        if (n["mdlora_matmul"] != want or n["mdlora_matmul_multi"]
                or n["cohort_agg_divergence"]
                or n["cohort_agg_divergence_quant"]):
            fail(f"{tag} did not launch the kernels its path requires")
        if isinstance(out, list):
            bad = [r for r in out if not (0.0 <= r["f1_pamap2"] <= 1.0
                                          and r["speedup"] > 0)]
        else:
            bad = [b for b, r in out.items() if not (
                r["sim_speedup_flop_proportional"] > 0
                and r["speedup_fwd_aware"] > 0
                and math.isfinite(r["energy_save_pct_fwd_aware"]))]
        if bad:
            fail(f"{tag}: bad rows {bad}")
        total += n["mdlora_matmul"]
    return total


def motivation_path(torch, ops, md_ops, experiments) -> int:
    """Phase 25: Figs. 2-3's instrumented FedAvg on PAMAP2 FULL,
    ``MOTIVATION_ROUNDS`` rounds: Backbone 1 (the script's model; its
    fusion is the full-parameter blocked weight, a cuBLAS product, so the
    fused kernel does not run) and Backbone 2 (the fused kernel in both
    local updates of each round)."""
    total = 0
    for backbone in ("b1", "b2"):
        ops.reset_launches()
        md_ops.reset_launches()
        out = experiments.motivation(MOTIVATION_ROUNDS, backbone=backbone,
                                     small=False, device="cuda",
                                     cache_dir=None)
        torch.cuda.synchronize()
        n = {**ops.LAUNCHES, **md_ops.LAUNCHES}
        want = MOTIVATION_ROUNDS * 2 * 8 if backbone == "b2" else 0
        fig2, fig3 = out["fig2_block_cosine"], out["fig3_divergence_phases"]
        for pt, blocks in fig2.items():
            say(f"[motivation] {backbone} FULL Fig. 2 {pt}: " + ", ".join(
                f"{b} {v:.4f}" for b, v in blocks.items()))
        for blk, vals in fig3.items():
            say(f"[motivation] {backbone} FULL Fig. 3 {blk} by phase: "
                + ", ".join(f"{v:.6f}" for v in vals))
        say(f"[motivation] {backbone} FULL: Mag/Acc "
            f"{[round(v, 4) for v in out['obs2_rare_to_common_ratio']]}; "
            f"host {out['host_wall_s']:.2f}s for {MOTIVATION_ROUNDS} rounds "
            f"on {out['device']}; launches {n} (expected mdlora_matmul "
            f"{want} = {MOTIVATION_ROUNDS} rounds x 2 local updates x 8 "
            "steps" + (")" if backbone == "b2" else
                       ": Backbone 1 has no fusion LoRA)"))
        cos = [v for blocks in fig2.values() for v in blocks.values()]
        if not all(math.isfinite(v) and -1.0 <= v <= 1.0 for v in cos) or \
                len(fig3) != 4 or any(len(v) != min(5, MOTIVATION_ROUNDS)
                                      for v in fig3.values()):
            fail(f"motivation {backbone}: bad figures {out}")
        if (n["mdlora_matmul"] != want or n["mdlora_matmul_multi"]
                or n["cohort_agg_divergence"]
                or n["cohort_agg_divergence_quant"]):
            fail(f"motivation {backbone} did not launch the kernels its "
                 "path requires")
        total += n["mdlora_matmul"]
    return total


def checkpoint_path(torch, md_ops, train_relief_har, checkpoint) -> int:
    """Phase 26: ``train_relief_har``'s run on PAMAP2 B2 FULL saved at round
    2, a fresh run resumed from it (trainable and dbar bitwise, on the card
    and onto the CPU), one more round, and a leftover temp directory that
    ``latest_step()`` ignores."""
    import numpy as np
    from repro_torch.tree import leaves_with_path, tree_map

    with tempfile.TemporaryDirectory() as d:
        ckpt = checkpoint.CheckpointManager(d, keep=2)
        run, ds = train_relief_har.build(device="cuda")
        batches = _eval_batches(ds)
        md_ops.reset_launches()
        t0 = time.perf_counter()
        train_relief_har.train(run, ds, 2, ckpt=ckpt, ckpt_every=2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        saved = {p: t.clone() for p, t in
                 leaves_with_path(run.state.trainable)}
        dbar = run.state.dbar.copy()
        run, _ = train_relief_har.build(device="cuda")
        start = train_relief_har.resume(run, ckpt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        same = start == 2 and np.array_equal(run.state.dbar, dbar) and all(
            t.device.type == "cuda" and torch.equal(t, saved[p])
            for p, t in leaves_with_path(run.state.trainable))
        host, meta = ckpt.restore(2, {"trainable": tree_map(
            lambda t: t.cpu(), run.state.trainable)})
        same_cpu = np.array_equal(np.asarray(meta["dbar"]), dbar) and all(
            t.device.type == "cpu" and torch.equal(t, saved[p].cpu())
            for p, t in leaves_with_path(host["trainable"]))
        hist = train_relief_har.train(run, ds, 3, start, ckpt, 2)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        n = md_ops.LAUNCHES["mdlora_matmul"]
        want = 3 * 20 + 2 * batches
        leftover = Path(d) / "step_00000003.tmp.1.2"
        leftover.mkdir()
        (leftover / "manifest.json").write_text("{}")
        latest = ckpt.latest_step()
        mb = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
        say(f"[checkpoint] PAMAP2 B2 FULL relief: 2 rounds + save "
            f"{t1 - t0:.2f}s, build + resume {t2 - t1:.2f}s, round 3 "
            f"{t3 - t2:.2f}s host wall; resumed at round {start}, trainable "
            f"and dbar bitwise equal on the card: {same}, restored onto the "
            f"CPU: {same_cpu}; round 3 loss {hist['loss'][-1]:.4f}, F1 "
            f"{hist['f1'][-1]:.4f}; latest_step() {latest} beside a "
            f"leftover {leftover.name}/; {mb / 2**20:.3f} MiB on disk; "
            f"launches mdlora_matmul {n} (expected {want} = 3 rounds x 20 "
            f"steps + 2 evaluations x {batches} batches)")
        if not (same and same_cpu) or latest != 2 or n != want or \
                not math.isfinite(hist["loss"][-1]):
            fail("the checkpointed sync run did not save, resume and go on "
                 "as it must")
    return n

# -- phases 27-30 -----------------------------------------------------------

# flash attention at the rest of the zoo's layouts, bf16, at the batched
# serve's shapes (B=8, P=512, 32 decode steps: a 544-slot ring; llava B=4,
# 2880 patches + 192 text tokens) and at mixtral's 4096-token window over
# a ring that has wrapped (5000 positions written)
ZOO_FA_CASES = [  # label, B, S, T, K, G, hd, filled, window, softcap, bf16?
    ("mixtral decode", 8, 1, 544, 8, 4, 128, 528, 4096, None, True),
    ("mixtral decode, wrapped ring", 8, 1, 4096, 8, 4, 128, 5000, 4096,
     None, True),
    ("mixtral prefill, wrapped ring", 2, 512, 4096, 8, 4, 128, 5000, 4096,
     None, True),
    # MQA: S*G = 48 > DECODE_ROWS, so a decode call takes the prefill path
    ("granite-34b MQA decode", 8, 1, 544, 1, 48, 128, 528, None, None,
     True),
    ("granite-34b MQA prefill", 8, 512, 544, 1, 48, 128, 512, None, None,
     True),
    ("musicgen MHA decode", 8, 1, 544, 32, 1, 64, 528, None, None, True),
    ("musicgen MHA prefill", 8, 512, 544, 32, 1, 64, 512, None, None, True),
    ("llava prefill", 4, 3072, 3104, 8, 7, 128, 3072, None, None, True),
    ("llava decode", 4, 1, 3104, 8, 7, 128, 3088, None, None, True),
]
# the gathered projection at mixtral's engine shapes (d 4096, 8 KV heads of
# 128: wo's fusion blocks are the 8 head groups of 512) and granite-34b's
# MQA wv (F = 128)
ZOO_MD_CASES = [  # label, B, D, F, A, r, fusion blocks, bf16?
    ("mixtral wq", 16, 4096, 4096, 16, 8, None, True),
    ("mixtral wv", 16, 4096, 1024, 16, 8, None, True),
    ("mixtral wo", 16, 4096, 4096, 16, 8, [512] * 8, True),
    ("granite-34b wv", 16, 6144, 128, 16, 8, None, True),
]
MOE_LAYERS = 20  # of mixtral-8x7b's 32: 58.6 GB of bf16 weights
LLAVA_SERVE = dict(batch=4, prompt_len=192, decode_steps=32)
ZOO_SERVE = [  # arch, layers served (None: all), batched shape
    ("granite-3-8b", None, SERVE),
    ("musicgen-large", None, SERVE),
    ("granite-34b", 20, SERVE),
    ("mixtral-8x22b", 8, SERVE),
    ("llava-next-34b", 30, LLAVA_SERVE),
]


def zoo_kernels(torch, fa_ops, fa_ref, md_ops, md_ref, counts) -> dict:
    torch.cuda.empty_cache()
    return {"flash": check_flash(torch, fa_ops, fa_ref, ZOO_FA_CASES),
            "mdlora": check_mdlora(torch, md_ops, md_ref, counts,
                                   ZOO_MD_CASES)}


def moe_serve(torch, serve, api, kops, cfg) -> tuple[dict, int]:
    """mixtral-8x7b at full width, cut in depth: the batched serve (flash
    attention by path) and the engine (the gathered projection)."""
    say(f"[moe] {cfg.arch}: {cfg.n_layers} of 32 layers (depth cut: the "
        "bf16 weights of all 32 are 93.4 GB), widths as published")
    params = model_params(torch, serve, api, cfg)
    by_path = serve_batched(torch, serve, kops, cfg, params)
    md = serve_engine(torch, serve, kops, cfg, params)
    del params
    torch.cuda.empty_cache()
    return by_path, md


def zoo_serve(torch, serve, api, kops, get_arch) -> dict:
    """``run_batched`` on each of the other new architectures at full
    width: flash attention's calls by path asserted per arch."""
    total = {"fp32": 0, "prefill": 0, "decode": 0}
    for arch, layers, shape in ZOO_SERVE:
        full = get_arch(arch).FULL
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers,
                                  attn_impl="pallas")
        say(f"[zoo] {arch}: {cfg.n_layers} of {full.n_layers} layers"
            + (" (depth cut)" if layers else "") + ", widths as published")
        params = model_params(torch, serve, api, cfg)
        patches = (serve.stub_patches(cfg, shape["batch"], 0, "cuda")
                   if cfg.family == "vlm" else None)
        by = serve_batched(torch, serve, kops, cfg, params, shape, patches)
        for k in total:
            total[k] += by[k]
        del params, patches
        torch.cuda.empty_cache()
    return total


ZOO_NARROW = dict(n_layers=2, d_model=512, n_heads=8, n_kv_heads=2,
                  head_dim=64, d_ff=1792, vocab=2048, dtype="float32",
                  param_dtype="float32", attn_impl="pallas")
ZOO_CHECKS = [  # arch, fields over ZOO_NARROW
    ("granite-3-8b", {}),
    ("granite-34b", dict(n_kv_heads=1)),
    ("mixtral-8x7b", dict(d_ff=1024)),
    ("llava-next-34b", dict(n_patches=64)),
    ("musicgen-large", dict(n_kv_heads=8, vocab=512)),
]
MOE_CHECK = dict(batch=4, seq=512, d=1024, f=2048, experts=8, top_k=2)


def _moe_layer_check(torch, moe) -> None:
    """One fp32 MoE layer at a prefill shape where capacity drops occur,
    card vs CPU from the same weights (TF32 off, phase 1): expert ids, the
    kept (token, expert) assignments and the output."""
    c = MOE_CHECK
    g = torch.Generator().manual_seed(5)
    p = moe.init_moe_mlp(g, c["d"], c["f"], c["experts"], "cpu")
    # a shared component skews the routing, so popular experts overflow
    x = torch.randn((c["batch"], c["seq"], c["d"]), generator=g) \
        + 0.2 * torch.randn(c["d"], generator=g)
    cap = moe.capacity(c["seq"], c["top_k"], c["experts"], 1.25)
    got = {}
    for where in ("cpu", "cuda"):
        pw = {k: v.to(where) for k, v in p.items()}
        _, _, ids = moe.route(pw, x.to(where), c["top_k"])
        _, rank, slot = moe.dispatch(ids, c["experts"], cap)
        out, aux = moe.moe_mlp(pw, x.to(where), top_k=c["top_k"])
        got[where] = (ids.cpu(), slot.cpu(), int((rank >= cap).sum()),
                      out.cpu(), float(aux))
    (ic, sc, dc, oc, ac), (ig, sg, dg, og, ag) = got["cpu"], got["cuda"]
    flips = int((ic != ig).any(-1).sum())
    err = (og - oc).abs().max().item()
    n = c["batch"] * c["seq"] * c["top_k"]
    say(f"[zoo check] one MoE layer (d {c['d']}, f {c['f']}, "
        f"{c['experts']} experts, top-{c['top_k']}, capacity {cap} per "
        f"sequence and expert) at B={c['batch']} S={c['seq']}, fp32: "
        f"{flips} of {c['batch'] * c['seq']} tokens routed differently on "
        f"the card than on the CPU; dropped assignments {dg} (card) / {dc} "
        f"(CPU) of {n}; kept set equal: {torch.equal(sc, sg)}; output max "
        f"abs err {err:.2e} (atol {CHECK_ATOL}); aux {ag:.6f} / {ac:.6f}")
    if dc == 0:
        fail("zoo check: the MoE layer dropped nothing; the check needs "
             "capacity drops")
    if flips or not torch.equal(sc, sg) or err > CHECK_ATOL:
        fail("zoo check: the MoE layer routes or computes differently on "
             "the card")


def zoo_check(torch, serve, api, kops, tree_map, moe, get_arch) -> None:
    """A float32 two-layer model of each new family at a narrow width, on
    the card against the same model on the CPU: batched tokens and prefill
    logits, mixtral's engine tokens; then one MoE layer."""
    bkw = dict(batch=4, prompt_len=40, decode_steps=8, seed=1)
    ekw = dict(n_adapters=4, batch=4, n_requests=10, prompt_len=40,
               min_prompt_len=8, decode_steps=8, seed=1)
    for arch, extra in ZOO_CHECKS:
        cfg = dataclasses.replace(get_arch(arch).FULL, arch=f"{arch}-check",
                                  **{**ZOO_NARROW, **extra})
        cpu = api.init_model(torch.Generator().manual_seed(3), cfg, "cpu")
        gpu = tree_map(lambda t: t.to("cuda"), cpu)
        pc = (serve.stub_patches(cfg, bkw["batch"], 1, "cpu")
              if cfg.family == "vlm" else None)
        _reset_all(kops)
        bg = serve.run_batched(cfg, gpu, device="cuda", **bkw,
                               patches=None if pc is None else pc.cuda())
        engine = cfg.family == "moe"
        if engine:
            eg = serve.run_engine(cfg, gpu, device="cuda", **ekw)
        n = _counts(kops)
        bc = serve.run_batched(cfg, cpu, device="cpu", patches=pc, **bkw)
        err = (bg["prefill_logits"] - bc["prefill_logits"]).abs().max()
        same = bool((bg["tokens"] == bc["tokens"]).all())
        line = (f"[zoo check] {cfg.arch} fp32 (2 layers, d 512, "
                f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV): batched "
                f"prefill logits {tuple(bg['prefill_logits'].shape)} card vs "
                f"CPU max abs err {err.item():.2e} (atol {CHECK_ATOL}), "
                f"tokens {bg['tokens'].shape} equal: {same}")
        if engine:
            ec = serve.run_engine(cfg, cpu, device="cpu", **ekw)
            line += (f"; engine tokens card == CPU: "
                     f"{eg['outputs'] == ec['outputs']} "
                     f"({eg['generated_tokens']} tokens)")
        say(line + f"; card launches flash {n['flash_attention']}, mdlora "
            f"{n['mdlora_matmul_multi']}")
        if n["flash_attention"] == 0 or (engine and
                                         n["mdlora_matmul_multi"] == 0):
            fail(f"zoo check {arch}: the card runs did not go through the "
                 "kernels")
        if err > CHECK_ATOL or not same or (
                engine and eg["outputs"] != ec["outputs"]):
            fail(f"zoo check {arch}: the card differs from the CPU")
    _moe_layer_check(torch, moe)


# -- phases 31-35 -----------------------------------------------------------

# launch/train.py's backbone mode at the reference's defaults (B=8, S=128,
# lr 1e-3, LoRA, the config's remat "dots"), cut to TRAIN_STEPS steps
TRAIN_STEPS = 8
# mamba2-1.3b FULL, every parameter trained: S a multiple of ssd_chunk 64.
# Its step with remat "none" runs at a quarter of the batch: at B=8 it ran
# out of the card's 80 GB (77.8 GB allocated; the plain SSD scan's fp32
# intermediates of 48 layers)
MAMBA_TRAIN = dict(batch=8, seq=512, steps=4, remat_batch=2)
TRAIN_RTOL = 1e-5  # card vs CPU losses, fp32, TF32 off
REMAT_RTOL = 1e-3  # one step with remat "dots" vs "none": the same forward
FEDERATED_ROUNDS = 2


def _bits_fingerprint(torch, tree_leaves) -> list:
    """Per leaf, the int64 sum of its raw 16- or 32-bit words: a change of
    any element's bits moves it (short of a cancelling pair)."""
    out = []
    for t in tree_leaves:
        words = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        out.append(int(words.sum(dtype=torch.int64)))
    return out


def _train_args(train, ckpt_dir, *extra):
    return train.parse_args(["--ckpt-dir", str(ckpt_dir), "--log-every",
                             "1000", *extra])


def _remat_repeat(torch, train, step_fns, bb, args, batch_rows) -> dict:
    """One more step from the run's state with the config's remat and with
    "none", on the same batch (its first ``batch_rows`` rows): the loss and
    the peak memory of each."""
    import argparse

    batch = next(train.token_batches(bb, argparse.Namespace(
        **{**vars(args), "steps": bb.step + 1})))
    batch = {k: v[:batch_rows] for k, v in batch.items()}
    out = {}
    for remat in (bb.cfg.remat, "none"):
        cfg = dataclasses.replace(bb.cfg, remat=remat)
        step = step_fns.make_train_step(cfg, lr=args.lr,
                                        train_mode=args.train_mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss = float(step(bb.params, bb.opt, batch)[2]["loss"])
        torch.cuda.synchronize()
        out[remat] = (loss, torch.cuda.max_memory_allocated(), before,
                      time.perf_counter() - t0)
    return out


def backbone_train(torch, train, step_fns, api, kops, arch, extra, label,
                   remat_batch=None) -> dict:
    """Phases 31-32: ``launch/train.py``'s backbone path on the card:
    per-step loss, ms per step (step 1 apart), tokens/s, peak memory, the
    model-FLOP count (``launch/roofline.py`` ``model_flops``: 4*N*tokens
    LoRA, 6*N*tokens full) over the bf16 peak; finite losses; a frozen
    base bitwise unchanged (lora) and every trainable leaf moved; then one
    step with remat "none" from the same state. -> the peak and the mean
    ms per step, for phase 37."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.roofline import model_flops
    from repro_torch.tree import leaves, leaves_with_path

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        args = _train_args(train, d, "--arch", arch, *extra)
        t0 = time.perf_counter()
        bb, ckpt = train.build_backbone(args)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        state_bytes = torch.cuda.memory_allocated()
        tr, rest = step_fns.split_trainable(bb.params, args.train_mode)
        frozen = leaves(rest)
        frozen_bits = _bits_fingerprint(torch, frozen)
        tr0 = dict(zip((p for p, _ in leaves_with_path(tr)),
                       _bits_fingerprint(torch, leaves(tr))))
        n_base = api.param_count(bb.params["base"])
        n_train = sum(t.numel() for t in leaves(tr))
        del tr
        _reset_all(kops)
        torch.cuda.reset_peak_memory_stats()
        hist = train.train_steps(bb, args, ckpt)
        peak = torch.cuda.max_memory_allocated()
        n = _counts(kops)
        rows = remat_batch or args.batch
        rep = _remat_repeat(torch, train, step_fns, bb, args, rows)
    tokens = args.batch * args.seq
    steady = hist["step_s"][1:]
    mean_s = sum(steady) / len(steady)
    flops = model_flops(bb.cfg, ShapeConfig("train", args.seq, args.batch,
                                            "train"),
                        args.train_mode)["model_flops"]
    tr_now = step_fns.split_trainable(bb.params, args.train_mode)[0]
    moved = [p for (p, _), bits in zip(
        leaves_with_path(tr_now), _bits_fingerprint(torch, leaves(tr_now)))
        if bits != tr0[p]]
    same_frozen = (all(a is b for a, b in zip(leaves(rest), frozen))
                   and _bits_fingerprint(torch, frozen) == frozen_bits)
    say(f"[{label}] {arch} FULL ({bb.cfg.n_layers} layers, d "
        f"{bb.cfg.d_model}, {bb.cfg.param_dtype}), --train-mode "
        f"{args.train_mode}, B={args.batch} S={args.seq}, lr {args.lr}, "
        f"remat {bb.cfg.remat!r}, attn_impl {bb.cfg.attn_impl!r}: "
        f"{n_base / 1e9:.3f} B base parameters, {n_train:,} trainable; "
        f"built in {built:.1f}s; kernel launches in the steps {n} (the "
        f"reference's attn_impl 'xla': the train step reaches no kernel)")
    say(f"[{label}] losses per step: "
        + ", ".join(f"{v:.4f}" for v in hist["loss"])
        + "; grad norms " + ", ".join(f"{v:.3f}" for v in hist["grad_norm"]))
    say(f"[{label}] ms per step (host wall after synchronize): step 1 "
        f"{hist['step_s'][0] * 1e3:.1f}, steps 2-{len(hist['step_s'])} "
        + ", ".join(f"{s * 1e3:.1f}" for s in steady)
        + f" (mean {mean_s * 1e3:.1f}); {tokens / mean_s:.0f} tokens/s; "
        f"peak memory {peak / 1e9:.2f} GB (max_memory_allocated over the "
        f"steps; weights and optimizer state {state_bytes / 1e9:.2f} GB); "
        f"model_flops ({args.train_mode}: "
        f"{flops / n_base / tokens:.0f}*N*tokens) = "
        f"{flops / 1e12:.1f} TFLOP per step, "
        f"{flops / mean_s / BF16_FLOPS_PER_S:.1%} of 989 TFLOP/s "
        f"(its floor {flops / BF16_FLOPS_PER_S * 1e3:.1f} ms)")
    (l_r, p_r, b_r, s_r), (l_n, p_n, b_n, s_n) = \
        rep[bb.cfg.remat], rep["none"]
    rel = abs(l_r - l_n) / abs(l_n)
    say(f"[{label}] one more step from the same state at B={rows}: remat "
        f"{bb.cfg.remat!r} loss {l_r:.6f}, peak {p_r / 1e9:.2f} GB "
        f"({(p_r - b_r) / 1e9:.2f} GB above the state), "
        f"{s_r * 1e3:.1f} ms; remat 'none' loss {l_n:.6f}, peak "
        f"{p_n / 1e9:.2f} GB ({(p_n - b_n) / 1e9:.2f} GB above), "
        f"{s_n * 1e3:.1f} ms; relative difference {rel:.2e} (rtol "
        f"{REMAT_RTOL}); frozen leaves bitwise unchanged: {same_frozen}; "
        f"trainable leaves moved: {len(moved)} of {len(tr0)}")
    if not all(math.isfinite(v) for v in hist["loss"] + [l_r, l_n]):
        fail(f"{label}: a loss is not finite")
    if any(n.values()):
        fail(f"{label}: the 'xla' train step launched a kernel")
    if not same_frozen or len(moved) != len(tr0):
        fail(f"{label}: the frozen base changed or a trainable leaf did "
             "not move")
    if rel > REMAT_RTOL:
        fail(f"{label}: remat changed the loss")
    return {"peak": peak, "step_s": mean_s}


_FAMILY_CHECKS = ["phi3-medium-14b", "gemma2-27b", "mixtral-8x7b",
                  "llava-next-34b", "musicgen-large", "mamba2-1.3b",
                  "hymba-1.5b"]


def train_check(torch, step_fns, api, moe, tree_map, get_arch) -> None:
    """Phase 33: two ``make_train_step`` steps (full mode) of each family's
    fp32 SMOKE config on the card against the CPU from the same weights
    and batches, TF32 off, with remat "dots" and "none": the losses, the
    parameters (Adam's step is ~lr * sign(g), so an element whose gradient
    is near its rounding may move the other way: bound 2 * lr * steps) and
    mixtral's routings (``moe.route`` recorded on both sides)."""
    from repro_torch.data import synthetic_token_batches
    from repro_torch.optim import adam_init
    from repro_torch.tree import leaves

    lr, steps = 1e-3, 2
    route = moe.route
    for arch in _FAMILY_CHECKS:
        for remat in ("dots", "none"):
            cfg = dataclasses.replace(get_arch(arch).SMOKE, remat=remat)
            cpu = api.init_model(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
            got = {}
            for where in ("cpu", "cuda"):
                ids = []

                def recording(p, x, k, ids=ids):
                    out = route(p, x, k)
                    ids.append(out[2].cpu())
                    return out

                moe.route = recording
                params = tree_map(lambda t, w=where: t.to(w), cpu)
                opt = adam_init(params)
                step = step_fns.make_train_step(cfg, lr=lr, train_mode="full")
                hist = []
                try:
                    for b in synthetic_token_batches(
                            cfg.vocab, 2, 32, steps,
                            n_codebooks=cfg.n_codebooks):
                        batch = {k: torch.as_tensor(v, device=where)
                                 for k, v in b.items()}
                        if cfg.family == "vlm":
                            batch["patches"] = torch.zeros(
                                (2, cfg.n_patches, cfg.d_model),
                                device=where)
                        params, opt, m = step(params, opt, batch)
                        hist.append(float(m["loss"]))
                finally:
                    moe.route = route
                got[where] = (hist, [t.cpu() for t in leaves(params)], ids)
            (hc, pc, ic), (hg, pg, ig) = got["cpu"], got["cuda"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(hg, hc))
            err = max((a - b).abs().max().item() for a, b in zip(pg, pc))
            close = sum(int(((a - b).abs() > 1e-5).sum())
                        for a, b in zip(pg, pc))
            n_el = sum(t.numel() for t in pc)
            routes = sum(int((a != b).any(-1).sum()) for a, b in zip(ig, ic))
            say(f"[train check] {arch} SMOKE fp32, remat {remat!r}: losses "
                f"card " + ", ".join(f"{v:.6f}" for v in hg) + ", max "
                f"relative error vs CPU {rel:.2e} (rtol {TRAIN_RTOL}); "
                f"parameters max abs error {err:.2e} (bound "
                f"{2 * lr * steps}), {close} of {n_el} elements beyond "
                f"1e-5" + (f"; routings recorded {len(ig)}, tokens routed "
                           f"differently {routes}" if ic else ""))
            if rel > TRAIN_RTOL or err > 2 * lr * steps or routes or \
                    len(ig) != len(ic):
                fail(f"train check {arch} ({remat}): the card's train step "
                     "differs from the CPU's")


def federated_path(torch, md_ops, train) -> int:
    """Phase 34: ``launch/train.py --mode federated --backbone b2`` (its
    settings: 160 windows per subject, the paper fleet, utilization 2e-5,
    FedConfig's E=5 x 4 steps), 2 rounds: kernel 3 launches once per local
    step for all the clients it trains and once per evaluation batch."""
    args = train.parse_args(["--mode", "federated", "--backbone", "b2",
                             "--rounds", str(FEDERATED_ROUNDS)])
    t0 = time.perf_counter()
    run, ds = train.federated_run(args)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    fed = run.fed
    want = FEDERATED_ROUNDS * fed.local_epochs * fed.steps_per_epoch \
        + _eval_batches(ds)
    md_ops.reset_launches()
    t0 = time.perf_counter()
    hist = run.run(ds, log_every=args.eval_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = dict(md_ops.LAUNCHES)
    fusion = run.state.trainable["lora"]["fusion"]
    say(f"[federated] train.py --mode federated --backbone b2 (mm_config_for"
        f"'s model: fusion a {tuple(fusion['a'].shape)}, b "
        f"{tuple(fusion['b'].shape)}), {args.windows} windows per subject, "
        f"fleet N={run.fleet.N}, {args.strategy}: built in {built:.1f}s; "
        f"{FEDERATED_ROUNDS} rounds {wall:.2f}s host wall "
        f"({wall / FEDERATED_ROUNDS:.2f} s per round, after synchronize); "
        f"losses {[round(v, 4) for v in hist['loss']]}, F1 "
        f"{hist['f1'][-1]:.4f}; kernel launches {n} (expected "
        f"mdlora_matmul {want} = {FEDERATED_ROUNDS} rounds x "
        f"{fed.local_epochs} epochs x {fed.steps_per_epoch} steps + "
        f"{_eval_batches(ds)} evaluation batches)")
    if n["mdlora_matmul"] != want or n["mdlora_matmul_multi"]:
        fail("the federated mode did not launch kernel 3 as its path "
             "requires")
    if not all(math.isfinite(v) for v in hist["loss"] + hist["f1"]):
        fail(f"federated: history not finite {hist}")
    return n["mdlora_matmul"]


def guard_and_small_runs(torch, fa_ops, md_ops, ssd_ops, md_ref,
                         fused_block_lora, train, lora_ft) -> None:
    """Phase 35: flash attention, the gathered projection, the SSD scan and
    the raw fused projection raise under autograd on the card (each
    kernel's output would carry no gradient) and run under no_grad; the
    fused projection trains through its Function; the LoRA fine-tune
    example at SMOKE and ``train.py``'s save-and-resume at SMOKE, resumed
    losses bitwise equal to the uninterrupted run's."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    T = 45
    q, k, v = rand(2, 8, 2, 2, 64), rand(2, T, 2, 64), rand(2, T, 2, 64)
    qp = torch.arange(T - 8, T, dtype=torch.int32, device="cuda")
    kp = torch.arange(T, dtype=torch.int32, device="cuda")
    x, w0 = rand(8, 64), rand(64, 128)
    a, b = rand(3, 64, 4), rand(3, 4, 128)
    idx = torch.randint(0, 3, (8,), generator=g, device="cuda",
                        dtype=torch.int32)
    sx, dt = rand(2, 64, 4, 16), torch.nn.functional.softplus(rand(2, 64, 4))
    A_log, Bm, Cm = rand(4), rand(2, 64, 8), rand(2, 64, 8)
    fx, fw0 = rand(8, 32, 112), rand(112, 128)
    fa, fb, fm = rand(8, 112, 8), rand(8, 8, 128), torch.ones(112,
                                                              device="cuda")
    calls = {"flash_attention": (lambda: fa_ops.flash_attention(
                 q, k, v, qp, kp), q),
             "mdlora_matmul_multi": (lambda: md_ops.mdlora_matmul_multi(
                 x, w0, a, b, idx), a),
             "ssd": (lambda: ssd_ops.ssd(sx, dt, A_log, Bm, Cm, 16), sx),
             "mdlora_matmul": (lambda: md_ops.mdlora_matmul(
                 fx, fw0, fa, fb, fm, 2.0), fa)}
    raised = {}
    for name, (call, leaf) in calls.items():
        leaf.requires_grad_()
        try:
            call()
            raised[name] = False
        except RuntimeError as e:
            raised[name] = "has no backward" in str(e)
        with torch.no_grad():
            call()
        leaf.requires_grad_(False)
    fa.requires_grad_()
    fused_block_lora(fx, fw0, fa, fb, fm, 2.0).square().sum().backward()
    want = fa.detach().clone().requires_grad_()
    md_ref.mdlora_matmul_ref(fx, fw0, want, fb, fm, 2.0).square().sum() \
        .backward()
    gerr = ((fa.grad - want.grad).abs().max()
            / want.grad.abs().max()).item()
    say(f"[guard] under autograd on the card, raised 'has no backward': "
        f"{raised}; fused_block_lora's gradient vs the plain expression's: "
        f"max error {gerr:.2e} of the largest")
    if not all(raised.values()) or gerr > 1e-3:
        fail("guard: a kernel ran under autograd, or the fused Function's "
             "gradient is wrong")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        losses = lora_ft.main(["--device", "cuda", "--ckpt-dir",
                               str(Path(d) / "ft")])
        ft_s = time.perf_counter() - t0
        smoke = ["--smoke", "--ckpt-every", "3", "--log-every", "1000"]
        whole = train.main(smoke + ["--steps", "6", "--ckpt-dir",
                                    str(Path(d) / "a")])
        train.main(smoke + ["--steps", "3", "--ckpt-dir", str(Path(d) / "b")])
        resumed = train.main(smoke + ["--steps", "6", "--ckpt-dir",
                                      str(Path(d) / "b")])
    say(f"[guard] lora_finetune_backbone (gemma2-27b SMOKE, 30 steps) on the "
        f"card: loss {losses[0]:.4f} -> {losses[-1]:.4f}, {ft_s:.1f}s; "
        f"train.py --smoke 6 steps vs 3 + resume + 3: losses "
        + ", ".join(f"{v:.6f}" for v in whole["loss"][3:]) + " / "
        + ", ".join(f"{v:.6f}" for v in resumed["loss"])
        + f", bitwise equal: {resumed['loss'] == whole['loss'][3:]}")
    if not losses[-1] < losses[0] or resumed["loss"] != whole["loss"][3:]:
        fail("guard: the fine-tune example or the resume misbehaved")


# -- phases 36-37 -----------------------------------------------------------

# the autotuner's sweep (kernels/cohort_agg/autotune.py, timed branch) at
# the path and fleet shapes of kernels 1-2, kernel 3's path shape (8
# clients x 32 rows, 112 -> 128, r 8: the sweep times 256 rows of one
# adapter, the same 32 tiles) and kernel 4 at phi3's wq (bf16, 16 rows)
AUTOTUNE_AGG = [("path", PATH_SHAPE), ("fleet", (16384, 1024, 4))]
AUTOTUNE_FUSED = ("path", 8, 32, 112, 128, 8)
AUTOTUNE_MULTI = ("phi3 wq", 16, 5120, 5120, 16, 8)


def _agg_inputs(torch, N, D, r, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    x = torch.randn((N, D, r), **kw)
    W = torch.rand((N, D), **kw) * (torch.rand((N, D), **kw) < 0.7)
    C = (torch.rand((N, D), **kw) < 0.6).float()
    q = torch.randint(-127, 128, (N, D, r), dtype=torch.int8, **kw)
    s = torch.rand((N,), **kw) * 0.1 + 1e-3
    st = torch.randint(0, 6, (N,), **kw).float()
    return x, W, C, q, s, st


def _agg_close(torch, name, label, plan, got, want, scale) -> float:
    worst = 0.0
    for o, a, b, S in zip(("agg", "sq", "mean", "cnt"), got, want, scale):
        err = (a - b).abs()
        if not torch.isfinite(a).all() or (
                err > ATOL + RTOL * b.abs() + SUM_RTOL * S).any():
            fail(f"autotune {name} {label} plan {plan} {o}: max abs err "
                 f"{err.max().item():.3e} exceeds {ATOL} + {RTOL}*|plain| + "
                 f"{SUM_RTOL}*sum|terms|")
        worst = max(worst, err.max().item())
    return worst


def _say_sweep(name, label, timings, chosen, default, t_default, t_chosen,
               errs) -> None:
    say(f"[autotune] {name} {label}: {len(timings)} candidate plans, "
        "sweep device time per call (median of reps, CUDA graph "
        "replays): " + "; ".join(f"{p} {ms * 1e3:.2f} us (err {errs[p]:.2e})"
                               for p, ms in timings))
    say(f"[autotune] {name} {label}: chosen {chosen}, default {default}; "
        f"device time (CUDA graph) default {t_default * 1e3:.2f} us, "
        f"chosen {t_chosen * 1e3:.2f} us")


def autotune_path(torch, autotune, ops, ref, md_ops, md_ref) -> dict:
    """Phase 36: the autotuner's timed branch on the card. Each selector
    sweeps its kernel's launch plans (a warm-up call, then the median of
    ``_SWEEP_REPS`` replays of a CUDA graph of ``_REP_CALLS`` calls); the
    wrappers' launches in the sweep are counted from 0 (the warm-up and the
    captured calls; a replay launches without the wrapper).
    Then every candidate plan's output is held against the plain version
    with the tolerances of phases 3, 6 and 14 (kernel 3: every block count
    also bitwise equal to the default's), and the default and the chosen
    plan are timed on a CUDA graph. The ops' default plans stay."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    autotune.clear_cache()
    ops.reset_launches()
    md_ops.reset_launches()
    picks = {}
    for label, shape in AUTOTUNE_AGG:
        for quant in (False, True):
            picks[(label, quant)] = autotune.select_block_size(
                shape, interpret=False, quant=quant)
    _, K, T, D, F, r = AUTOTUNE_FUSED
    picks["fused"] = autotune.select_mdlora_blocks((K * T, D, F, r),
                                                   interpret=False)
    _, B, Dm, Fm, A, rm = AUTOTUNE_MULTI
    picks["multi"] = autotune.select_mdlora_blocks(
        (B, Dm, Fm, rm), interpret=False, multi=True, n_adapters=A,
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = {**ops.LAUNCHES, **md_ops.LAUNCHES}
    sweeps = dict(autotune.TIMINGS)
    say(f"[autotune] sweep launches, counted from 0 across the selectors: "
        f"{launches}")

    for label, (N, D_, r_) in AUTOTUNE_AGG:
        x, W, C, q, s, st = _agg_inputs(torch, N, D_, r_, N + D_ + r_)
        default = ops.plan_agg(N, D_, r_, sms)
        for quant in (False, True):
            name = ("cohort_agg_divergence_quant" if quant
                    else "cohort_agg_divergence")
            if quant:
                run = lambda p: ops.cohort_agg_divergence_quant(  # noqa: E731
                    q, s, W, C, st, 0.5, plan=p)
                want = ref.cohort_agg_divergence_quant_ref(q, s, W, C, st,
                                                           0.5)
                scale = ref.cohort_agg_divergence_quant_ref(q.abs(), s, W, C,
                                                            st, 0.5)
            else:
                run = lambda p: ops.cohort_agg_divergence(  # noqa: E731
                    x, W, C, plan=p)
                want = ref.cohort_agg_divergence_ref(x, W, C)
                scale = ref.cohort_agg_divergence_ref(x.abs(), W, C)
            timings = sweeps[("agg", N, D_, r_, quant, sms)]
            errs = {p: _agg_close(torch, name, label, p, run(p), want, scale)
                    for p, _ in timings}
            chosen = picks[(label, quant)]
            iters = 20 if label == "fleet" else 200
            t_default, _ = time_ms(torch, lambda: run(default), iters)
            t_chosen, _ = time_ms(torch, lambda: run(chosen), iters)
            _say_sweep(name, f"{label} N,D,r={N},{D_},{r_}", timings, chosen,
                       default, t_default, t_chosen, errs)

    label, K, T, D, F, r = AUTOTUNE_FUSED
    x, w0, a, b, mask = _fused_inputs(torch, md_ops, K, T, D, F, r, ("w0",),
                                      False, 36)
    with torch.no_grad():
        base = md_ops.mdlora_matmul(x, w0, a, b, mask, 2.0)
        default = md_ops.fused_blocks()
        want = md_ref.mdlora_matmul_ref(x, w0, a, b, mask, 2.0)
        timings = sweeps[("mdlora", D, F, r, False, 1, str(torch.float32),
                          sms)]
        errs = {}
        atol, rtol = FUSED_TOL[False]
        for n, _ in timings:
            got = md_ops.mdlora_matmul(x, w0, a, b, mask, 2.0, plan=n)
            err = (got - want).abs()
            if not torch.equal(got, base) or (
                    err > atol + rtol * want.abs()).any():
                fail(f"autotune mdlora_matmul {n} blocks: not bitwise the "
                     f"default plan's, or max abs err {err.max().item():.3e}"
                     f" exceeds {atol} + {rtol}*|plain|")
            errs[n] = err.max().item()
        chosen = picks["fused"]
        t_default, _ = time_ms(torch, lambda: md_ops.mdlora_matmul(
            x, w0, a, b, mask, 2.0), 200)
        t_chosen, _ = time_ms(torch, lambda: md_ops.mdlora_matmul(
            x, w0, a, b, mask, 2.0, plan=chosen), 200)
    _say_sweep("mdlora_matmul", f"{label} K={K} T={T} {D}->{F} r={r} "
               "(blocks; every count bitwise equal)", timings, chosen,
               default, t_default, t_chosen, errs)

    label, B, D, F, A, r = AUTOTUNE_MULTI
    x, w0, a, b, idx, _ = _md_inputs(torch, md_ops, B, D, F, A, r, None,
                                     True, 36)
    with torch.no_grad():
        want = md_ref.mdlora_matmul_multi_ref(x, w0, a, b, idx, None, 2.0)
        timings = sweeps[("mdlora", D, F, r, True, A, str(torch.bfloat16),
                          sms)]
        errs = {}
        atol, rtol = MD_TOL_BF16
        for p, _ in timings:
            got = md_ops.mdlora_matmul_multi(x, w0, a, b, idx, None, 2.0,
                                             plan=p)
            err = (got.float() - want.float()).abs()
            if not torch.isfinite(got).all() or (
                    err > atol + rtol * want.float().abs()).any():
                fail(f"autotune mdlora_matmul_multi plan {p}: max abs err "
                     f"{err.max().item():.3e} exceeds {atol} + "
                     f"{rtol}*|plain|")
            errs[p] = err.max().item()
        chosen, default = picks["multi"], md_ops.plan_multi(D, F, sms)
        t_default, _ = time_ms(torch, lambda: md_ops.mdlora_matmul_multi(
            x, w0, a, b, idx, None, 2.0), 200)
        t_chosen, _ = time_ms(torch, lambda: md_ops.mdlora_matmul_multi(
            x, w0, a, b, idx, None, 2.0, plan=chosen), 200)
    _say_sweep("mdlora_matmul_multi", f"{label} B={B} {D}->{F} A={A} r={r} "
               "bf16 (L, sd, su, ug)", timings, chosen, default, t_default,
               t_chosen, errs)
    autotune.clear_cache()
    return launches


DRYRUN_CHECK = "--dryrun-check"  # the child mode of dryrun_path()
# the configurations phases 31-32 measured: (arch, train mode, B, S), each
# with its FULL config as train.py runs it (remat "dots", attn "xla")
DRYRUN_TRAIN = [("phi3-medium-14b", "lora", 8, 128),
                ("mamba2-1.3b", "full", MAMBA_TRAIN["batch"],
                 MAMBA_TRAIN["seq"])]
DRYRUN_MEM_RTOL = 0.15  # predicted peak vs measured max_memory_allocated


def dryrun_child() -> None:
    """The child mode: the dry-run's trace (``launch/dryrun.py``) of each
    DRYRUN_TRAIN configuration on a fake one-rank mesh, then one production
    cell, phi3-medium-14b train_4k on the (16, 16) mesh without probes;
    one JSON line. The fake process group is global to a process, so this
    runs apart from the card's phases; it touches no card."""
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.configs import base
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import close_process_group, make_fake_mesh

    # beside the parent's host-bound phases: one thread, lowest priority
    torch.set_num_threads(1)
    os.nice(19)
    out = {"train": []}
    mesh = make_fake_mesh((1, 1), ("data", "model"))
    for arch, mode, B, S in DRYRUN_TRAIN:
        mod = base.get_arch(arch)
        shape = base.ShapeConfig("train", S, B, "train")
        t0 = time.perf_counter()
        got = dryrun._trace_step(mod.FULL, mod, shape, mesh, mode,
                                 "replicated")
        mf = roofline.model_flops(mod.FULL, shape, mode)
        out["train"].append(dict(
            arch=arch, mode=mode, batch=B, seq=S,
            trace_s=time.perf_counter() - t0, peak=got["peak_bytes"],
            state=got["argument_bytes"], flops=got["flops"],
            bytes=got["bytes"], model_flops=mf["model_flops"],
            **roofline.roofline_terms(got["flops"], got["bytes"],
                                      got["coll"])))
    close_process_group()
    t0 = time.perf_counter()
    try:  # recorded as the dry-run's CLI records a cell
        cell = dryrun.run_cell("phi3-medium-14b", "train_4k", False,
                               probes="skip")
        out["cell"] = dict(status=cell["status"], strategy=cell["strategy"],
                           per_device_gb=cell["memory"]["per_device_gb"],
                           fits=cell["memory"]["fits_80gb_hbm"])
    except Exception as e:  # noqa: BLE001 — reported by phase 37
        out["cell"] = dict(status="error", error=repr(e)[:1500])
    finally:
        close_process_group()
    out["cell"]["trace_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def start_dryrun_child() -> subprocess.Popen:
    """Phase 37's child, started early: it needs no card, and its traces
    (about a minute of host time) overlap the card's phases. Its output
    goes to temporary files (a pipe left unread could fill and stall it);
    it is killed if this process exits first."""
    import atexit

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                              DRYRUN_CHECK], stdout=out, stderr=err,
                             text=True)
    child.files = (out, err)
    atexit.register(lambda: child.poll() is None and child.kill())
    return child


def dryrun_path(child: subprocess.Popen, measured: dict) -> None:
    """Phase 37: the dry-run against the card. For each configuration of
    phases 31-32: the predicted peak per device against the measured
    ``max_memory_allocated`` (asserted within DRYRUN_MEM_RTOL), the counted
    FLOPs against ``model_flops``, and t_compute / t_memory (H100
    data-sheet constants) against the measured ms per step; then the
    production cell's status and per-device GB (a cell that does not trace
    is reported with its error, as the dry-run's grid records it)."""
    try:
        child.wait(timeout=900)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        fail("the dry-run child did not finish in 900 s")
    stdout, stderr = (f.seek(0) or f.read() for f in child.files)
    if child.returncode != 0:
        fail(f"the dry-run child failed ({child.returncode}):\n"
             f"{stderr[-4000:]}")
    got = json.loads(stdout.strip().splitlines()[-1])
    for row in got["train"]:
        m = measured[row["arch"]]
        rel = (row["peak"] - m["peak"]) / m["peak"]
        say(f"[dryrun] {row['arch']} FULL {row['mode']} B={row['batch']} "
            f"S={row['seq']} on a fake one-rank mesh (traced in "
            f"{row['trace_s']:.1f}s of host time): predicted peak "
            f"{row['peak'] / 1e9:.2f} GB (state {row['state'] / 1e9:.2f} GB)"
            f" vs measured {m['peak'] / 1e9:.2f} GB (phase "
            f"{m['phase']}): {rel:+.1%} (bound {DRYRUN_MEM_RTOL:.0%}); "
            f"counted FLOPs {row['flops'] / 1e12:.2f} T vs model_flops "
            f"{row['model_flops'] / 1e12:.2f} T "
            f"({row['flops'] / row['model_flops']:.3f}x); t_compute "
            f"{row['t_compute_s'] * 1e3:.1f} ms, t_memory (unfused bytes "
            f"{row['bytes'] / 1e9:.1f} GB) {row['t_memory_s'] * 1e3:.1f} ms,"
            f" dominant {row['dominant']}, vs measured "
            f"{m['step_s'] * 1e3:.1f} ms per step "
            f"({max(row['t_compute_s'], row['t_memory_s']) / m['step_s']:.1%}"
            " of it)")
        if abs(rel) > DRYRUN_MEM_RTOL:
            fail(f"dryrun {row['arch']}: predicted peak off by {rel:+.1%}")
    c = got["cell"]
    say("[dryrun] production cell phi3-medium-14b train_4k single (16 x 16 "
        f"fake mesh, no probes), traced in {c['trace_s']:.1f}s: status "
        f"{c['status']}, " + (
            f"{c['strategy']}, {c['per_device_gb']} GiB per device (fits "
            f"80 GB: {c['fits']})" if c["status"] == "ok" else c["error"]))


# -- phases 38-40 -----------------------------------------------------------

QUICKSTART_ROUNDS = 12  # the reference script's default
DUEL_ROUNDS = 2
# serve_backbone's defaults (examples/serve_backbone.py): B=4, P=32, 24 steps
SERVE_BACKBONE = dict(batch=4, prompt_len=32, decode_steps=24)
# phi3-medium-14b's split-KV decode at serve_backbone's shape: B=4 and a
# 56-slot ring (P + steps) that starts empty, so one 64-key tile and 1 to 56
# filled slots (first step, mid-run, last step)
SERVE_BACKBONE_FA_CASES = [  # as FA_CASES
    (f"backbone decode {n}/56", 4, 1, 56, 10, 4, 128, n, None, None, True)
    for n in (1, 33, 56)]
# README's fleet-scale rows: (N, K, flushes, churn, arrivals, jitter)
FLEET_SIMS = [(1_000_000, 64, 50, 0.01, 0.02, 0.1),
              (10_000, 64, 200, 0.0, 0.0, 0.1)]


def examples_sync(torch, ops, md_ops, quickstart, baseline_duel,
                  smi) -> None:
    """Phase 38: the quickstart and the baseline duel on the card (Backbone
    1: no kernel)."""
    kops = (ops, md_ops)
    _reset_all(kops)
    t0 = time.perf_counter()
    task, tr0, fleet, fed, ds = quickstart.build(QUICKSTART_ROUNDS, 0,
                                                 "cuda")
    s = quickstart.summarize(quickstart.compare(task, tr0, fleet, fed, ds))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _counts(kops)
    fa, rl = s["fedavg"], s["relief"]
    say(f"[examples] quickstart ({smi}): {QUICKSTART_ROUNDS} rounds each, "
        f"F1 FedAvg {fa['f1']:.4f} RELIEF {rl['f1']:.4f}; simulated round "
        f"{fa['round_time_s']:.4f} s vs {rl['round_time_s']:.4f} s (speedup "
        f"{s['speedup']:.4f}x); energy {fa['energy_j']:.2f} J vs "
        f"{rl['energy_j']:.2f} J per round (saving "
        f"{100 * s['energy_saving']:.2f}%); upload {fa['upload_mb']:.4f} MB "
        f"vs {rl['upload_mb']:.4f} MB per round; host {wall:.2f} s, "
        f"{wall / (2 * QUICKSTART_ROUNDS):.3f} s per round with its "
        f"evaluations and the build; launches {n} (expected none: Backbone "
        "1 has no fusion LoRA)")
    if not rl["round_time_s"] < fa["round_time_s"]:
        fail("quickstart: RELIEF's round is not shorter than FedAvg's")
    if any(n.values()):
        fail("quickstart launched a kernel off its path")
    _reset_all(kops)
    pieces = baseline_duel.build("pamap2", DUEL_ROUNDS, 0, "cuda")
    rows, secs = [], []
    for name in baseline_duel.METHODS:
        t0 = time.perf_counter()
        rows += baseline_duel.duel(*pieces, names=(name,))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    n = _counts(kops)
    base_t = next(r[2] for r in rows if r[0] == "fedavg")
    for (name, f1, t, e, mb), sec in zip(rows, secs):
        say(f"[examples] baseline_duel {name} ({DUEL_ROUNDS} rounds): F1 "
            f"{f1:.4f}, simulated {t:.4f} s per round (speedup "
            f"{base_t / t:.4f}x), {e:.2f} J/r, {mb:.4f} MB/r; host "
            f"{sec:.2f} s")
    say(f"[examples] baseline_duel ({smi}): {len(rows)} methods in host "
        f"{sum(secs):.2f} s ({sum(secs) / len(rows):.2f} s per method); "
        f"launches {n} (expected none)")
    if [r[0] for r in rows] != list(baseline_duel.METHODS) or any(
            not (0.0 <= r[1] <= 1.0 and r[2] > 0) for r in rows):
        fail(f"baseline_duel: bad rows {rows}")
    if any(n.values()):
        fail("baseline_duel launched a kernel off its path")


def _recording_flash(fa_ops, keep):
    """A stand-in for ``fa_ops.flash_attention`` that calls it and keeps
    clones of the inputs, output and options of the calls whose index
    ``keep`` accepts -> (stand-in, the kept calls)."""
    kept, launch, turn = [], fa_ops.flash_attention, [0]

    def call(q, k, v, q_pos, kv_pos, window=None, softcap=None):
        out = launch(q, k, v, q_pos, kv_pos, window, softcap)
        if keep(turn[0]):
            kept.append(tuple(t.clone() for t in (q, k, v, q_pos, kv_pos,
                                                  out)) + (window, softcap))
        turn[0] += 1
        return out
    return call, kept


def _held_calls(fa_ref, kept) -> float:
    """Each kept bf16 call's output against the plain version in fp32 on
    its inputs, at FA_TOL -> the largest abs error (fails past the bound)."""
    atol, rtol = FA_TOL[True]
    worst = 0.0
    for i, (q, k, v, qp, kp, got, window, cap) in enumerate(kept):
        want = fa_ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                          qp, kp, window, cap)
        diff = (got.float() - want).abs()
        worst = max(worst, diff.max().item())
        if not got.isfinite().all() or (diff > atol
                                         + rtol * want.abs()).any():
            fail(f"serve_backbone: kept flash call {i} (filled "
                 f"{int((kp >= 0).sum())}) disagrees with the plain "
                 f"version: max abs err {diff.max().item():.3e}")
    return worst


def serve_backbone_path(torch, serve_backbone, kops, fa_ref, cfg, params,
                        smi, expect_flash: bool) -> int:
    """Phase 39 on FULL weights already on the card -> flash attention's
    split-KV decode calls (each layer once per step when
    ``expect_flash``, else none). The first and the last layer's calls are
    kept and held against the plain version on their own inputs."""
    fa_ops = kops[0]
    B, P, steps = (SERVE_BACKBONE["batch"], SERVE_BACKBONE["prompt_len"],
                   SERVE_BACKBONE["decode_steps"])
    prompts = serve_backbone.draw_prompts(cfg, B, P, 0)
    L = cfg.n_layers
    call, kept = _recording_flash(fa_ops, lambda i: i % L in (0, L - 1))
    launch = fa_ops.flash_attention
    _reset_all(kops)
    fa_ops.flash_attention = call
    try:
        res = serve_backbone.serve(cfg, params, prompts, steps)
    finally:
        fa_ops.flash_attention = launch
    n = _counts(kops)
    by_path = dict(fa_ops.PATH_LAUNCHES)
    err = _held_calls(fa_ref, kept)
    want = cfg.n_layers * (P + steps) if expect_flash else 0
    say(f"[serve backbone] {cfg.arch} FULL ({cfg.n_layers} layers, "
        f"{cfg.dtype}, attn {cfg.attn_impl}) B={B}, P={P} through the decode "
        f"step, {steps} decode steps ({smi}): prefill {res['prefill_s']:.3f} s"
        f" = {res['prefill_s'] / P * 1e3:.2f} ms per step, decode "
        f"{res['decode_s']:.3f} s = {res['decode_s'] / steps * 1e3:.2f} ms "
        f"per step, {res['tok_s']:.1f} tok/s; launches {n}, flash by path "
        f"{by_path} (expected flash_attention {want} = "
        + (f"{cfg.n_layers} layers x {P + steps} steps, all split-KV decode"
           if expect_flash else "none: hymba's attention is the plain one")
        + f"); sample {res['tokens'][0, :8].tolist()}; {len(kept)} calls "
        f"of layers 0 and {L - 1} (filled 1 to {P + steps} of the ring) "
        f"against the plain fp32 version: max abs err {err:.2e} (atol "
        f"{FA_TOL[True][0]} + {FA_TOL[True][1]:.4g}*|plain|)")
    if expect_flash and len(kept) != 2 * (P + steps):
        fail(f"serve_backbone: kept {len(kept)} flash calls, expected "
             f"{2 * (P + steps)}")
    if (n["flash_attention"] != want or by_path["decode"] != want
            or n["mdlora_matmul_multi"] or n["ssd"]):
        fail(f"serve_backbone on {cfg.arch} did not launch the kernels its "
             "path requires")
    if tuple(res["tokens"].shape) != (B, steps):
        fail(f"serve_backbone: tokens of shape {tuple(res['tokens'].shape)}")
    return by_path["decode"]


def serve_backbone_check(torch, serve_backbone, api, kops, tree_map,
                         full) -> None:
    """Phase 39's check: a float32 phi3-shaped model of 2 layers, tokens
    with the kernel on the card equal the plain version's on the CPU. The
    model is float32, so this holds the fp32 kernel; the bf16 split-KV
    decode of the FULL run is held in ``serve_backbone_path``."""
    cfg, cpu, gpu = _check_model(torch, api, tree_map, full)
    prompts = serve_backbone.draw_prompts(
        cfg, SERVE_BACKBONE["batch"], SERVE_BACKBONE["prompt_len"], 1)
    _reset_all(kops)
    got = serve_backbone.serve(cfg, gpu, prompts,
                               SERVE_BACKBONE["decode_steps"])["tokens"]
    n = _counts(kops)
    want = serve_backbone.serve(cfg, cpu, prompts,
                                SERVE_BACKBONE["decode_steps"])["tokens"]
    say(f"[check] serve_backbone fp32 phi3-shaped model (2 layers, d 512; "
        f"the fp32 kernel): "
        f"tokens card == CPU: {bool((got == want).all())} "
        f"({got.numel()} tokens); card launches {n}")
    if n["flash_attention"] == 0 or not bool((got == want).all()):
        fail("serve_backbone check: tokens differ card vs CPU, or the card "
             "run skipped the flash kernel")


def fleet_sim(torch, fleet_scale_sim, smi) -> None:
    """Phase 40: the fleet-scale system simulation at the README's sizes."""
    for n, K, flushes, churn, arrival, jitter in FLEET_SIMS:
        t0 = time.perf_counter()
        run = fleet_scale_sim.build(n, K, churn, arrival, jitter, 0, "cuda")
        built = time.perf_counter() - t0
        s = fleet_scale_sim.simulate(run, flushes)
        say(f"[fleet sim] N={n:,d} K={K} {flushes} flushes, churn {churn}, "
            f"arrivals {arrival}, jitter {jitter} ({smi}; host numpy): "
            f"built in {built:.2f} s; {s['completions']:,d} completions, "
            f"wall {s['wall_s']:.3f} s = {s['events_per_s']:,.0f} events/s, "
            f"{s['flushes_per_s']:.2f} flushes/s; simulated "
            f"{s['sim_time_s']:.4f} s, energy {s['energy_j']:.1f} J, upload "
            f"{s['upload_mb']:.2f} MB; staleness mean "
            f"{s['staleness_mean']:.2f} p50 {s['staleness_p50']:.2f} p95 "
            f"{s['staleness_p95']:.2f} max {s['staleness_max']:.2f}; "
            f"per-client updates mean {s['updates_mean']:.4f} max "
            f"{s['updates_max']}, idle {s['idle_frac']:.4f}; alive "
            f"{s['alive_frac']:.4f}")
        if (s["flushes"] != flushes or s["completions"] < flushes * K
                or not math.isfinite(s["sim_time_s"])):
            fail(f"fleet sim N={n}: {s}")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    t_start = time.perf_counter()
    smi = card(torch)
    dryrun_child = start_dryrun_child()
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cohort_agg import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mdlora import ops as md_ops
    from repro_torch.kernels.mdlora import ref as md_ref
    from repro_torch.kernels.mdlora.autograd import fused_block_lora
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.launch import (serve, serve_backbone, serving_engine,
                                    step_fns, train_async_har,
                                    train_relief_har)
    from repro_torch.models import api, moe, ssm
    from repro_torch.tree import tree_map

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        say(f"[time] phase {name}: {time.perf_counter() - t0:.1f}s wall")
        return out

    kops = (fa_ops, md_ops, ssd_ops)
    sources = {"cohort_agg_divergence": ops.SOURCE,
               "cohort_agg_divergence_quant": ops.SOURCE,
               "flash_attention": fa_ops.SOURCE,
               "flash_attention_prefill": fa_ops.SOURCE,
               "mdlora_matmul_multi": md_ops.SOURCE,
               "ssd": ssd_ops.SOURCE,
               "mdlora_matmul": md_ops.FUSED_SOURCE}
    phase("build", build_kernels, runtime, sorted(set(sources.values())))
    counts = phase("launch counts", launch_counts)
    results = phase("kernels", check_kernels, torch, ops, ref, counts)
    launches = phase("main", main_path, torch, ops, train_async_har, 12)
    phase("check", reference_check, torch)
    fa_res = phase("serve kernels (flash)", check_flash, torch, fa_ops,
                   fa_ref)
    md_res = phase("serve kernels (mdlora)", check_mdlora, torch, md_ops,
                   md_ref, counts)
    results["flash_attention"] = dict(path="decode", **fa_res["decode"])
    results["flash_attention_prefill"] = dict(path="prefill",
                                              **fa_res["prefill"])
    results["mdlora_matmul_multi"] = md_res["wq"]
    full = dataclasses.replace(get_arch("phi3-medium-14b").FULL,
                               attn_impl="pallas")
    params = model_params(torch, serve, api, full)
    by_path = phase("serve", serve_batched, torch, serve, kops, full,
                    params)
    launches["flash_attention"] = by_path["decode"]
    launches["flash_attention_prefill"] = by_path["prefill"]
    launches["mdlora_matmul_multi"] = phase(
        "engine", serve_engine, torch, serve, kops, full, params)
    phase("serve backbone kernel (flash)", check_flash, torch, fa_ops,
          fa_ref, SERVE_BACKBONE_FA_CASES)
    launches["flash_attention"] += phase(
        "serve backbone", serve_backbone_path, torch, serve_backbone, kops,
        fa_ref, full, params, smi, True)
    del params
    torch.cuda.empty_cache()
    phase("serve check", serve_check, torch, serve, serving_engine, api,
          kops, tree_map, full)
    phase("serve backbone check", serve_backbone_check, torch,
          serve_backbone, api, kops, tree_map, full)
    results["ssd"] = phase("ssd kernel", check_ssd, torch, ssd_ops, ssd_ref,
                           ssm, counts)["mamba2"]
    launches["ssd"] = 0
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        cfg = dataclasses.replace(get_arch(arch).FULL, attn_impl="pallas")
        params = model_params(torch, serve, api, cfg)
        launches["ssd"] += phase(f"{arch} prefill step", prefill_step, torch,
                                 step_fns, kops, cfg, params)
        if arch == "mamba2-1.3b":
            phase(f"{arch} batched serve", mamba_serve, torch, serve, kops,
                  cfg, params)
        else:
            launches["mdlora_matmul_multi"] += phase(
                f"{arch} engine", hymba_engine, torch, serve, kops, cfg,
                params)
            phase(f"{arch} serve backbone", serve_backbone_path, torch,
                  serve_backbone, kops, fa_ref, cfg, params, smi, False)
        del params
        torch.cuda.empty_cache()
    phase("recurrent check", recurrent_check, torch, serve, serving_engine,
          step_fns, api, kops, tree_map, get_arch)
    results["mdlora_matmul"] = phase("fused kernel", check_fused, torch,
                                     md_ops, md_ref, fused_block_lora,
                                     counts)["path"]
    launches["mdlora_matmul"] = phase("sync", sync_path, torch, md_ops,
                                      train_relief_har)
    phase("sync check", sync_check, torch, md_ops, train_relief_har,
          tree_map)
    from repro_torch import sim
    from repro_torch.core import async_engine
    for name, got in (
            ("async b2", phase("async b2", async_b2, torch, ops, md_ops,
                               train_async_har)),
            ("robust", phase("robust", robust_path, torch, ops, md_ops,
                             train_async_har, sim.FaultModel)),
            ("fleet", phase("fleet", fleet_path, torch, ops, md_ops,
                            train_async_har, async_engine, sim))):
        launches["cohort_agg_divergence"] += got["agg"]
        launches["cohort_agg_divergence_quant"] += got.get("quant", 0)
        launches["mdlora_matmul"] += got["mdlora"]
        say(f"[{name}] kernel 1-3 launches on this path: {got}")
    phase("async check", async_check, torch, train_async_har, sim.FaultModel)
    from repro_torch.data import get_provider
    from repro_torch.launch import experiments
    got = phase("scenarios", scenarios_path, torch, ops, md_ops, sim)
    launches["cohort_agg_divergence"] += got["agg"]
    launches["cohort_agg_divergence_quant"] += got["quant"]
    launches["mdlora_matmul"] += got["mdlora"]
    say(f"[scenarios] kernel 1-3 launches on this path: {got}")
    launches["mdlora_matmul"] += phase("experiments", experiments_path, torch,
                                       md_ops, experiments, get_provider)
    phase("scenario check", scenario_check, torch, sim, async_engine)
    from repro_torch import checkpoint
    launches["mdlora_matmul"] += phase("paper experiments", paper_path,
                                       torch, ops, md_ops, experiments,
                                       get_provider)
    launches["mdlora_matmul"] += phase("motivation", motivation_path, torch,
                                       ops, md_ops, experiments)
    launches["mdlora_matmul"] += phase("checkpoint", checkpoint_path, torch,
                                       md_ops, train_relief_har, checkpoint)
    phase("zoo kernels", zoo_kernels, torch, fa_ops, fa_ref, md_ops, md_ref,
          counts)
    mixtral = dataclasses.replace(get_arch("mixtral-8x7b").FULL,
                                  n_layers=MOE_LAYERS, attn_impl="pallas")
    by_path, md = phase("moe serve", moe_serve, torch, serve, api, kops,
                        mixtral)
    zoo = phase("zoo serve", zoo_serve, torch, serve, api, kops, get_arch)
    launches["flash_attention"] += by_path["decode"] + zoo["decode"]
    launches["flash_attention_prefill"] += by_path["prefill"] \
        + zoo["prefill"]
    launches["mdlora_matmul_multi"] += md
    phase("zoo check", zoo_check, torch, serve, api, kops, tree_map, moe,
          get_arch)
    from repro_torch.launch import lora_finetune_backbone, train
    measured = {}
    measured["phi3-medium-14b"] = dict(phase=31, **phase(
        "lora train", backbone_train, torch, train, step_fns, api, kops,
        "phi3-medium-14b", ["--steps", str(TRAIN_STEPS)], "lora train"))
    measured["mamba2-1.3b"] = dict(phase=32, **phase(
        "full train", backbone_train, torch, train, step_fns, api, kops,
          "mamba2-1.3b", ["--train-mode", "full", "--batch",
                          str(MAMBA_TRAIN["batch"]), "--seq",
                          str(MAMBA_TRAIN["seq"]), "--steps",
                          str(MAMBA_TRAIN["steps"])], "full train",
          MAMBA_TRAIN["remat_batch"]))
    phase("train check", train_check, torch, step_fns, api, moe, tree_map,
          get_arch)
    launches["mdlora_matmul"] += phase("federated", federated_path, torch,
                                       md_ops, train)
    phase("guard", guard_and_small_runs, torch, fa_ops, md_ops, ssd_ops,
          md_ref, fused_block_lora, train, lora_finetune_backbone)
    from repro_torch.kernels.cohort_agg import autotune
    for name, n in phase("autotune", autotune_path, torch, autotune, ops,
                         ref, md_ops, md_ref).items():
        launches[name] += n
    phase("dryrun", dryrun_path, dryrun_child, measured)
    from repro_torch.launch import baseline_duel, fleet_scale_sim, quickstart
    phase("examples sync", examples_sync, torch, ops, md_ops, quickstart,
          baseline_duel, smi)
    phase("fleet sim", fleet_sim, torch, fleet_scale_sim, smi)
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
    if sys.argv[1:] == [LAUNCH_COUNTS]:
        launch_counts_child()
    elif sys.argv[1:] == [DRYRUN_CHECK]:
        dryrun_child()
    elif sys.argv[1:] == [PROFILE_SYNC]:
        profile_sync_child()
    else:
        main()
