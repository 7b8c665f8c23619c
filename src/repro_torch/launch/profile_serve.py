"""Where a serving decode step's time goes: a few decode steps of the batched
path and of the multi-LoRA engine under ``torch.profiler``.

  python -m repro_torch.launch.profile_serve --arch phi3-medium-14b [--smoke]
      [--steps 4] [--prompt-len 512] [--device cuda|cpu]

The shapes are those ``chip_smoke.py`` serves phi3-medium-14b at: the
batched path prefills 8 prompts of ``--prompt-len`` (512) tokens and
profiles ``steps`` lockstep decode steps (flash attention); the engine
admits one request per slot into 16 slots (prompts of up to half as many
tokens, 16 adapters, each with its own modality mask) and profiles
``steps`` engine steps with every slot busy (the gathered projection;
mamba2 has no fusion projection and musicgen's prompts carry codebooks,
which the engine does not take, so neither has an engine). The recurrent families
prefill by the token loop of decode steps. For each it prints the host
wall per step (after a synchronize, profiler on), the card's busy time per
step (the union of its kernels', copies' and sets' intervals), the card's
idle share, kernel launches per step and the kernels that take the most
device time; then the longest idle gaps on the card, each named by the
program's span (``repro_torch.trace``) open on the host at the gap's start,
and the card's idle time under each span. On the card only CUDA activity is
traced (host op records would slow the host and so inflate the idle
share); on the CPU only the host side is.

The device defaults to the CUDA card and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import trace
from repro_torch.configs.base import ModelConfig, get_arch, list_archs
from repro_torch.kernels import runtime
from repro_torch.launch import serve
from repro_torch.launch import step_fns as SF
from repro_torch.launch.serving_engine import ServingEngine
from repro_torch.models import api

BATCH, SLOTS, N_ADAPTERS = 8, 16, 16


def profile_steps(label: str, step, n: int, dev: torch.device) -> dict:
    """``n`` calls of ``step`` under the profiler -> per-call host wall,
    device busy time (None on the CPU), idle share, kernel launches, the
    top 8 kernels (or, on the CPU, host ops) by self time and, on the card,
    the 10 longest idle gaps (ms, the path of the span open at the gap's
    start, the innermost span holding most of it) and the idle time under
    each innermost span (ms per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    dropped = trace.TRACER.dropped
    sync()
    with profile(activities=acts) as prof:
        w0 = time.time_ns()
        for _ in range(n):
            step()
        sync()
        w1 = time.time_ns()
    wall = (w1 - w0) * 1e-9 / n
    res = {"wall_ms": wall * 1e3, "busy_ms": None, "idle_share": None}
    if cuda:
        dev_ev, launches = [], 0
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                dev_ev.append((ev.start_ns(), ev.end_ns(), ev.name()))
            elif ev.name() == "cudaLaunchKernel":
                launches += 1
        res.update(_device_breakdown(dev_ev, w0, w1, n), launches=launches / n)
    else:
        avg = prof.key_averages()
        events = [e for e in avg if e.device_type == DeviceType.CPU]
        res.update(launches=sum(e.count for e in avg
                                if e.key == "cudaLaunchKernel") / n,
                   top=[(e.key, e.self_cpu_time_total / n / 1e3, e.count / n)
                        for e in sorted(events, key=lambda e:
                                        e.self_cpu_time_total,
                                        reverse=True)[:8]])
    print(f"[profile] {label}: {n} calls, host wall {res['wall_ms']:.2f} ms "
          "per call (profiler on), "
          + ("" if not cuda else
             f"device busy {res['busy_ms']:.2f} ms per call, idle share "
             f"{res['idle_share']:.1%}, ")
          + f"{res['launches']:.0f} cudaLaunchKernel per call; top "
          + ("device" if cuda else "host") + " time per call:", flush=True)
    for key, ms, count in res["top"]:
        print(f"[profile]   {ms:8.3f} ms {count:6.1f}x  {key[:90]}",
              flush=True)
    if cuda:
        print(f"[profile] {label}: longest idle gaps on the card (ms, the "
              "span open on the host at the gap's start):", flush=True)
        for ms, at_start, most in res["idle_gaps"]:
            print(f"[profile]   {ms:8.3f} ms  {at_start}"
                  + ("" if at_start.endswith(most) else
                     f"  (most of it under {most})"), flush=True)
        print(f"[profile] {label}: the card's idle time per call under each "
              "innermost span (ms):", flush=True)
        for name, ms in sorted(res["idle_by_span"].items(),
                               key=lambda kv: -kv[1]):
            print(f"[profile]   {ms:8.3f} ms  {name}", flush=True)
    lost = trace.TRACER.dropped - dropped
    if lost:
        print(f"[profile] {label}: {lost} span records dropped past "
              f"{trace.MAX_RECORDS}", flush=True)
    return res


def _device_breakdown(dev_ev, w0: int, w1: int, n: int) -> dict:
    """From the card's events (start ns, end ns, name) in the window
    [w0, w1] of ``n`` calls: busy ms and idle share per call, the top 8
    kernels, the 10 longest idle gaps named by span and the idle ms per call
    under each innermost span. Raises without a device event: a CUDA-only
    profiler session records none after an earlier session with CPU
    activity in the same process, and the card would read as idle
    throughout."""
    if not dev_ev:
        raise RuntimeError(
            "the profiler recorded no device event in the window: after a "
            "profiler session with CPU activity in this process, a "
            "CUDA-only session records none; profile in a fresh process")
    wall = (w1 - w0) * 1e-9 / n
    kernels: dict[str, list] = {}
    for s0, s1, name in dev_ev:
        acc = kernels.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += (s1 - s0) * 1e-6
    gaps = _idle_gaps(dev_ev, w0, w1)
    busy = wall - sum(g1 - g0 for g0, g1 in gaps) * 1e-9 / n
    recs = [r for r in trace.records() if r.end > w0 and r.start < w1]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return dict(busy_ms=busy * 1e3, idle_share=1 - busy / wall,
                top=[(k, ms / n, c / n) for k, (c, ms) in sorted(
                    kernels.items(), key=lambda kv: -kv[1][1])[:8]],
                idle_gaps=[_name_gap(g, recs) for g in longest],
                idle_by_span={k: ms / n for k, ms in
                              _idle_by_span(gaps, recs).items()})


def _name_gap(gap, recs) -> tuple[float, str, str]:
    """(ms, the path of the span open at the gap's start, the innermost
    span under which most of the gap lies)."""
    at = trace.open_at(gap[0])
    share = _idle_by_span([gap], recs)
    return ((gap[1] - gap[0]) * 1e-6, at.path() if at else "(no span)",
            max(share, key=share.get))


def _idle_gaps(intervals, w0: int, w1: int) -> list[tuple[int, int]]:
    """The stretches of [w0, w1] (ns) that no interval covers."""
    gaps, reach = [], w0
    for s0, s1, _ in sorted(intervals):
        if s0 > reach:
            gaps.append((reach, min(s0, w1)))
        reach = max(reach, s1)
    if reach < w1:
        gaps.append((reach, w1))
    return [(g0, g1) for g0, g1 in gaps if g1 > g0]


def _idle_by_span(gaps, recs) -> dict[str, float]:
    """ms of ``gaps`` under each innermost open record's name ("(no span)"
    outside every record): the records' boundaries cut the time line into
    pieces in which the innermost open record is one."""
    marks = sorted([(r.start, 1, r) for r in recs]
                   + [(r.end, 0, r) for r in recs], key=lambda m: m[:2])
    pieces, stack, t = [], [], None
    for at, opens, r in marks:
        if t is not None and at > t:
            pieces.append((t, at, stack[-1].name if stack else "(no span)"))
        t = at
        if opens:
            stack.append(r)
        else:
            stack.remove(r)
    out: dict[str, float] = {}
    i = 0
    for g0, g1 in gaps:
        covered = 0
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            p0, p1, name = pieces[j]
            d = min(p1, g1) - max(p0, g0)
            if d > 0:
                out[name] = out.get(name, 0.0) + d * 1e-6
                covered += d
            j += 1
        if g1 - g0 > covered:
            out["(no span)"] = (out.get("(no span)", 0.0)
                                + (g1 - g0 - covered) * 1e-6)
    return out


def profile_batched(cfg: ModelConfig, params: dict, *, batch: int,
                    prompt_len: int, steps: int, dev: torch.device) -> dict:
    caches = api.init_caches(cfg, batch, prompt_len + steps + 1, device=dev)
    shape = (batch, prompt_len) + ((cfg.n_codebooks,) if cfg.n_codebooks
                                   else ())
    prompts = torch.randint(0, cfg.vocab, shape, dtype=torch.int32,
                            generator=torch.Generator().manual_seed(0))
    logits, caches = api.prefill_with_cache(params, cfg, caches,
                                            prompts.to(dev))
    state = {"tok": logits.argmax(-1).to(torch.int32), "pos": prompt_len,
             "caches": caches}
    serve_step = SF.make_serve_step(cfg)

    def step():
        state["tok"], state["caches"] = serve_step(
            params, state["caches"], state["tok"], state["pos"])
        state["pos"] += 1

    step()  # warm
    return profile_steps(f"batched decode B={batch}", step, steps, dev)


def profile_engine(cfg: ModelConfig, params: dict, *, slots: int,
                   n_adapters: int, prompt_len: int, steps: int,
                   dev: torch.device) -> dict:
    reg = serve.build_registry(cfg, n_adapters, 0, dev)
    new_tokens = steps + 2  # no slot frees up inside the profiled window
    eng = ServingEngine(params, cfg, reg, batch_slots=slots,
                        max_len=prompt_len + new_tokens + 2,
                        lora_impl="pallas")
    for r in serve.make_requests(cfg, slots, n_adapters, prompt_len,
                                 max(2, prompt_len // 4), new_tokens, 0):
        eng.submit(r)
    eng.step()  # admits every slot and decodes once
    return profile_steps(f"engine decode, {slots} busy slots", eng.step,
                         steps, dev)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi3-medium-14b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced SMOKE config instead of FULL")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512,
                    help="batched prompt length; the engine's longest "
                    "prompt is half of it")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = runtime.resolve_device(args.device)
    mod = get_arch(args.arch)
    cfg = dataclasses.replace(mod.SMOKE if args.smoke else mod.FULL,
                              attn_impl="pallas")
    params = serve.init_params(cfg, 0, dev)
    res = {"batched": profile_batched(cfg, params, batch=BATCH,
                                      prompt_len=args.prompt_len,
                                      steps=args.steps, dev=dev)}
    if cfg.family != "ssm" and not cfg.n_codebooks:
        res["engine"] = profile_engine(cfg, params, slots=SLOTS,
                                       n_adapters=N_ADAPTERS,
                                       prompt_len=args.prompt_len // 2,
                                       steps=args.steps, dev=dev)
    return res


if __name__ == "__main__":
    main()
