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
step (the sum of its kernel, copy and memset times: one stream, so they do
not overlap), the card's idle share, kernel launches per step and the
kernels that take the most device time. On the CPU only the host side is
traced.

The device defaults to the CUDA card and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import ModelConfig, get_arch, list_archs
from repro_torch.kernels import runtime
from repro_torch.launch import serve
from repro_torch.launch import step_fns as SF
from repro_torch.launch.serving_engine import ServingEngine
from repro_torch.models import api

BATCH, SLOTS, N_ADAPTERS = 8, 16, 16


def profile_steps(label: str, step, n: int, dev: torch.device) -> dict:
    """``n`` calls of ``step`` under the profiler -> per-call host wall,
    device busy time (None on the CPU), idle share, kernel launches and the
    top 8 kernels (or, on the CPU, host ops) by self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        wall = (time.perf_counter() - t0) / n
    avg = prof.key_averages()
    if cuda:
        events = [e for e in avg if e.device_type == DeviceType.CUDA]
        self_us = lambda e: e.self_device_time_total  # noqa: E731
    else:
        events = [e for e in avg if e.device_type == DeviceType.CPU]
        self_us = lambda e: e.self_cpu_time_total  # noqa: E731
    busy = sum(map(self_us, events)) / 1e6 / n if cuda else None
    res = {"wall_ms": wall * 1e3,
           "busy_ms": None if busy is None else busy * 1e3,
           "idle_share": None if busy is None else 1 - busy / wall,
           "launches": sum(e.count for e in avg
                           if e.key == "cudaLaunchKernel") / n,
           "top": [(e.key, self_us(e) / n / 1e3, e.count / n) for e in
                   sorted(events, key=self_us, reverse=True)[:8]]}
    print(f"[profile] {label}: {n} calls, host wall {res['wall_ms']:.2f} ms "
          "per call (profiler on), "
          + ("" if busy is None else
             f"device busy {res['busy_ms']:.2f} ms per call, idle share "
             f"{res['idle_share']:.1%}, ")
          + f"{res['launches']:.0f} cudaLaunchKernel per call; top "
          + ("device" if cuda else "host") + " time per call:", flush=True)
    for key, ms, count in res["top"]:
        print(f"[profile]   {ms:8.3f} ms {count:6.1f}x  {key[:90]}",
              flush=True)
    return res


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
