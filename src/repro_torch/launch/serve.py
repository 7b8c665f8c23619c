"""Serving launcher: batched prefill + greedy decode with a KV cache, or the
continuous-batching multi-LoRA engine, for a ported LM architecture.

  python -m repro_torch.launch.serve --arch phi3-medium-14b [--smoke]
      [--engine] [--device cuda|cpu] [--attn-impl pallas|xla]
  python -m repro_torch.launch.serve --arch ARCH ...   (any of the ten:
      phi3-medium-14b, gemma2-27b, granite-3-8b, granite-34b, mixtral-8x7b,
      mixtral-8x22b, llava-next-34b, musicgen-large, mamba2-1.3b,
      hymba-1.5b)

``run_batched`` prefills B synthetic prompts through
``api.prefill_with_cache`` (one chunked forward for the attention families;
the exact token loop of decode steps for mamba2 and hymba, as the reference
does) and decodes them in lockstep, every row at the same position. The SSD
kernel runs in the full-prompt forward, ``step_fns.make_prefill_step``.
musicgen's prompts and tokens carry a codebook axis ([B, P, n_codebooks]);
for llava the CLI draws stub patch embeddings [B, n_patches, d_model] from
the seed on the device (``stub_patches``, the frontend the config
describes), which ``run_batched`` prepends to every prompt.
``run_engine`` serves N personalized adapters through
``launch/serving_engine.py``: requests with ragged prompts join and leave
the decode batch mid-stream, each row decoding with its own adapter and
modality mask through the gathered projection. llava's requests are text
only, and musicgen has no engine: the reference's engine takes no codebook
prompts, and this one raises on a codebook config.

In the port, ``attn_impl="pallas"`` and ``lora_impl="pallas"`` mean "the op
in ``kernels/``": on a CUDA tensor it launches the CUDA kernel
(``kernels/flash_attention``, ``kernels/mdlora``, ``kernels/ssd``), on a CPU
tensor it runs that op's plain version in ``ref.py``. "xla" means the plain
PyTorch path (the chunked attention and SSD scan, the plain gathered
projection). This launcher passes "pallas" for both by default; the
reference's launcher leaves them at "xla" because its CPU dry-run cannot
lower Pallas, and the configs keep the reference's "xla" default;
``--attn-impl xla`` selects the plain versions. In the dense family flash
attention runs where positions are shared by the batch: ``run_batched``'s
prefill and decode (hymba's attention is the plain one, as in the
reference).
The engine's rows sit at their own depths, so its attention is the plain
chunked attention and its kernel is the gathered projection (hymba: ``wq``,
``wv`` and the fusion ``wo``; mamba2 has no fusion projection, so no
engine).

The device defaults to the CUDA card and raises without one; ``--device
cpu`` runs everything with the plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_arch, list_archs
from repro_torch.kernels import runtime
from repro_torch.launch import step_fns as SF
from repro_torch.launch.serving_engine import (AdapterRegistry, Request,
                                               ServingEngine)
from repro_torch.models import api

# b of a trained adapter is nonzero; init's b = 0 would make every client's
# adapter the base model, so the demo draws b at this scale
ADAPTER_B_STD = 0.05


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def init_params(cfg: ModelConfig, seed: int,
                device: torch.device | str | None = None) -> dict:
    """Random weights drawn on ``device`` from ``seed``."""
    dev = runtime.resolve_device(device)
    return api.init_model(torch.Generator(device=dev).manual_seed(seed), cfg,
                          dev)


def stub_patches(cfg: ModelConfig, batch: int, seed: int,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """llava's stub vision frontend: patch embeddings [batch, n_patches,
    d_model] ~ N(0, 1) in the runtime dtype, drawn on ``device`` from
    ``seed``."""
    dev = runtime.resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, cfg.n_patches, cfg.d_model), generator=g,
                       device=dev).to(cfg.runtime_dtype())


def run_batched(cfg: ModelConfig, params: dict | None = None, *,
                batch: int = 4, prompt_len: int = 64, decode_steps: int = 32,
                seed: int = 0, device: torch.device | str | None = None,
                patches: torch.Tensor | None = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (after
    ``patches`` [B, n_patches, d_model], if given), then ``decode_steps``
    greedy decode steps. -> tokens [B, decode_steps] (audio [B,
    decode_steps, n_codebooks]; numpy), the prompts, the prefill's
    last-position logits [B, V] (audio [B, n_codebooks, V]; fp32, on the
    host) and host wall times taken after a device synchronize."""
    dev = runtime.resolve_device(device)
    if params is None:
        params = init_params(cfg, seed, dev)
    B, P = batch, prompt_len
    n_pre = 0 if patches is None else patches.shape[1]
    max_len = n_pre + P + decode_steps
    shape = (B, P, cfg.n_codebooks) if cfg.n_codebooks else (B, P)
    prompts = torch.randint(0, cfg.vocab, shape, dtype=torch.int32,
                            generator=torch.Generator().manual_seed(seed))
    serve_step = SF.make_serve_step(cfg)
    caches = api.init_caches(cfg, B, max_len, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = api.prefill_with_cache(params, cfg, caches,
                                            prompts.to(dev), patches=patches)
    tok = logits.argmax(-1).to(torch.int32)  # [B, 1] (audio [B, 1, CB])
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    for pos in range(n_pre + P, max_len):
        tok, caches = serve_step(params, caches, tok, pos)
        out.append(tok)
    gen = torch.cat(out, dim=1).cpu().numpy()  # waits for the last step
    t_decode = time.perf_counter() - t0
    if not ((gen >= 0).all() and (gen < cfg.vocab).all()):
        raise ValueError(f"decoded token ids outside [0, {cfg.vocab})")
    return {"tokens": gen, "prompts": prompts.numpy(),
            "prefill_logits": logits[:, 0].float().cpu(),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_ms_per_step": t_decode / decode_steps * 1e3,
            "tok_s": decode_steps * B / max(t_decode, 1e-9)}


def build_registry(cfg: ModelConfig, n_adapters: int, seed: int,
                   device: torch.device | str | None = None
                   ) -> AdapterRegistry:
    """``n_adapters`` clients "client-i", each with its own adapter and a
    modality mask over ``api.fusion_block_dims`` (each block present with
    probability 0.8, at least one present). Adapters are drawn on the CPU,
    so one seed gives the same adapters on every device."""
    dev = runtime.resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    reg = AdapterRegistry(cfg, capacity=n_adapters, device=dev)
    n_blocks = len(reg.block_dims)
    for i in range(n_adapters):
        lora = {"layers": api.init_lora(gen, cfg, "cpu")}
        for leaf in lora["layers"].values():
            leaf["b"].normal_(0.0, ADAPTER_B_STD, generator=gen)
        mm = (rng.random(n_blocks) < 0.8).astype(np.float32)
        mm[int(rng.integers(n_blocks))] = 1.0  # >= 1 modality present
        reg.register(f"client-{i}", lora, modality_mask=mm)
    return reg


def make_requests(cfg: ModelConfig, n: int, n_adapters: int, prompt_len: int,
                  min_prompt_len: int, new_tokens: int, seed: int
                  ) -> list[Request]:
    """``n`` requests, prompt lengths uniform in [min_prompt_len,
    prompt_len], round-robin over the clients."""
    rng = np.random.default_rng(seed + 2)
    reqs = []
    for r in range(n):
        plen = int(rng.integers(min_prompt_len, prompt_len + 1))
        reqs.append(Request(rid=f"req-{r}",
                            prompt=rng.integers(0, cfg.vocab, plen),
                            adapter=f"client-{r % n_adapters}",
                            max_new_tokens=new_tokens))
    return reqs


def run_engine(cfg: ModelConfig, params: dict | None = None, *,
               n_adapters: int = 4, batch: int = 4,
               n_requests: int | None = None, prompt_len: int = 64,
               min_prompt_len: int | None = None, decode_steps: int = 32,
               seed: int = 0, device: torch.device | str | None = None
               ) -> dict:
    """Serve ``n_requests`` (default 2 x batch, so slots recycle) over
    ``batch`` slots and ``n_adapters`` clients. -> the engine's result
    (outputs, tok/s, latency percentiles, decode step times) plus the
    ``registry``, ``requests`` and ``max_len`` it ran with."""
    dev = runtime.resolve_device(device)
    if params is None:
        params = init_params(cfg, seed, dev)
    reg = build_registry(cfg, n_adapters, seed, dev)
    reqs = make_requests(cfg, n_requests or 2 * batch, n_adapters,
                         prompt_len, min_prompt_len or max(2, prompt_len // 2),
                         decode_steps, seed)
    max_len = prompt_len + decode_steps + 2
    eng = ServingEngine(params, cfg, reg, batch_slots=batch, max_len=max_len,
                        lora_impl="pallas")
    for r in reqs:
        eng.submit(r)
    res = eng.run()
    res.update(registry=reg, requests=reqs, max_len=max_len)
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi3-medium-14b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced SMOKE config instead of FULL")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching multi-LoRA engine")
    ap.add_argument("--n-adapters", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--attn-impl", default="pallas", choices=("pallas", "xla"))
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    cfg = dataclasses.replace(mod.SMOKE if args.smoke else mod.FULL,
                              attn_impl=args.attn_impl)
    if args.engine:
        res = run_engine(cfg, n_adapters=args.n_adapters, batch=args.batch,
                         prompt_len=args.prompt_len,
                         decode_steps=args.decode_steps, seed=args.seed,
                         device=args.device)
        print(f"[serve/engine] {args.arch} on {args.device}: "
              f"{len(res['outputs'])} requests, {res['generated_tokens']} "
              f"tokens in {res['wall_s']:.2f}s ({res['tok_s']:.1f} tok/s, "
              f"p50 {res['latency_p50_s']:.3f}s, p99 "
              f"{res['latency_p99_s']:.3f}s)")
        print("[serve/engine] sample:", next(iter(res["outputs"].values()))
              [:16])
        return res
    patches = None
    if cfg.family == "vlm":
        patches = stub_patches(cfg, args.batch, args.seed, args.device)
    res = run_batched(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      decode_steps=args.decode_steps, seed=args.seed,
                      device=args.device, patches=patches)
    pre = "" if patches is None else f"{cfg.n_patches} patches + "
    print(f"[serve] {args.arch} on {args.device}: prefill {args.batch}x("
          f"{pre}{args.prompt_len} tokens) in {res['prefill_s']:.2f}s; decoded "
          f"{args.decode_steps}x{args.batch} in {res['decode_s']:.2f}s "
          f"({res['tok_s']:.1f} tok/s)")
    print("[serve] sample:", res["tokens"][0].reshape(-1)[:16].tolist())
    return res


if __name__ == "__main__":
    main()
