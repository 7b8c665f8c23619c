"""Serve one of the backbone architectures with batched greedy decoding over
its KV/SSM caches: the prompt is prefilled one position at a time through
the decode step (``step_fns.make_serve_step``), then ``--decode-steps``
tokens are decoded, as the reference's ``examples/serve_backbone.py`` does
with the same arguments and defaults (the SMOKE config of ``--arch``).

    python -m repro_torch.launch.serve_backbone [--arch hymba-1.5b]
        [--batch 4] [--prompt-len 32] [--decode-steps 24] [--seed 0]
        [--device cuda]

The weights and the prompts are drawn from ``--seed`` (``torch.Generator``:
the reference's JAX draws cannot be reproduced, so the tokens differ from
the reference script's; with the same weights and prompts they are equal).
Codebook configs (musicgen) take prompts [B, P, n_codebooks]. With
``cfg.attn_impl == "pallas"`` a dense model's decode step runs the flash
attention kernel (``kernels/flash_attention``) on the card; the SMOKE
configs keep the reference's "xla", the plain attention. The device
defaults to the CUDA card and raises without one; ``--device cpu`` runs on
the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig, get_arch, list_archs
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import step_fns as SF
from repro_torch.launch.serve import _sync, init_params
from repro_torch.models import api
from repro_torch.tree import leaves


def draw_prompts(cfg: ModelConfig, batch: int, prompt_len: int,
                 seed: int) -> torch.Tensor:
    """Prompt token ids [B, P] (codebooks: [B, P, n_codebooks]), int32,
    drawn on the CPU from ``seed``."""
    shape = ((batch, prompt_len, cfg.n_codebooks) if cfg.n_codebooks
             else (batch, prompt_len))
    return torch.randint(0, cfg.vocab, shape, dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def serve(cfg: ModelConfig, params: dict, prompts: torch.Tensor,
          decode_steps: int) -> dict:
    """Prefill ``prompts`` through the decode step, one position at a time,
    then ``decode_steps`` greedy steps, on the device of ``params``. ->
    the generated tokens [B, decode_steps] (codebooks [B, decode_steps,
    n_codebooks]; on the host) and host wall times taken after a device
    synchronize."""
    dev = leaves(params)[0].device
    B, P = prompts.shape[:2]
    max_len = P + decode_steps
    prompts = prompts.to(dev)
    serve_step = SF.make_serve_step(cfg)
    caches = api.init_caches(cfg, B, max_len, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    tok = prompts[:, :1]
    for pos in range(P):  # prefill through the decode path
        tok, caches = serve_step(params, caches, prompts[:, pos:pos + 1],
                                 pos)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    for pos in range(P, max_len):
        tok, caches = serve_step(params, caches, tok, pos)
        out.append(tok)
    gen = torch.cat(out, dim=1).cpu()  # waits for the last step
    t_decode = time.perf_counter() - t0
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise ValueError(f"decoded token ids outside [0, {cfg.vocab})")
    return {"tokens": gen, "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_s": decode_steps * B / max(t_decode, 1e-9)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="hymba-1.5b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).SMOKE
    params = init_params(cfg, args.seed, resolve_device(args.device))
    prompts = draw_prompts(cfg, args.batch, args.prompt_len, args.seed)
    res = serve(cfg, params, prompts, args.decode_steps)
    print(f"[serve] {args.arch} (smoke config): prefilled {args.prompt_len} "
          f"tokens in {res['prefill_s']:.2f}s, decoded {args.decode_steps} in "
          f"{res['decode_s']:.2f}s ({res['tok_s']:.1f} tok/s)")
    print(f"[serve] continuation[0]: "
          f"{res['tokens'][0].reshape(-1)[:16].tolist()}")
    return res


if __name__ == "__main__":
    main()
