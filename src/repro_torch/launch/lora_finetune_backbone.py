"""LoRA fine-tune a backbone's SMOKE configuration on a synthetic token
stream with the production train step (Adam + global-norm clip), saving the
LoRA tree every 10 steps: the port of ``examples/lora_finetune_backbone.py``.
It raises unless the loss falls.

    python -m repro_torch.launch.lora_finetune_backbone --arch gemma2-27b \\
        --steps 30 [--device cpu]

Kept deviations from the reference's example: the weights are drawn from
``--seed`` by a ``torch.Generator`` (the reference's JAX draws cannot be
reproduced), and ``--ckpt-dir`` defaults to ``repro_torch_lora_ft_ckpt``
under the temporary directory, not the reference's fixed
``lora_ft_ckpt``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.data import synthetic_token_batches
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import serve
from repro_torch.launch import step_fns as SF
from repro_torch.models import api
from repro_torch.optim import adam_init
from repro_torch.tree import leaves


def main(argv: list[str] | None = None) -> list[float]:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="gemma2-27b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lora_ft_ckpt"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).SMOKE
    params = serve.init_params(cfg, args.seed, dev)
    tr, _ = SF.split_trainable(params, "lora")
    n_tr = sum(x.numel() for x in leaves(tr))
    n_all = api.param_count(params)
    print(f"[lora-ft] {args.arch} smoke: {n_all:,} params, {n_tr:,} "
          f"trainable LoRA ({100 * n_tr / n_all:.2f}%), device {dev}")

    opt = adam_init(tr)
    step_fn = SF.make_train_step(cfg, lr=args.lr, train_mode="lora")
    ckpt = CheckpointManager(args.ckpt_dir, keep=1)

    losses = []
    t0 = time.perf_counter()
    for i, b in enumerate(synthetic_token_batches(
            cfg.vocab, args.batch, args.seq, args.steps, seed=args.seed,
            n_codebooks=cfg.n_codebooks)):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.n_patches, cfg.d_model), device=dev)
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if (i + 1) % 10 == 0:
            print(f"[lora-ft] step {i + 1:3d} loss {losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
            ckpt.save(i + 1, {"lora": params["lora"]})
    print(f"[lora-ft] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(improved {losses[0] - losses[-1]:.3f})")
    if not losses[-1] < losses[0]:
        raise RuntimeError("LoRA fine-tuning did not reduce the loss: "
                           f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
