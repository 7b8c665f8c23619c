"""Training launcher, the port of ``repro/launch/train.py``, with its flags
and defaults.

Two modes:
  backbone   LoRA fine-tune (or, with ``--train-mode full``, train every
             parameter of) one of the ten LM architectures on a synthetic
             token stream (``data/tokens.py``), on one device, with
             checkpoint/restart (``repro_torch.checkpoint``, the
             reference's tree ``{"params", "opt"}``, ``keep=2``).
  federated  the paper's RELIEF protocol (``core/engine.py``'s ``FedRun``)
             on synthetic PAMAP2/MHEALTH, with the reference's fleet and
             settings; on Backbone 2 its fusion projection runs the fused
             block-LoRA kernel (``kernels/mdlora``), forward and backward.

    python -m repro_torch.launch.train --arch phi3-medium-14b --smoke \\
        --steps 20 [--device cpu]
    python -m repro_torch.launch.train --mode federated --dataset pamap2 \\
        --backbone b2 --strategy relief --rounds 40 [--device cpu]

The device is the CUDA card unless ``--device cpu`` is given. The step
runs eagerly: the reference's ``jax.jit`` has no counterpart here, and a
CUDA graph of the train step is path work for later (``ROADMAP.md`` §1).
``--model-parallel`` above 1 raises: sharding arrives with
``dist/sharding.py`` (``ROADMAP.md`` §1, item 2).

One deliberate difference from the reference: ``--steps`` is the step the
run ends at, and a resumed run goes on through the token stream from the
saved step, so it repeats the uninterrupted run bit for bit. The
reference's resume runs ``--steps`` more steps over the stream's first
batches again. llava (vlm) trains with zero patch embeddings, as the
reference's launcher gives it; the loss covers the text positions.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, get_arch, list_archs
from repro_torch.core import strategies
from repro_torch.core.engine import FedConfig, FedRun
from repro_torch.core.tasks import MMTask
from repro_torch.data import (HARDataset, make_har_dataset, mm_config_for,
                              synthetic_token_batches)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import serve
from repro_torch.launch import step_fns as SF
from repro_torch.optim import adam_init
from repro_torch.sim import make_fleet

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
_BACKBONES = {"cnn": "cnn", "b1": "cnn", "b2": "transformer"}


@dataclasses.dataclass
class Backbone:
    """A backbone run's state: the params and Adam state after ``step``
    steps, on ``device``."""
    cfg: ModelConfig
    params: dict
    opt: dict
    step: int
    device: torch.device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ckpt_tree(bb: Backbone) -> dict:
    """The reference's checkpoint tree: Adam's step count is an int32
    leaf, as ``repro.optim.adam_init`` holds it."""
    opt = dict(bb.opt, t=torch.tensor(bb.opt["t"], dtype=torch.int32))
    return {"params": bb.params, "opt": opt}


def build_backbone(args: argparse.Namespace
                   ) -> tuple[Backbone, CheckpointManager]:
    """The run the command line describes: weights drawn on the device
    from ``--seed`` (``serve.init_params``), Adam over the trainable tree,
    and the state of the latest checkpoint in ``--ckpt-dir`` where there is
    one."""
    if args.model_parallel > 1:
        raise ValueError(
            f"--model-parallel {args.model_parallel}: one device only; "
            "model parallelism needs dist/sharding.py, which ROADMAP.md "
            "section 1, item 2 (distribution and launch) brings")
    dev = resolve_device(args.device)
    mod = get_arch(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.FULL
    params = serve.init_params(cfg, args.seed, dev)
    tr, _ = SF.split_trainable(params, args.train_mode)
    bb = Backbone(cfg, params, adam_init(tr), 0, dev)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    restored = ckpt.restore_latest(_ckpt_tree(bb))
    if restored is not None:
        state, meta = restored
        bb.params = state["params"]
        bb.opt = dict(state["opt"], t=int(state["opt"]["t"]))
        bb.step = meta["step"]
        print(f"[train] resumed from step {bb.step}")
    return bb, ckpt


def token_batches(bb: Backbone, args: argparse.Namespace):
    """The token stream from ``--seed`` from step ``bb.step`` on, each
    batch on the device (llava: with zero patches)."""
    cfg = bb.cfg
    stream = synthetic_token_batches(cfg.vocab, args.batch, args.seq,
                                     args.steps, seed=args.seed,
                                     n_codebooks=cfg.n_codebooks)
    for i, b in enumerate(stream):
        if i < bb.step:
            continue
        batch = {k: torch.as_tensor(v, device=bb.device)
                 for k, v in b.items()}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.n_patches, cfg.d_model),
                dtype=cfg.runtime_dtype(), device=bb.device)
        yield batch


def train_steps(bb: Backbone, args: argparse.Namespace,
                ckpt: CheckpointManager) -> dict:
    """Steps ``bb.step`` .. ``--steps`` - 1 of the stream, a checkpoint
    every ``--ckpt-every``. -> history: per step the loss, the gradient
    norm and the host seconds of the step after a device synchronize."""
    step_fn = SF.make_train_step(bb.cfg, lr=args.lr,
                                 train_mode=args.train_mode)
    hist = {"loss": [], "grad_norm": [], "step_s": []}
    t0 = time.perf_counter()
    for batch in token_batches(bb, args):
        t = time.perf_counter()
        bb.params, bb.opt, metrics = step_fn(bb.params, bb.opt, batch)
        _sync(bb.device)
        hist["step_s"].append(time.perf_counter() - t)
        hist["loss"].append(float(metrics["loss"]))
        hist["grad_norm"].append(float(metrics["grad_norm"]))
        bb.step += 1
        n = len(hist["loss"])
        if bb.step % args.log_every == 0:
            print(f"[train] step {bb.step} loss {hist['loss'][-1]:.4f} "
                  f"({(time.perf_counter() - t0) / n:.2f}s/step)")
        if bb.step % args.ckpt_every == 0:
            ckpt.save(bb.step, _ckpt_tree(bb), {"arch": args.arch})
    return hist


def train_backbone(args: argparse.Namespace) -> dict:
    bb, ckpt = build_backbone(args)
    hist = train_steps(bb, args, ckpt)
    final = hist["loss"][-1] if hist["loss"] else float("nan")
    print(f"[train] done at step {bb.step}, loss {final:.4f}")
    return hist


def federated_run(args: argparse.Namespace, params=None
                  ) -> tuple[FedRun, HARDataset]:
    """The reference's federated setting: ``--windows`` windows per
    subject, the paper fleet (3 full / 3 mid / 2 low devices for PAMAP2, 4
    low for MHEALTH), ``mm_config_for``'s model of the backbone, utilization
    2e-5. ``params`` carries the model's weights over (as
    ``MMTask.create`` takes them); otherwise they are drawn from
    ``--seed``."""
    dev = resolve_device(args.device)
    ds = make_har_dataset(args.dataset, windows_per_subject=args.windows,
                          seed=args.seed)
    n_low = 2 if args.dataset == "pamap2" else 4
    fleet = make_fleet(3, 3, n_low, M=4)
    cfg = mm_config_for(args.dataset, backbone=_BACKBONES.get(
        args.backbone, args.backbone))
    task, tr0 = MMTask.create(cfg, torch.Generator().manual_seed(args.seed),
                              params=params, device=dev)
    fed = FedConfig(rounds=args.rounds, eval_every=args.eval_every,
                    seed=args.seed, utilization=2e-5)
    return FedRun.create(task, tr0, strategies.get(args.strategy), fleet,
                         fed), ds


def train_federated(args: argparse.Namespace) -> dict:
    run, ds = federated_run(args)
    run.run(ds, log_every=args.eval_every)
    print(f"[federated] {args.strategy} final F1 "
          f"{run.history['f1'][-1]:.4f}")
    return run.history


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", default="backbone",
                    choices=["backbone", "federated"])
    ap.add_argument("--arch", default="phi3-medium-14b",
                    choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--train-mode", default="lora", choices=["lora", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    # federated
    ap.add_argument("--dataset", default="pamap2")
    ap.add_argument("--backbone", default="cnn")
    ap.add_argument("--strategy", default="relief")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--windows", type=int, default=160)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    if args.mode == "backbone":
        return train_backbone(args)
    return train_federated(args)


if __name__ == "__main__":
    main()
