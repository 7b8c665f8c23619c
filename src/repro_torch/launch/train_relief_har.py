"""The paper's synchronous RELIEF training (Algorithm 1, ``FedRun``) on its
HAR setting: full-width Backbone 2 by default (frozen patch-transformer
encoders, LoRA rho=8 on Q/V/FFN, the block-LoRA fusion layer through the
fused CUDA kernel), the paper fleet (3 full / 3 mid / 2 low devices for
PAMAP2, 4 low for MHEALTH), E=5 x 4 steps of batch 32, and a per-modality
F1 breakdown at the end (paper Fig. 6).

    python -m repro_torch.launch.train_relief_har [--dataset pamap2]
        [--backbone b2] [--strategy relief] [--rounds 50] [--dropout 0.1]
        [--small] [--seed 0] [--device cuda]
        [--ckpt-dir DIR] [--ckpt-every 20]

With ``--ckpt-dir`` the server state is saved every ``--ckpt-every`` rounds
(``repro_torch.checkpoint``, the reference's layout), and a run started on
a directory that holds a checkpoint resumes from its latest one, as the
reference's ``examples/train_relief_har.py`` does: it restores the global
trainable tree and the divergence EMA ``dbar`` and goes on from the saved
round. The round counter, the rng, the magnitude EMA, the per-client state
and the history start fresh, so a resumed run does not repeat the
uninterrupted one.

Kept deviation from the reference's example: ``examples/train_relief_har.py``
defaults to MHEALTH, 200 rounds, the narrow model (``d_feat=16,
d_fused=64``; Backbone 2 with ``enc_layers=2, enc_d=32, enc_ff=64``) and a
fixed checkpoint directory (``relief_ckpt``); this entry point defaults to
PAMAP2, 50 rounds, the paper's full width (``configs.relief_har``) and no
checkpoint.
``--dataset mhealth --small --rounds 200 --ckpt-dir DIR`` builds exactly the
reference example's model, fleet and ``FedConfig``. The reference evaluates
only every 10 rounds (its final F1 line needs 10 or more); this one also
evaluates after the last round.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.relief_har import CONFIGS
from repro_torch.core import strategies
from repro_torch.core.engine import FedConfig, FedRun
from repro_torch.core.tasks import MMTask
from repro_torch.data import HARDataset, make_har_dataset
from repro_torch.kernels.runtime import resolve_device
from repro_torch.sim import make_fleet
from repro_torch.tree import leaves

WINDOWS_PER_SUBJECT = 200


def build(dataset: str = "pamap2", backbone: str = "b2",
          strategy: str = "relief", rounds: int = 50, dropout: float = 0.1,
          small: bool = False, seed: int = 0,
          device: torch.device | str | None = None
          ) -> tuple[FedRun, HARDataset]:
    """The run the command line describes, ready for ``run.run(dataset)``:
    the settings of the reference's ``examples/train_relief_har.py``
    (``windows_per_subject=200``, utilization 2e-5, eval every 10 rounds,
    FedConfig's E=5 x 4 steps of batch 32 at lr 1e-3) at the configuration
    ``configs.relief_har`` names."""
    dev = resolve_device(device)
    ds = make_har_dataset(dataset, windows_per_subject=WINDOWS_PER_SUBJECT,
                          seed=seed)
    fleet = make_fleet(3, 3, 2 if dataset == "pamap2" else 4, M=4)
    cfg = CONFIGS[(dataset, backbone) + (("small",) if small else ())]
    task, tr0 = MMTask.create(cfg, torch.Generator().manual_seed(seed),
                              device=dev)
    fed = FedConfig(rounds=rounds, eval_every=10, seed=seed,
                    utilization=2e-5, dropout_prob=dropout)
    return FedRun.create(task, tr0, strategies.get(strategy), fleet, fed), ds


def resume(run: FedRun, ckpt: CheckpointManager) -> int:
    """Load the latest checkpoint's trainable tree and ``dbar`` into
    ``run`` -> the round to go on from (0 when there is none)."""
    restored = ckpt.restore_latest({"trainable": run.state.trainable})
    if restored is None:
        return 0
    tree, meta = restored
    run.state.trainable = tree["trainable"]
    run.state.dbar = np.asarray(meta["dbar"])
    return meta["step"]


def train(run: FedRun, ds: HARDataset, rounds: int, start: int = 0,
          ckpt: CheckpointManager | None = None,
          ckpt_every: int = 20) -> dict:
    """Rounds ``start`` .. ``rounds`` - 1: an evaluation every
    ``eval_every`` rounds and after the last, a checkpoint (metadata
    ``dbar`` and ``strategy``) every ``ckpt_every``. From round 0 without
    ``ckpt`` this is ``run.run(ds)``."""
    every = run.fed.eval_every
    for r in range(start, rounds):
        rec = run.round(ds)
        if (r + 1) % every == 0 or r == rounds - 1:
            f1 = run.evaluate(ds)
            run.history["f1"].append(f1)
            run.history["f1_round"].append(rec["round"])
            print(f"[round {r + 1:4d}] loss {rec['loss']:.4f} F1 {f1:.4f} "
                  f"t/r {rec['round_time_s']:.2f}s "
                  f"sel {rec['selected_frac']:.2f}")
        if ckpt is not None and (r + 1) % ckpt_every == 0:
            ckpt.save(r + 1, {"trainable": run.state.trainable},
                      {"dbar": run.state.dbar.tolist(),
                       "strategy": run.strategy.name})
    return run.history


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--dataset", default="pamap2",
                    choices=("pamap2", "mhealth"))
    ap.add_argument("--backbone", default="b2", choices=("b1", "b2"))
    ap.add_argument("--strategy", default="relief",
                    help=f"one of {strategies.names()}")
    ap.add_argument("--dropout", type=float, default=0.1,
                    help="per-round client failure probability")
    ap.add_argument("--small", action="store_true",
                    help="the reduced configuration (d_feat 16, d_fused 64; "
                         "B2: 2 encoder layers of width 32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save (and resume from) checkpoints here; none "
                         "without it")
    ap.add_argument("--ckpt-every", type=int, default=20)
    args = ap.parse_args(argv)

    run, ds = build(args.dataset, args.backbone, args.strategy, args.rounds,
                    args.dropout, args.small, args.seed, args.device)
    task = run.task
    n_train = sum(t.numel() for t in leaves(run.state.trainable))
    n_total = sum(t.numel() for t in leaves(task.params(run.state.trainable)))
    print(f"[train_relief_har] {args.dataset}/{args.backbone}: "
          f"{n_total:,} params, {n_train:,} trainable "
          f"({100 * n_train / n_total:.2f}%), G={task.layout.G} groups, "
          f"fleet N={run.fleet.N}, client dropout p={args.dropout}, "
          f"strategy {args.strategy}, device={args.device}")
    ckpt, start = None, 0
    if args.ckpt_dir is not None:
        ckpt = CheckpointManager(args.ckpt_dir, keep=2)
        start = resume(run, ckpt)
        if start:
            print(f"[train_relief_har] resumed from round {start} "
                  f"({args.ckpt_dir})")
    if start >= args.rounds:
        print(f"[train_relief_har] nothing to run: the checkpoint is at "
              f"round {start}, --rounds {args.rounds}")
        return run.history
    t0 = time.perf_counter()
    hist = train(run, ds, args.rounds, start, ckpt, args.ckpt_every)
    print(f"[train_relief_har] {run.state.round} rounds: loss "
          f"{hist['loss'][-1]:.4f}, F1 {hist['f1'][-1]:.4f}, simulated "
          f"{sum(hist['round_time_s']):.2f}s, energy "
          f"{sum(hist['energy_j']):.1f}J, upload "
          f"{sum(hist['upload_mb']):.3f}MB, host "
          f"{time.perf_counter() - t0:.1f}s")
    per_mod = task.eval_per_modality(run.state.trainable,
                                     np.concatenate(ds.test_x),
                                     np.concatenate(ds.test_y))
    print("[train_relief_har] per-modality F1 (paper Fig. 6): "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_mod.items()))
    return hist


if __name__ == "__main__":
    main()
