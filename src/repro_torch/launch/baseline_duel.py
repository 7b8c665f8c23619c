"""Head-to-head: all 11 federated methods on one fleet (reduced Table I).

The ten baselines of ``core/strategies.py`` ``ALL_BASELINES`` and RELIEF,
in that order, each from the same initial weights on the paper fleet (3
full / 3 mid / 2 low devices for PAMAP2, 4 low otherwise) with the narrow
CNN (Backbone 1: no kernel of ``kernels/`` runs), as the reference's
``examples/baseline_duel.py`` does with the same arguments and defaults.
The table is sorted by F1, with each method's speedup over FedAvg.

    python -m repro_torch.launch.baseline_duel [--rounds 10]
        [--dataset pamap2] [--seed 0] [--device cuda]

The device defaults to the CUDA card and raises without one; ``--device
cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.engine import FedConfig
from repro_torch.core.strategies import ALL_BASELINES
from repro_torch.core.tasks import MMTask
from repro_torch.data import HARDataset, make_har_dataset, mm_config_for
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.quickstart import MODEL, histories
from repro_torch.sim import FleetConfig, make_fleet

METHODS = (*ALL_BASELINES, "relief")


def build(dataset: str = "pamap2", rounds: int = 10, seed: int = 0,
          device: torch.device | str | None = None) -> tuple:
    """-> (task, tr0, fleet, fed, dataset), built as the reference script
    builds them."""
    ds = make_har_dataset(dataset, windows_per_subject=120, seed=seed)
    fleet = make_fleet(3, 3, 2 if dataset == "pamap2" else 4, M=4)
    task, tr0 = MMTask.create(mm_config_for(dataset, **MODEL),
                              torch.Generator().manual_seed(seed),
                              device=resolve_device(device))
    fed = FedConfig(rounds=rounds, eval_every=rounds, utilization=2e-5,
                    seed=seed)
    return task, tr0, fleet, fed, ds


def duel(task: MMTask, tr0, fleet: FleetConfig, fed: FedConfig,
         ds: HARDataset, names=METHODS) -> list[tuple]:
    """Each method in ``names`` from ``tr0`` -> rows (name, last F1, mean
    round time s, energy J per round, upload MB per round)."""
    rows = []
    for name, h in histories(task, tr0, fleet, fed, ds, names):
        rows.append((name, h["f1"][-1], float(np.mean(h["round_time_s"])),
                     float(np.mean(h["energy_j"])),
                     float(np.mean(h["upload_mb"]))))
        print(f"  {name:12s} F1 {rows[-1][1]:.3f} t/r {rows[-1][2]:.2f}s")
    return rows


def main(argv: list[str] | None = None) -> list[tuple]:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--dataset", default="pamap2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rows = duel(*build(args.dataset, args.rounds, args.seed, args.device))
    base_t = next(r[2] for r in rows if r[0] == "fedavg")
    print(f"\n{'method':14s}{'F1':>7s}{'t/r':>8s}{'speedup':>9s}"
          f"{'J/r':>8s}{'MB/r':>7s}")
    for name, f1, t, e, mb in sorted(rows, key=lambda r: -r[1]):
        print(f"{name:14s}{f1:7.3f}{t:8.2f}{base_t / t:9.2f}x{e:8.0f}"
              f"{mb:7.2f}")
    return rows


if __name__ == "__main__":
    main()
