"""Quickstart: RELIEF vs FedAvg on a synthetic PAMAP2 fleet.

Runs the paper's core comparison end to end, as the reference's
``examples/quickstart.py`` does with the same arguments and defaults: 8
heterogeneous clients (3 full-modality fast, 3 dual-modality mid, 2
single-modality slow), the narrow lightweight-CNN backbone (Backbone 1,
whose fusion is a cuBLAS product: no kernel of ``kernels/`` runs), 12
federated rounds, and a summary of F1, simulated round time, energy and
upload volume for both methods.

    python -m repro_torch.launch.quickstart [--rounds 12] [--seed 0]
        [--device cuda]

The device defaults to the CUDA card and raises without one; ``--device
cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import strategies
from repro_torch.core.engine import FedConfig, FedRun
from repro_torch.core.tasks import MMTask
from repro_torch.data import HARDataset, make_har_dataset, mm_config_for
from repro_torch.kernels.runtime import resolve_device
from repro_torch.sim import FleetConfig, make_fleet

METHODS = ("fedavg", "relief")
# the narrow CNN of the reference script
MODEL = dict(backbone="cnn", d_feat=16, d_fused=64, cnn_ch=(16, 32))


def build(rounds: int = 12, seed: int = 0,
          device: torch.device | str | None = None) -> tuple:
    """-> (task, tr0, fleet, fed, dataset), built as the reference script
    builds them."""
    ds = make_har_dataset("pamap2", windows_per_subject=160, seed=seed)
    fleet = make_fleet(3, 3, 2, M=4)  # paper's coupled cost gradient
    task, tr0 = MMTask.create(mm_config_for("pamap2", **MODEL),
                              torch.Generator().manual_seed(seed),
                              device=resolve_device(device))
    fed = FedConfig(rounds=rounds, eval_every=max(rounds // 4, 1),
                    utilization=2e-5, seed=seed)
    return task, tr0, fleet, fed, ds


def histories(task: MMTask, tr0, fleet: FleetConfig, fed: FedConfig,
              ds: HARDataset, names=METHODS, log_every: int = 0):
    """Each method in ``names`` from ``tr0``, in turn -> yields (name,
    history). With ``log_every``, a header names the method before its
    round log."""
    for name in names:
        if log_every:
            print(f"=> training with {name}")
        run = FedRun.create(task, tr0, strategies.get(name), fleet, fed)
        yield name, run.run(ds, log_every=log_every)


def compare(task: MMTask, tr0, fleet: FleetConfig, fed: FedConfig,
            ds: HARDataset) -> dict:
    """FedAvg, then RELIEF, each from ``tr0`` -> {name: history}."""
    return dict(histories(task, tr0, fleet, fed, ds,
                          log_every=max(fed.rounds // 4, 1)))


def summarize(results: dict) -> dict:
    """The summary table's numbers: last F1, mean round time, energy and
    upload per round of each method, RELIEF's speedup and energy saving."""
    fa, rl = results["fedavg"], results["relief"]
    s = {}
    for tag, h in (("fedavg", fa), ("relief", rl)):
        s[tag] = {"f1": h["f1"][-1],
                  "round_time_s": float(np.mean(h["round_time_s"])),
                  "energy_j": float(np.mean(h["energy_j"])),
                  "upload_mb": float(np.mean(h["upload_mb"]))}
    s["speedup"] = s["fedavg"]["round_time_s"] / s["relief"]["round_time_s"]
    s["energy_saving"] = 1 - s["relief"]["energy_j"] / s["fedavg"]["energy_j"]
    return s


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("=> synthesizing PAMAP2-like data (4 modalities, 12 activities)")
    task, tr0, fleet, fed, ds = build(args.rounds, args.seed, args.device)
    print(f"   fleet: {fleet.type_names} (TOPS: {fleet.tops.tolist()})")
    print(f"   parameter groups (G={task.layout.G}): {task.layout.names}")
    results = compare(task, tr0, fleet, fed, ds)
    s = summarize(results)
    fa, rl = s["fedavg"], s["relief"]
    print("\n================ quickstart summary ================")
    print(f"{'':14s}{'FedAvg':>10s}{'RELIEF':>10s}")
    print(f"{'macro-F1':14s}{fa['f1']:>10.3f}{rl['f1']:>10.3f}")
    print(f"{'round time':14s}{fa['round_time_s']:>9.2f}s"
          f"{rl['round_time_s']:>9.2f}s   (speedup {s['speedup']:.2f}x)")
    print(f"{'fleet energy':14s}{fa['energy_j']:>9.0f}J{rl['energy_j']:>9.0f}J"
          f"   (saving {100 * s['energy_saving']:.0f}%)")
    print(f"{'upload':14s}{fa['upload_mb']:>8.2f}MB{rl['upload_mb']:>8.2f}MB")
    if not rl["round_time_s"] < fa["round_time_s"]:
        raise RuntimeError("RELIEF should beat FedAvg on round time")
    return {"histories": results, "summary": s}


if __name__ == "__main__":
    main()
