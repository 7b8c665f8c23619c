"""The paper's experiment runner: Tables I-II (F1, rare-modality F1, speedup
over FedAvg, time to accuracy, upload and energy per round) and the
scenario matrix (missing-modality generators x async strategies).

    python -m repro_torch.launch.experiments table --backbone b1|b2
        [--full] [--rounds 30] [--methods fedavg,relief]
        [--datasets pamap2,mhealth] [--device cuda|cpu]
    python -m repro_torch.launch.experiments scenarios
        --scenarios static30,stream30
        --methods async_relief,async_accessible,fedmfs_selective
        [--backbone b1|b2] [--full] [--updates 48] [--device cuda|cpu]

``--full`` is the full-width model (``small=False``). One run is one
``FedRun`` (tables) or one ``AsyncFedRun`` (scenarios) built through the
scenario API (``sim.scenarios``), the reference's benchmark harness in the
same order of construction. Finished table runs are cached as JSON under
``experiments_cache/`` at the repository root, keyed by their whole
configuration and the device; ``--no-cache`` runs them again. Every run
prints its device (on the card its name and power limit) beside its
simulated and host times. The data is the synthetic ``data/har.py``
provider, not the recorded PAMAP2/MHEALTH sets.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.core import strategies
from repro_torch.core.engine import FedConfig, FedRun
from repro_torch.core.tasks import MMTask
from repro_torch.data import get_provider
from repro_torch.kernels.runtime import resolve_device
from repro_torch.sim import ScenarioSpec, build_fleet, get_scenario, make_run

CACHE_DIR = Path(__file__).resolve().parents[3] / "experiments_cache"
# bump when the shape of a cached run changes
SCHEMA_VERSION = 1

RARE_MODALITIES = {"pamap2": ("mag", "hr"), "mhealth": ("mag", "ecg")}

# method display names / citations (paper Tables I-II rows)
METHOD_LABELS = {
    "fedavg": "FedAvg [AISTATS'17]", "fedprox": "FedProx [MLSys'20]",
    "fedel": "FedEL* [NeurIPS'25]", "fedicu": "FedICU* [ICML'25]",
    "darkdistill": "DarkDistill* [KDD'25]", "harmony": "Harmony* [MobiSys'23]",
    "pilot": "Pilot* [AAAI'25]", "fedsa_lora": "FedSA-LoRA* [ICLR'25]",
    "helora": "HeLoRA* [TOIT'25]", "fedlease": "FedLEASE* [NeurIPS'25]",
    "relief": "RELIEF (ours)", "v0": "RELIEF (V0)",
    "v1": "V1 w/o elastic", "v2": "V2 w/o cohort agg", "v3": "V3 random alloc",
}  # * = protocol-level reimplementation (see core/strategies.py docstrings)

METHODS_B1 = ["fedavg", "fedprox", "fedel", "fedicu", "darkdistill",
              "harmony", "pilot", "fedsa_lora", "helora", "fedlease",
              "relief"]
# B2's standard profile: the 6 methods the paper's B2 analysis centres on
METHODS_B2 = ["fedavg", "fedel", "harmony", "fedsa_lora", "helora",
              "relief"]
TABLE_COLUMNS = [("method", "method"), ("dataset", "dataset"), ("F1", "f1"),
                 ("RareF1", "rare_mod_f1"), ("Speedup", "speedup"),
                 ("TTA", "tta_rounds"), ("MB/r", "comm_mb"),
                 ("J/r", "energy_j"), ("Esave%", "energy_save_pct")]


@dataclasses.dataclass(frozen=True)
class BenchSpec:
    method: str
    dataset: str = "pamap2"
    backbone: str = "b1"  # b1 (CNN) | b2 (frozen transformer + LoRA)
    rounds: int = 30
    seed: int = 0
    hetero_scale: float | None = None  # None = profile default (55x)
    n_clients: int | None = None  # None = paper fleet (8 / 10)
    sim_mode: str = "flop_proportional"
    windows: int = 160
    small: bool = True  # reduced model configs

    def key(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return (f"{self.method}_{self.dataset}_{self.backbone}_r{self.rounds}"
                f"_s{self.seed}_" + hashlib.md5(blob.encode()).hexdigest()[:8])


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (the torch
    name alone where nvidia-smi is missing), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={torch.cuda.current_device()}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit unknown"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_bench(spec: BenchSpec, params: Any = None,
                device: torch.device | str | None = None
                ) -> tuple[FedRun, Any, MMTask]:
    """BenchSpec -> (FedRun, dataset, task) through the scenario API: one
    ScenarioSpec carries the fleet, model and training knobs. The weights
    are drawn from ``spec.seed`` unless ``params`` carries them."""
    sspec = ScenarioSpec(
        name=spec.key(), dataset=spec.dataset, missing="none",
        windows_per_subject=spec.windows,
        fleet=(3, 3, 2 if spec.dataset == "pamap2" else 4),
        n_clients=spec.n_clients, hetero_scale=spec.hetero_scale,
        strategy=spec.method,
        backbone="cnn" if spec.backbone == "b1" else "transformer",
        small_model=spec.small, rounds=spec.rounds,
        eval_every=max(spec.rounds // 10, 1), t_overhead=0.1,
        utilization=2e-5, seed=spec.seed)
    provider = get_provider(spec.dataset)
    fleet = build_fleet(sspec)
    ds = provider.build(seed=spec.seed, n_clients=fleet.N,
                        windows_per_subject=spec.windows)
    cfg = provider.mm_config(sspec.backbone, small=spec.small)
    task, tr0 = MMTask.create(
        cfg, generator=torch.Generator().manual_seed(spec.seed),
        params=params, device=device)
    fed = FedConfig.from_scenario(sspec, sim_mode=spec.sim_mode)
    run = FedRun.create(task, tr0, strategies.get(spec.method), fleet, fed)
    return run, ds, task


def run_spec(spec: BenchSpec, force: bool = False, verbose: bool = True,
             params: Any = None, device: torch.device | str | None = None,
             cache_dir: Path | str | None = CACHE_DIR) -> dict:
    """Run (or load from ``cache_dir``; None caches nothing) one federated
    run -> its metrics: the reference harness's keys, plus the device and
    the host wall of the run and of its per-modality evaluation."""
    dev = resolve_device(device)
    label = device_label(dev)
    cache = None
    if cache_dir is not None and params is None:
        tag = hashlib.md5(label.encode()).hexdigest()[:6]
        cache = Path(cache_dir) / "runs" / f"{spec.key()}_{dev.type}{tag}.json"
        if cache.is_file() and not force:
            cached = json.loads(cache.read_text())
            if cached.get("schema_version") == SCHEMA_VERSION:
                return cached

    run, ds, task = build_bench(spec, params, dev)
    _sync(dev)
    t0 = time.perf_counter()
    hist = run.run(ds, log_every=0)
    _sync(dev)
    t1 = time.perf_counter()
    xs = np.concatenate(ds.test_x)
    ys = np.concatenate(ds.test_y)
    per_mod = task.eval_per_modality(run.state.trainable, xs, ys)
    _sync(dev)
    t2 = time.perf_counter()
    rare = M.rare_modality_f1(per_mod, RARE_MODALITIES[spec.dataset])
    out = {
        "schema_version": SCHEMA_VERSION,
        "spec": dataclasses.asdict(spec),
        "f1": hist["f1"][-1],
        "f1_curve": hist["f1"],
        "f1_rounds": hist["f1_round"],
        "per_modality_f1": per_mod,
        "rare_mod_f1": rare,
        "round_time_s": float(np.mean(hist["round_time_s"])),
        "round_times": hist["round_time_s"],
        "energy_j": float(np.mean(hist["energy_j"])),
        "upload_mb": float(np.mean(hist["upload_mb"])),
        "loss_curve": hist["loss"],
        "divergence_final": np.asarray(hist["divergence"][-1]).tolist(),
        "divergence_curves": np.asarray(hist["divergence"]).tolist(),
        "group_names": task.layout.names,
        "selected_frac": float(np.mean(hist["selected_frac"])),
        "device": label,
        "host_wall_s": t1 - t0,
        "host_per_modality_s": t2 - t1,
    }
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(json.dumps(out))
    if verbose:
        print(f"  [{spec.method:12s}] F1 {out['f1']:.3f} rare {rare:.3f} "
              f"t/r {out['round_time_s']:.2f}s E/r {out['energy_j']:.0f}J "
              f"{out['upload_mb']:.2f}MB | host {out['host_wall_s']:.2f}s "
              f"for {spec.rounds} rounds "
              f"({out['host_wall_s'] / spec.rounds:.3f} s/round) + "
              f"{out['host_per_modality_s']:.2f}s per-modality eval on "
              f"{label}")
    return out


def tta_rounds(f1_curve, f1_rounds, threshold: float):
    for f, r in zip(f1_curve, f1_rounds):
        if f >= threshold:
            return r
    return None


def fmt_table(rows: list[dict], columns: list[tuple[str, str]],
              title: str) -> str:
    lines = [f"\n== {title} ==",
             " | ".join(h for h, _ in columns),
             "-|-".join("-" * len(h) for h, _ in columns)]
    for row in rows:
        cells = []
        for _, k in columns:
            v = row.get(k, "")
            cells.append(f"{v:.3f}" if isinstance(v, float) else str(v))
        lines.append(" | ".join(cells))
    return "\n".join(lines)


def main_table(backbone: str = "b1", rounds: int = 30, seed: int = 0,
               methods=None, small: bool = True,
               datasets=("pamap2", "mhealth"),
               device: torch.device | str | None = None,
               cache_dir: Path | str | None = CACHE_DIR) -> list[dict]:
    """Tables I (b1) and II (b2): each method against FedAvg on the same
    fleet, dataset and seed. Speedup is FedAvg's simulated round time over
    the method's, TTA the first evaluated round at 95% of FedAvg's final
    F1, Esave% the energy per round saved against FedAvg."""
    methods = methods or (METHODS_B1 if backbone == "b1" else METHODS_B2)
    done: dict[str, dict] = {}

    def one(spec: BenchSpec) -> dict:
        if spec.key() not in done:
            done[spec.key()] = run_spec(spec, device=device,
                                        cache_dir=cache_dir)
        return done[spec.key()]

    rows = []
    for ds in datasets:
        print(f"[experiments:{backbone}] dataset={ds}")
        base = one(BenchSpec("fedavg", ds, backbone, rounds, seed,
                             small=small))
        thresh = 0.95 * base["f1"]
        for m in methods:
            r = one(BenchSpec(m, ds, backbone, rounds, seed, small=small))
            tta = tta_rounds(r["f1_curve"], r["f1_rounds"], thresh)
            rows.append({
                "method": METHOD_LABELS.get(m, m), "dataset": ds,
                "backbone": backbone, "f1": r["f1"],
                "rare_mod_f1": r["rare_mod_f1"],
                "speedup": base["round_time_s"] / max(r["round_time_s"],
                                                      1e-9),
                "tta_rounds": tta if tta is not None else "-",
                "comm_mb": r["upload_mb"],
                "energy_j": r["energy_j"],
                "energy_save_pct": 100 * (1 - r["energy_j"]
                                          / max(base["energy_j"], 1e-9)),
                "device": r["device"], "host_wall_s": r["host_wall_s"],
            })
    print(fmt_table(rows, TABLE_COLUMNS,
                    f"Table {'I' if backbone == 'b1' else 'II'} "
                    f"(Backbone {backbone}, {rounds} rounds, "
                    f"{'small' if small else 'full'} width, synthetic data)"))
    return rows


def scenario_cell(scenario: str, method: str, total_updates: int = 48,
                  windows: int = 60, seed: int = 0, backbone: str = "b1",
                  small: bool = True,
                  device: torch.device | str | None = None) -> dict:
    """One (scenario, strategy) cell of the scenario matrix on the heap
    async runtime: the library scenario with the reference benchmark's
    short local training (E=1 x 2 steps of batch 16), ``total_updates``
    absorbed client updates, one evaluation at the end."""
    dev = resolve_device(device)
    spec = get_scenario(
        scenario, strategy=method, seed=seed, windows_per_subject=windows,
        local_epochs=1, steps_per_epoch=2, batch_size=16, eval_every=0,
        total_updates=total_updates,
        backbone="cnn" if backbone == "b1" else "transformer",
        small_model=small)
    run, sc = make_run(spec, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    hist = run.run(sc.dataset)
    _sync(dev)
    wall = time.perf_counter() - t0
    return {
        "scenario": scenario, "method": method,
        "missing": spec.missing, "missing_ratio": spec.missing_ratio,
        "f1": round(float(hist["f1"][-1]), 4),
        "upload_mb": round(float(run.trace.upload_mb), 6),
        "sim_time_s": round(float(run.state.sim_time), 4),
        "flushes": int(run.trace.flushes),
        "staleness_mean": round(float(np.mean(hist["staleness_mean"])), 3),
        "selected_frac": round(float(np.mean(hist["selected_frac"])), 4),
        "wall_s": round(wall, 3),
        "device": device_label(dev),
    }


def selective_gate(rows: list[dict]) -> list[str]:
    """fedmfs_selective is async_accessible plus the selective uploader
    (the same training and dispatch), so on every scenario they share it
    must upload strictly fewer bytes. -> the failures."""
    cur = {(r["scenario"], r["method"]): r for r in rows}
    failures = []
    for (scenario, method), row in cur.items():
        ref = cur.get((scenario, "async_accessible"))
        if method != "fedmfs_selective" or ref is None:
            continue
        ok = row["upload_mb"] < ref["upload_mb"]
        print(f"selective gate: {scenario} {row['upload_mb']:.4f}MB vs "
              f"accessible {ref['upload_mb']:.4f}MB "
              f"{'OK' if ok else 'FAIL'} (dF1 {row['f1'] - ref['f1']:+.3f})")
        if not ok:
            failures.append(scenario)
    return failures


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("table", help="Tables I-II (sync FedRun)")
    t.add_argument("--backbone", default="b1", choices=("b1", "b2"))
    t.add_argument("--rounds", type=int, default=30)
    t.add_argument("--methods", default=None,
                   help="comma-separated; default the table's method list")
    t.add_argument("--datasets", default="pamap2,mhealth")
    t.add_argument("--no-cache", action="store_true")
    s = sub.add_parser("scenarios", help="the scenario matrix (async)")
    s.add_argument("--scenarios", default="static30,stream30")
    s.add_argument("--methods",
                   default="async_relief,async_accessible,fedmfs_selective")
    s.add_argument("--backbone", default="b1", choices=("b1", "b2"))
    s.add_argument("--updates", type=int, default=48,
                   help="absorbed client updates per cell")
    s.add_argument("--windows", type=int, default=60)
    for p in (t, s):
        p.add_argument("--full", action="store_true",
                       help="the full-width model (small=False)")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"[experiments] device: {device_label(dev)}")
    if args.cmd == "table":
        return main_table(
            args.backbone, args.rounds, args.seed,
            args.methods.split(",") if args.methods else None,
            small=not args.full, datasets=tuple(args.datasets.split(",")),
            device=dev, cache_dir=None if args.no_cache else CACHE_DIR)
    rows = []
    for scenario in args.scenarios.split(","):
        for method in args.methods.split(","):
            row = scenario_cell(scenario, method, args.updates, args.windows,
                                args.seed, args.backbone, not args.full, dev)
            rows.append(row)
            print(f"  {scenario:10s} {method:18s} F1 {row['f1']:.3f} "
                  f"up {row['upload_mb']:8.4f}MB sel "
                  f"{row['selected_frac']:.2f} flushes {row['flushes']} "
                  f"host {row['wall_s']:6.2f}s on {row['device']}")
    if selective_gate(rows):
        raise SystemExit("selective upload did not cut the upload bytes")
    return rows


if __name__ == "__main__":
    main()
