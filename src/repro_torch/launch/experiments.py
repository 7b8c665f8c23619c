"""The paper's experiment runner: Tables I-II (F1, rare-modality F1, speedup
over FedAvg, time to accuracy, upload and energy per round), the scenario
matrix (missing-modality generators x async strategies), Table III (the
ablation), Tables IV-V (sensitivity), Figs. 2-3 (motivation), Fig. 5
(convergence), Fig. 6 (per-modality F1) and Fig. 8 (the device profile).

    python -m repro_torch.launch.experiments table --backbone b1|b2
        [--full] [--rounds 30] [--methods fedavg,relief]
        [--datasets pamap2,mhealth] [--device cuda|cpu]
    python -m repro_torch.launch.experiments scenarios
        --scenarios static30,stream30
        --methods async_relief,async_accessible,fedmfs_selective
        [--backbone b1|b2] [--full] [--updates 48] [--device cuda|cpu]
    python -m repro_torch.launch.experiments ablation [--backbone b1]
        [--datasets pamap2,mhealth] [--rounds 30]
    python -m repro_torch.launch.experiments sensitivity [--backbone b1]
        [--dataset pamap2] [--rounds 20]
    python -m repro_torch.launch.experiments convergence|permodality
        [--backbone b1] [--rounds 30]
    python -m repro_torch.launch.experiments device-profile
        [--backbone b1,b2] [--rounds 20]
    python -m repro_torch.launch.experiments motivation [--backbone b1]
        [--rounds 24]

Every subcommand but ``scenarios`` also takes ``--full``, ``--seed``,
``--device`` and ``--no-cache``; the defaults are those of the reference's
scripts under ``benchmarks/`` (each function here ports one and returns
its rows or dict). ``--full`` is the full-width model (``small=False``).
One run is one ``FedRun`` (tables, figures) or one ``AsyncFedRun``
(scenarios) built through the scenario API (``sim.scenarios``), the
reference's benchmark harness in the same order of construction. Finished
runs are cached as JSON under ``experiments_cache/`` at the repository
root, keyed by their whole configuration and the device, so the tables
and figures share them; ``--no-cache`` runs them again. The CSV and JSON
outputs go to the same directory. Every run prints its device (on the card
its name and power limit) beside its simulated and host times. The data is
the synthetic ``data/har.py`` provider, not the recorded PAMAP2/MHEALTH
sets.
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

from repro_torch.configs.relief_har import CONFIGS
from repro_torch.core import mdlora
from repro_torch.core import metrics as M
from repro_torch.core import strategies
from repro_torch.core.engine import FedConfig, FedRun
from repro_torch.core.tasks import MMTask
from repro_torch.data import get_provider, make_har_dataset
from repro_torch.kernels.runtime import resolve_device
from repro_torch.sim import (ScenarioSpec, build_fleet, get_scenario,
                             make_fleet, make_run)
from repro_torch.tree import leaves_with_path

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


def _runner(device, cache_dir):
    """-> one(spec): ``run_spec`` on ``device`` and ``cache_dir``, each
    configuration run once per call of a table or figure (also without a
    cache)."""
    done: dict[str, dict] = {}

    def one(spec: BenchSpec) -> dict:
        if spec.key() not in done:
            done[spec.key()] = run_spec(spec, device=device,
                                        cache_dir=cache_dir)
        return done[spec.key()]

    return one


def save_csv(rows: list[dict], path: Path | None, fields: list[str]) -> None:
    """``rows`` as CSV (the reference's format); nothing for no ``path``."""
    if path is None:
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(fields) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(k, "")) for k in fields) + "\n")


def _out(out_dir: Path | str | None, name: str) -> Path | None:
    return None if out_dir is None else Path(out_dir) / name


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
    one = _runner(device, cache_dir)
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


# relief is V0: the same (cached) run as the tables'
ABLATION_VARIANTS = ["relief", "v1", "v2", "v3"]
SENSITIVITY_METHODS = ["fedavg", "fedel", "relief"]
CONVERGENCE_METHODS = ["fedavg", "fedel", "harmony", "relief"]
PERMODALITY_METHODS = ["fedavg", "harmony", "relief"]
PROFILE_DATASETS = {"b1": "pamap2", "b2": "mhealth"}


def ablation(rounds: int = 30, seed: int = 0, backbones=("b1",),
             small: bool = True, datasets=("pamap2", "mhealth"),
             device: torch.device | str | None = None,
             cache_dir: Path | str | None = CACHE_DIR,
             out_dir: Path | str | None = CACHE_DIR) -> list[dict]:
    """Table III (``bench_ablation.py``): V0 (RELIEF), V1 (no elastic
    budgets), V2 (no cohort aggregation), V3 (random allocation): F1 per
    dataset, and the speedup and energy per round on PAMAP2 against FedAvg
    on PAMAP2."""
    one = _runner(device, cache_dir)
    rows = []
    for backbone in backbones:
        if "pamap2" in datasets:
            base = one(BenchSpec("fedavg", "pamap2", backbone, rounds, seed,
                                 small=small))
        for v in ABLATION_VARIANTS:
            row = {"variant": v, "backbone": backbone}
            for ds in datasets:
                r = one(BenchSpec(v, ds, backbone, rounds, seed,
                                  small=small))
                row[f"f1_{ds}"] = r["f1"]
                if ds == "pamap2":
                    row["speedup"] = (base["round_time_s"]
                                      / max(r["round_time_s"], 1e-9))
                    row["energy_j"] = r["energy_j"]
            rows.append(row)
    cols = [("variant", "variant"), ("backbone", "backbone"),
            ("PAMAP2 F1", "f1_pamap2"), ("MHEALTH F1", "f1_mhealth"),
            ("Speedup", "speedup"), ("J/r", "energy_j")]
    print(fmt_table(rows, cols, f"Table III (ablation, "
                                f"{'small' if small else 'full'} width, "
                                f"{rounds} rounds, synthetic data)"))
    save_csv(rows, _out(out_dir, "table_ablation.csv"), [k for _, k in cols])
    return rows


def sensitivity_specs(rounds: int = 20, seed: int = 0,
                      dataset: str = "pamap2", backbone: str = "b1",
                      small: bool = True
                      ) -> list[tuple[str, str, list[BenchSpec]]]:
    """Tables IV-V's settings -> [(factor, setting, a spec per method)]:
    compute gaps of 10x, 55x (the profile's default) and 100x, then fleets
    of N = 8, 20, 50 and 100 (only at 100 rounds or more, as in the
    reference) with ``max(40, 160 * 8 // N)`` windows per subject."""
    out = []
    for hetero in (10.0, None, 100.0):  # None = profile default (55x)
        label = {10.0: "mild_10x", None: "moderate_55x",
                 100.0: "extreme_100x"}[hetero]
        out.append(("hetero", label, [
            BenchSpec(m, dataset, backbone, rounds, seed,
                      hetero_scale=hetero, small=small)
            for m in SENSITIVITY_METHODS]))
    for n in (8, 20, 50, 100) if rounds >= 100 else (8,):
        out.append(("scale", f"N={n}", [
            BenchSpec(m, dataset, backbone, rounds, seed, n_clients=n,
                      windows=max(40, 160 * 8 // n), small=small)
            for m in SENSITIVITY_METHODS]))
    return out


def sensitivity(rounds: int = 20, seed: int = 0, dataset: str = "pamap2",
                backbone: str = "b1", small: bool = True,
                device: torch.device | str | None = None,
                cache_dir: Path | str | None = CACHE_DIR,
                out_dir: Path | str | None = CACHE_DIR) -> list[dict]:
    """Tables IV-V (``bench_sensitivity.py``): final F1 of FedAvg, FedEL
    and RELIEF per setting of ``sensitivity_specs``."""
    one = _runner(device, cache_dir)
    rows = []
    for factor, setting, specs in sensitivity_specs(rounds, seed, dataset,
                                                    backbone, small):
        row = {"factor": factor, "setting": setting}
        for spec in specs:
            row[spec.method] = one(spec)["f1"]
        rows.append(row)
    cols = ([("factor", "factor"), ("setting", "setting")]
            + [(m, m) for m in SENSITIVITY_METHODS])
    print(fmt_table(rows, cols, f"Tables IV-V (sensitivity, {dataset}, "
                                f"{backbone})"))
    save_csv(rows, _out(out_dir,
                        f"table_sensitivity_{dataset}_{backbone}.csv"),
             [k for _, k in cols])
    return rows


def convergence(rounds: int = 30, seed: int = 0, backbones=("b1",),
                small: bool = True,
                device: torch.device | str | None = None,
                cache_dir: Path | str | None = CACHE_DIR,
                out_dir: Path | str | None = CACHE_DIR) -> list[dict]:
    """Fig. 5 (``bench_convergence.py``): macro-F1 at each evaluated round,
    from the (cached) runs of the tables."""
    one = _runner(device, cache_dir)
    rows = []
    for backbone in backbones:
        for ds in ("pamap2", "mhealth"):
            for m in CONVERGENCE_METHODS:
                r = one(BenchSpec(m, ds, backbone, rounds, seed,
                                  small=small))
                for f1, rd in zip(r["f1_curve"], r["f1_rounds"]):
                    rows.append({"backbone": backbone, "dataset": ds,
                                 "method": m, "round": rd, "f1": f1})
    save_csv(rows, _out(out_dir, "fig_convergence.csv"),
             ["backbone", "dataset", "method", "round", "f1"])
    print("\n== Fig. 5 (convergence, final F1 by method) ==")
    last = {(r["backbone"], r["dataset"], r["method"]): r["f1"]
            for r in rows}
    for k, v in sorted(last.items()):
        print(f"  {k[0]} {k[1]:8s} {k[2]:12s} -> {v:.3f}")
    return rows


def permodality(rounds: int = 30, seed: int = 0, backbones=("b1",),
                small: bool = True,
                device: torch.device | str | None = None,
                cache_dir: Path | str | None = CACHE_DIR,
                out_dir: Path | str | None = CACHE_DIR) -> list[dict]:
    """Fig. 6 (``bench_permodality.py``): F1 with one modality present at a
    time, from the (cached) runs of the tables."""
    one = _runner(device, cache_dir)
    rows = []
    for backbone in backbones:
        for ds in ("pamap2", "mhealth"):
            for m in PERMODALITY_METHODS:
                r = one(BenchSpec(m, ds, backbone, rounds, seed,
                                  small=small))
                row = {"backbone": backbone, "dataset": ds, "method": m}
                row.update({f"f1_{k}": v
                            for k, v in r["per_modality_f1"].items()})
                rows.append(row)
    mods = sorted({k for row in rows for k in row if k.startswith("f1_")})
    cols = ([("backbone", "backbone"), ("dataset", "dataset"),
             ("method", "method")] + [(m[3:], m) for m in mods])
    print(fmt_table(rows, cols, "Fig. 6 (per-modality F1)"))
    save_csv(rows, _out(out_dir, "fig_permodality.csv"),
             [k for _, k in cols])
    return rows


def device_profile(rounds: int = 20, seed: int = 0, backbones=("b1", "b2"),
                   small: bool = True,
                   device: torch.device | str | None = None,
                   cache_dir: Path | str | None = CACHE_DIR,
                   out_dir: Path | str | None = CACHE_DIR) -> dict:
    """Fig. 8 (``bench_device_profile.py``): FedAvg and RELIEF under the
    paper's FLOP-proportional simulator and under the forward-aware timing
    model (Sec. VII: the full forward is a fixed cost), B1 on PAMAP2 and B2
    on MHEALTH, at most 8 rounds. The F1-against-energy curve adds one
    mean round's fleet energy per evaluation point, as the reference
    does."""
    rounds = min(rounds, 8)
    one = _runner(device, cache_dir)
    out = {}
    for backbone in backbones:
        ds = PROFILE_DATASETS[backbone]
        runs = {mode: {m: one(BenchSpec(m, ds, backbone, rounds, seed,
                                        sim_mode=mode, small=small))
                       for m in ("fedavg", "relief")}
                for mode in ("flop_proportional", "fwd_aware")}
        flop, fwd = runs["flop_proportional"], runs["fwd_aware"]
        sim_speed = flop["fedavg"]["round_time_s"] / \
            flop["relief"]["round_time_s"]
        real_speed = fwd["fedavg"]["round_time_s"] / \
            fwd["relief"]["round_time_s"]
        out[backbone] = {
            "sim_speedup_flop_proportional": sim_speed,
            "speedup_fwd_aware": real_speed,
            "gap_ratio": sim_speed / max(real_speed, 1e-9),
            "energy_save_pct_fwd_aware": 100 * (
                1 - fwd["relief"]["energy_j"]
                / max(fwd["fedavg"]["energy_j"], 1e-9)),
        }
        for m in ("fedavg", "relief"):
            r = fwd[m]
            cum_e = np.cumsum([r["energy_j"]] * len(r["f1_curve"]))
            out[backbone][f"{m}_f1_at_energy"] = list(
                zip(cum_e.tolist(), r["f1_curve"]))
        print(f"[device_profile:{backbone}] sim {sim_speed:.2f}x vs "
              f"fwd-aware {real_speed:.2f}x (gap "
              f"{out[backbone]['gap_ratio']:.2f}x), energy save "
              f"{out[backbone]['energy_save_pct_fwd_aware']:.0f}%")
    path = _out(out_dir, "device_profile.json")
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return out


def block_cosines(deltas: Any, layout, pairs) -> dict[str, list[float]]:
    """Per-block cosine similarity of the fusion leaf's update between
    client pairs, in float32 on the host (0.0 where either block is zero,
    as for an Acc-only client's Mag rows). -> {block name: [cos per
    pair]}"""
    fusion = dict(leaves_with_path(deltas))[layout.fusion_a_path]
    fusion = fusion.detach().float().cpu().numpy()  # [N, D, r]
    out = {}
    for s, e, g in layout.fusion_rows:
        cs = []
        for i, j in pairs:
            a, b = fusion[i, s:e].ravel(), fusion[j, s:e].ravel()
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            cs.append(float(a @ b / (na * nb)) if na > 1e-12 and nb > 1e-12
                      else 0.0)
        out[layout.names[g]] = cs
    return out


FULL_PAIRS = [(0, 1), (0, 2), (1, 2)]  # Full-Full
CROSS_PAIRS = [(0, 6), (1, 7), (2, 6)]  # Full vs Acc-only


def motivation(rounds: int = 24, seed: int = 0, backbone: str = "b1",
               small: bool = True, device: torch.device | str | None = None,
               cache_dir: Path | str | None = CACHE_DIR,
               params: Any = None) -> dict:
    """Figs. 2-3 (``bench_motivation.py``): FedAvg on PAMAP2's paper fleet
    (E = 2 x 4 steps), instrumented. Before each round it draws a second
    set of batches from the run's rng (``_round_batches``) and runs the
    local update with every group open on it, for the cosine of the fusion
    blocks' updates between Full-Full and Full-Acc-only client pairs (Fig.
    2, the mean over rounds 1-5); the rounds' own divergences, split into
    ``min(5, rounds)`` phases, give Fig. 3, and their Mag/Acc ratio
    Observation 2. The result is cached as JSON in ``cache_dir`` (None:
    neither read nor written); the weights come from ``seed`` unless
    ``params`` carries them."""
    dev = resolve_device(device)
    label = device_label(dev)
    cache = None
    if cache_dir is not None and params is None:
        tag = hashlib.md5(label.encode()).hexdigest()[:6]
        cache = Path(cache_dir) / (
            f"motivation_{backbone}_{'small' if small else 'full'}_r{rounds}"
            f"_s{seed}_{dev.type}{tag}.json")
        if cache.is_file():
            return json.loads(cache.read_text())
    ds = make_har_dataset("pamap2", windows_per_subject=160, seed=seed)
    fleet = make_fleet(3, 3, 2, M=4)
    cfg = CONFIGS[("pamap2", backbone) + (("small",) if small else ())]
    task, tr0 = MMTask.create(cfg, torch.Generator().manual_seed(seed),
                              params=params, device=dev)
    fed = FedConfig(rounds=rounds, eval_every=rounds, local_epochs=2,
                    steps_per_epoch=4, seed=seed)
    run = FedRun.create(task, tr0, strategies.get("fedavg"), fleet, fed)
    layout = task.layout
    gates = torch.ones((fleet.N, layout.G), dtype=torch.float32, device=dev)
    mmasks = torch.as_tensor(fleet.modality_mask, dtype=torch.float32,
                             device=dev)
    cos = {"full_full": [], "full_acconly": []}
    phase_div = []
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(rounds):
        batches = run._round_batches(ds)
        deltas, _ = run.local_update(run._start_trainable(), batches,
                                     mmasks, gates, fed.lr, run.rank_gate)
        cos["full_full"].append(block_cosines(deltas, layout, FULL_PAIRS))
        cos["full_acconly"].append(block_cosines(deltas, layout,
                                                 CROSS_PAIRS))
        phase_div.append(np.asarray(run.round(ds)["divergence"]).tolist())
    _sync(dev)
    wall = time.perf_counter() - t0
    # early rounds carry the shared descent direction (late-round deltas
    # are converged noise): the mean over rounds 1-5, the paper's early
    # phase
    fig2 = {pt: {blk: float(np.mean([np.mean(r[blk]) for r in recs[:5]]))
                 for blk in recs[0]}
            for pt, recs in cos.items()}
    phases = np.array_split(np.asarray(phase_div), min(5, rounds))
    fig3 = {layout.names[g]: [float(p[:, g].mean()) for p in phases]
            for g in layout.group_ids(mdlora.KIND_FUSION_BLOCK)}
    # Observation 2 (relative form): the rare block's divergence persists
    # while the common block's decays, so d_rare / d_acc grows
    ratios = [fig3["A_mag"][i] / max(fig3["A_acc"][i], 1e-12)
              for i in range(len(fig3["A_acc"]))]
    out = {"fig2_block_cosine": fig2, "fig3_divergence_phases": fig3,
           "obs2_rare_to_common_ratio": ratios, "device": label,
           "host_wall_s": wall}
    print(f"\n== Fig. 2: mean update cosine by block (rounds 1-5; "
          f"{backbone}, {'small' if small else 'full'} width) ==")
    print(f"{'block':10s} {'Full-Full':>10s} {'Full-AccOnly':>13s}")
    for blk in fig2["full_full"]:
        print(f"{blk:10s} {fig2['full_full'][blk]:10.3f} "
              f"{fig2['full_acconly'][blk]:13.3f}")
    print("\n== Fig. 3: fusion-block divergence by phase ==")
    for blk, vals in fig3.items():
        print(f"{blk:10s} " + " ".join(f"{v:.4f}" for v in vals))
    print("d(Mag)/d(Acc) by phase:", [round(r, 3) for r in ratios])
    print(f"[motivation] {rounds} instrumented FedAvg rounds: host "
          f"{wall:.2f}s ({wall / rounds:.3f} s/round) on {label}")
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(json.dumps(out, indent=1))
    return out


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


# subcommand -> (the reference script's defaults: rounds, backbone(s))
FIGURES = {"ablation": (30, "b1"), "sensitivity": (20, "b1"),
           "convergence": (30, "b1"), "permodality": (30, "b1"),
           "device-profile": (20, "b1,b2"), "motivation": (24, "b1")}


def main(argv: list[str] | None = None) -> list[dict] | dict:
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
    s = sub.add_parser("scenarios", help="the scenario matrix (async)")
    s.add_argument("--scenarios", default="static30,stream30")
    s.add_argument("--methods",
                   default="async_relief,async_accessible,fedmfs_selective")
    s.add_argument("--backbone", default="b1", choices=("b1", "b2"))
    s.add_argument("--updates", type=int, default=48,
                   help="absorbed client updates per cell")
    s.add_argument("--windows", type=int, default=60)
    figs = {}
    for cmd, (rounds, backbone) in FIGURES.items():
        figs[cmd] = f = sub.add_parser(cmd, help=f"the reference's bench_"
                                       f"{cmd.replace('-', '_')}.py")
        f.add_argument("--backbone", default=backbone,
                       help="b1 or b2; ablation, convergence, permodality "
                            "and device-profile take a comma-separated list")
        f.add_argument("--rounds", type=int, default=rounds)
    figs["ablation"].add_argument("--datasets", default="pamap2,mhealth")
    figs["sensitivity"].add_argument("--dataset", default="pamap2",
                                     choices=("pamap2", "mhealth"))
    for p in (t, s, *figs.values()):
        p.add_argument("--full", action="store_true",
                       help="the full-width model (small=False)")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu for the plain versions")
    for p in (t, *figs.values()):
        p.add_argument("--no-cache", action="store_true",
                       help="run again what the cache holds")
    args = ap.parse_args(argv)
    backbones = tuple(args.backbone.split(","))
    if not set(backbones) <= {"b1", "b2"} or len(backbones) > 1 and \
            args.cmd in ("sensitivity", "motivation"):
        ap.error(f"--backbone {args.backbone}: not a backbone of "
                 f"{args.cmd}")
    dev = resolve_device(args.device)
    print(f"[experiments] device: {device_label(dev)}")
    if args.cmd == "scenarios":
        return main_scenarios(args, dev)
    cache = None if args.no_cache else CACHE_DIR
    kw = dict(seed=args.seed, small=not args.full, device=dev,
              cache_dir=cache)
    if args.cmd == "table":
        return main_table(
            args.backbone, args.rounds,
            methods=args.methods.split(",") if args.methods else None,
            datasets=tuple(args.datasets.split(",")), **kw)
    if args.cmd == "motivation":
        return motivation(args.rounds, backbone=args.backbone, **kw)
    kw["out_dir"] = CACHE_DIR
    if args.cmd == "sensitivity":
        return sensitivity(args.rounds, dataset=args.dataset,
                           backbone=args.backbone, **kw)
    if args.cmd == "ablation":
        return ablation(args.rounds, backbones=backbones,
                        datasets=tuple(args.datasets.split(",")), **kw)
    return {"convergence": convergence, "permodality": permodality,
            "device-profile": device_profile}[args.cmd](
                args.rounds, backbones=backbones, **kw)


def main_scenarios(args, dev: torch.device) -> list[dict]:
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
