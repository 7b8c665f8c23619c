"""Fleet-scale async simulation: N clients, buffered flushes, churn.

Drives the vectorized structure-of-arrays runtime
(``core/async_engine.py`` ``VectorizedAsyncFedRun``) in pure
system-simulation mode (per-client timing, energy, staleness and
population churn for fleets up to 10^6 devices, no gradient work) and
prints the staleness distribution and wall-clock throughput, as the
reference's ``examples/fleet_scale_sim.py`` does with the same arguments
and defaults.

    python -m repro_torch.launch.fleet_scale_sim [--n 100000]
        [--flushes 300] [--buffer 64] [--churn-rate 0.0]
        [--arrival-rate 0.0] [--jitter 0.1] [--seed 0] [--device cuda]

A system-only flush carries no deltas, so no kernel runs on this path: its
cost is the host's numpy. The model is still built on ``--device``, which
defaults to the CUDA card and raises without one; ``--device cpu`` runs on
the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.async_engine import (AsyncFedConfig,
                                           VectorizedAsyncFedRun)
from repro_torch.core.tasks import MMTask
from repro_torch.data import get_provider
from repro_torch.kernels.runtime import resolve_device
from repro_torch.sim import FleetConfig, ScenarioSpec


def build(n: int = 100_000, buffer: int = 64, churn_rate: float = 0.0,
          arrival_rate: float = 0.0, jitter: float = 0.1, seed: int = 0,
          device: torch.device | str | None = None
          ) -> VectorizedAsyncFedRun:
    """The reference script's run: a ``ScenarioSpec`` in grad mode "none"
    drives the fleet and the runtime config; no dataset is built."""
    spec = ScenarioSpec(
        "fleet_scale", n_clients=n, strategy="async_relief",
        strategy_args=(("buffer_size", buffer),), rounds=1,
        local_epochs=1, steps_per_epoch=1, batch_size=4, eval_every=0,
        jitter_sigma=jitter, grad_mode="none", seed=seed)
    fleet = FleetConfig.from_scenario(spec)
    cfg = get_provider(spec.dataset).mm_config(spec.backbone,
                                               small=spec.small_model)
    task, tr0 = MMTask.create(cfg, torch.Generator().manual_seed(seed),
                              device=resolve_device(device))
    fed = AsyncFedConfig.from_scenario(spec, churn_rate=churn_rate,
                                       arrival_rate=arrival_rate)
    return VectorizedAsyncFedRun.create(task, tr0, spec.build_strategy(),
                                        fleet, fed)


def summary(run: VectorizedAsyncFedRun, wall: float) -> dict:
    """Every number the reference script prints, for a run that took
    ``wall`` host seconds."""
    stale = np.asarray(run.history["staleness_mean"])
    ups = run.fstate.updates
    tr = run.trace
    return {
        "n": run.fleet.N, "completions": tr.completions,
        "flushes": tr.flushes, "wall_s": wall,
        "events_per_s": tr.completions / wall,
        "flushes_per_s": tr.flushes / wall,
        "sim_time_s": float(run.state.sim_time), "energy_j": tr.energy_j,
        "upload_mb": tr.upload_mb, "staleness_mean": float(stale.mean()),
        "staleness_p50": float(np.percentile(stale, 50)),
        "staleness_p95": float(np.percentile(stale, 95)),
        "staleness_max": float(stale.max()),
        "updates_mean": float(ups.mean()), "updates_max": int(ups.max()),
        "idle_frac": float((ups == 0).mean()),
        "alive_frac": float(run.fstate.alive.mean()),
    }


def simulate(run: VectorizedAsyncFedRun, flushes: int = 300) -> dict:
    """``flushes`` server versions of ``min(K, N)`` completions each ->
    ``summary`` of the run."""
    total = flushes * min(run.strategy.buffer_size, run.fleet.N)
    t0 = time.perf_counter()
    run.run(None, total_updates=total)
    return summary(run, time.perf_counter() - t0)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=100_000, help="fleet size")
    ap.add_argument("--flushes", type=int, default=300,
                    help="server versions to simulate")
    ap.add_argument("--buffer", type=int, default=64, help="FedBuff K")
    ap.add_argument("--churn-rate", type=float, default=0.0,
                    help="departures per alive client per sim-second")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="re-arrivals per departed client per sim-second")
    ap.add_argument("--jitter", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    run = build(args.n, args.buffer, args.churn_rate, args.arrival_rate,
                args.jitter, args.seed, args.device)
    s = simulate(run, args.flushes)
    print(f"\nfleet N={s['n']:,d}  buffer K={args.buffer}  "
          f"flushes {s['flushes']}  completions {s['completions']:,d}")
    print(f"wall {s['wall_s']:.2f}s  ->  {s['events_per_s']:,.0f} events/s, "
          f"{s['flushes_per_s']:,.1f} flushes/s")
    print(f"simulated {s['sim_time_s']:,.1f}s of fleet time, "
          f"energy {s['energy_j']:,.0f} J, upload {s['upload_mb']:,.1f} MB")
    print(f"staleness/flush: mean {s['staleness_mean']:.1f}  "
          f"p50 {s['staleness_p50']:.1f}  p95 {s['staleness_p95']:.1f}  "
          f"max {s['staleness_max']:.1f}")
    print(f"per-client updates: mean {s['updates_mean']:.2f}  "
          f"max {s['updates_max']}  idle {s['idle_frac']:.1%}")
    if args.churn_rate > 0 or args.arrival_rate > 0:
        print(f"population: alive {s['alive_frac']:.1%}")
    return s


if __name__ == "__main__":
    main()
