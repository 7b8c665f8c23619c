"""FLOP-proportional round timing + datasheet energy model (paper VI-A3).

Round anatomy per device n (synchronous FL):
    t_compute(n) = train_flops(n) / (tops_n * util)
    t_comm(n)    = upload_bytes(n) / bandwidth_n
    t_idle(n)    = round_time - t_compute(n) - t_comm(n)
    round_time   = max_n (t_compute + t_comm) + t_overhead

train_flops(n) charges only the parameter groups the device actually trains
(elastic masking saves backward+optimizer FLOPs; the frozen-forward cost is
charged always — this reproduces the paper's Sec. VII finding that LoRA
speedups are bounded by the fixed forward cost).

Energy per device = P_active*t_compute + P_comm*t_comm + P_idle*t_idle,
fleet energy = sum over devices (Eq. analog of Fig. 8).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.devices import FleetConfig


@dataclasses.dataclass
class RoundCost:
    round_time_s: float
    per_device_compute_s: np.ndarray
    per_device_comm_s: np.ndarray
    per_device_idle_s: np.ndarray
    fleet_energy_j: float
    upload_mb: float

    def as_dict(self) -> dict:
        return {"round_time_s": self.round_time_s,
                "fleet_energy_j": self.fleet_energy_j,
                "upload_mb": self.upload_mb}


def per_client_times(fleet: FleetConfig, trained_flops: np.ndarray,
                     fixed_flops: np.ndarray, upload_bytes: np.ndarray,
                     utilization: float = 0.3
                     ) -> tuple[np.ndarray, np.ndarray]:
    """[N] (t_compute, t_comm) for one local-training + upload cycle.

    Shared by the synchronous round simulator below and the event-driven
    runtime (sim/events.py), so sync and async results are comparable under
    the identical device model."""
    eff = fleet.tops * 1e12 * utilization
    t_comp = (np.asarray(trained_flops, np.float64)
              + np.asarray(fixed_flops, np.float64)) / eff
    t_comm = (np.asarray(upload_bytes, np.float64) * 8.0
              / (fleet.bandwidth_mbps * 1e6))
    return t_comp, t_comm


def cycle_times(fleet: FleetConfig, idx: np.ndarray,
                trained_flops: np.ndarray, fixed_flops: np.ndarray,
                upload_bytes: np.ndarray, t_overhead: float,
                utilization: float, jitter_sigma: float = 0.0,
                rng: np.random.Generator | None = None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched (dispatch -> completion) cycle draw for clients ``idx``.

    Same arithmetic as ``per_client_times`` on ``fleet.subset(idx)`` but
    indexing the fleet arrays directly — no FleetConfig copy, so the
    vectorized runtime can draw for a million-client initial dispatch or a
    two-client redispatch at the same per-element cost.
    -> (duration, t_comp, t_comm), duration = comp + comm + overhead.
    """
    idx = np.asarray(idx)
    eff = fleet.tops[idx] * 1e12 * utilization
    t_comp = (np.asarray(trained_flops, np.float64)
              + np.asarray(fixed_flops, np.float64)) / eff
    t_comm = (np.asarray(upload_bytes, np.float64) * 8.0
              / (fleet.bandwidth_mbps[idx] * 1e6))
    if jitter_sigma > 0.0 and rng is not None:
        t_comp = t_comp * rng.lognormal(0.0, jitter_sigma, size=t_comp.shape)
    return t_comp + t_comm + t_overhead, t_comp, t_comm


def simulate_round(fleet: FleetConfig, selected: np.ndarray,
                   trained_flops: np.ndarray, fixed_flops: np.ndarray,
                   upload_bytes: np.ndarray, t_overhead: float = 0.05,
                   utilization: float = 0.3) -> RoundCost:
    """selected: [N] bool participation; trained_flops/fixed_flops: [N]
    per-round FLOPs for (masked backward+update) and (always-paid forward);
    upload_bytes: [N] Eq. 8 on-demand volume."""
    sel = np.asarray(selected, bool)
    t_comp, t_comm = per_client_times(fleet, trained_flops, fixed_flops,
                                      upload_bytes, utilization)
    t_comp = np.where(sel, t_comp, 0.0)
    t_comm = np.where(sel, t_comm, 0.0)
    busy = t_comp + t_comm
    round_time = float(busy.max()) + t_overhead if sel.any() else t_overhead
    t_idle = np.where(sel, round_time - busy, 0.0)
    energy = float(np.sum(np.where(
        sel,
        fleet.active_power * t_comp + fleet.comm_power * t_comm
        + fleet.idle_power * t_idle, 0.0)))
    return RoundCost(round_time, t_comp, t_comm, t_idle, energy,
                     float(upload_bytes[sel].sum()) / 1e6)


def group_train_flops(group_flops: np.ndarray, S: np.ndarray,
                      steps_per_round: int, flops_per_param: float = 4.0
                      ) -> np.ndarray:
    """[G] per-group cost x [N, G] selection -> [N] masked training FLOPs.

    flops_per_param ~ backward(2x) + optimizer(2x) per trained parameter per
    example-step; the forward cost goes into ``fixed_flops``.
    """
    return (S.astype(np.float64) @ group_flops) * steps_per_round * flops_per_param


def profile_tau(fleet: FleetConfig, group_flops: np.ndarray,
                steps_per_round: int, utilization: float = 0.3) -> np.ndarray:
    """Eq. 7's profiled per-group training time tau_n (uniform mean over
    groups, as in the paper)."""
    mean_group = float(np.mean(group_flops)) * steps_per_round * 4.0
    return mean_group / (fleet.tops * 1e12 * utilization)
