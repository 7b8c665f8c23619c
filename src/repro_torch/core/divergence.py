"""Cohort-internal divergence tracking (paper Eq. 5-6).

d_j^r = (1/|C_j|) * sum_{n in C_j} || delta_{j,n} - mean_{C_j}(delta_j) ||_F^2

computed per parameter group over the stacked client deltas, then
EMA-smoothed (Eq. 6). The synchronous engine uses these plain reductions;
the asynchronous runtime takes the same statistics from the fused
cohort-agg pass (``aggregation.CohortAggBuffer``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import mdlora
from repro_torch.tree import tree_map


def group_divergence(layout: mdlora.GroupLayout, deltas: Any,
                     cohort: torch.Tensor) -> torch.Tensor:
    """deltas: client-stacked trainable tree ([N, ...] leaves); cohort:
    [N, G] bool/float -- who contributes to each group's estimate.
    -> [G] float32 divergences."""
    c = cohort.float()
    counts = c.sum(0)  # [G]
    Wmean = torch.where(counts[None, :] > 0,
                        c / counts.clamp(min=1.0)[None, :], 0.0)
    mean_tree = mdlora.weighted_combine(layout, deltas, Wmean)
    dev = tree_map(lambda d, m: d.float() - m[None], deltas, mean_tree)
    per_client = mdlora.group_norms(layout, dev, batch_dims=1)  # [N, G]
    tot = (per_client * c).sum(0)
    return torch.where(counts > 0, tot / counts.clamp(min=1.0), 0.0)


def ema_update(dbar, d, gamma: float):
    """Eq. 6: dbar^r = gamma*d^r + (1-gamma)*dbar^{r-1} (arrays or
    tensors)."""
    return gamma * d + (1.0 - gamma) * dbar


def ema_bias_bound(gamma: float, delta_max: float) -> float:
    """Steady-state EMA tracking bias bound (Prop. 5 / Eq. 21, corrected):
    |dbar - d| <= delta*(1-gamma)/gamma. The paper prints
    gamma*delta/(1-gamma)^2, which mis-evaluates sum_s s(1-gamma)^s; the
    reference documents the discrepancy."""
    return delta_max * (1.0 - gamma) / gamma


def ema_bias_bound_paper(gamma: float, delta_max: float) -> float:
    """The bound exactly as printed in the paper (Eq. 21), kept for the
    comparison with the corrected one."""
    return gamma * delta_max / (1.0 - gamma) ** 2
