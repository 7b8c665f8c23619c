"""Divergence-guided elastic allocation (paper Eq. 7, Prop. 4-5).

* ``elastic_budgets``  — Eq. 7: k_n = max(|M_n|, floor((T* - T_o)/tau_n)).
* ``solve_t_star``     — binary search for the smallest per-round time target
  T* such that every device fits its budget within T* (paper IV-B2b: "T* is
  selected via binary search to minimize the maximum per-round time").
* ``allocate_topk``    — top-k_n selection by smoothed divergence with the
  mandatory fusion-block inclusion, vectorized over clients.
* ``water_filling``    — Prop. 4 closed form x_m* = sqrt(D_m)/sum sqrt * K,
  used by tests and by the server's cohort-size targeting diagnostics.
"""
from __future__ import annotations

import numpy as np


def elastic_budgets(tau: np.ndarray, t_star: float, t_overhead: float,
                    n_mandatory: np.ndarray, g_max: np.ndarray) -> np.ndarray:
    """Eq. 7. tau: [N] profiled per-group train time; n_mandatory: [N] |M_n|;
    g_max: [N] number of accessible groups (budget can never exceed it)."""
    raw = np.floor((t_star - t_overhead) / np.maximum(tau, 1e-12)).astype(int)
    return np.clip(np.maximum(n_mandatory, raw), 0, g_max)


def round_time(tau: np.ndarray, k: np.ndarray, t_overhead: float) -> float:
    """Synchronous round = slowest device (straggler)."""
    return float(np.max(t_overhead + tau * k))


def solve_t_star(tau: np.ndarray, t_overhead: float, n_mandatory: np.ndarray,
                 g_max: np.ndarray, target_budget: float | None = None,
                 tol: float = 1e-6) -> float:
    """Binary-search the per-round time target T* (paper IV-B2b).

    Degenerate minimization (T* -> overhead, nobody trains) is excluded by
    the *utilization floor*: the fastest device must complete its full
    accessible set within T* — this matches the paper's measured behavior
    (Fig. 8a: the bottleneck shifts to the fast Type-A device; Table III:
    V0/V2/V3 share identical budgets). Above that floor, the search finds
    the smallest T* consistent with its own induced budgets, or (when
    ``target_budget`` = aggregate K of Prop. 4 is given) the smallest T*
    whose induced aggregate budget reaches K.
    """
    floor = float(np.min(t_overhead + tau * g_max))
    lo = floor
    hi = t_overhead + float(np.max(tau * g_max)) + 1.0

    def feasible(t):
        k = elastic_budgets(tau, t, t_overhead, n_mandatory, g_max)
        if target_budget is not None:
            return k.sum() >= target_budget
        return np.max(np.minimum(t_overhead + tau * k, t_overhead + tau * g_max)
                      ) <= t + tol or t >= floor

    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if feasible(mid):
            hi = mid
        else:
            lo = mid
    return max(hi, floor)


def allocate_topk(dbar: np.ndarray, accessible: np.ndarray,
                  mandatory: np.ndarray, k: np.ndarray,
                  rng: np.random.Generator | None = None,
                  randomize: bool = False) -> np.ndarray:
    """-> S: [N, G] bool selection.

    Per client: include all mandatory groups, then fill the remaining
    k_n - |mandatory| slots with the highest-dbar accessible groups
    (``randomize=True`` replaces the score by noise — ablation V3).

    Fully vectorized over the client axis (a stable argsort ranks each row's
    candidates; non-candidates sink below every candidate), so the
    million-client fleet simulator can allocate a whole dispatch batch in
    one shot. Row-for-row identical to the per-client loop it replaced:
    stable ordering preserves index order among equal scores.
    """
    N, G = accessible.shape
    base = (rng.random(G * N).reshape(N, G) if randomize and rng is not None
            else np.tile(np.asarray(dbar, np.float64), (N, 1)))
    cand = accessible & ~mandatory
    score = np.where(cand, base, -np.inf)
    order = np.argsort(-score, axis=1, kind="stable")  # [N, G]
    rank = np.argsort(order, axis=1, kind="stable")  # rank of each group
    rest = np.maximum(np.asarray(k, np.int64) - mandatory.sum(1), 0)
    return mandatory | (cand & (rank < rest[:, None]))


def water_filling(delta: np.ndarray, K: float) -> tuple[np.ndarray, float]:
    """Prop. 4: minimize sum_m delta_m/x_m s.t. sum_m x_m <= K.

    -> (x*: [M], R*: optimal residual = (sum sqrt(delta))^2 / K).
    """
    sq = np.sqrt(np.maximum(np.asarray(delta, np.float64), 0.0))
    tot = sq.sum()
    if tot == 0 or K <= 0:
        return np.zeros_like(sq), 0.0
    x = sq / tot * K
    return x, float(tot**2 / K)


def weighted_cohort_residual(delta: np.ndarray, x: np.ndarray) -> float:
    """R({x_m}) = sum_m delta_m / x_m (Prop. 4 objective)."""
    x = np.asarray(x, np.float64)
    d = np.asarray(delta, np.float64)
    with np.errstate(divide="ignore"):
        terms = np.where(d > 0, d / np.maximum(x, 1e-300), 0.0)
    return float(terms.sum())
