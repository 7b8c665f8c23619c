"""Federated strategies: RELIEF (+ its ablations V1-V3) and the paper's ten
baselines, expressed as combinations of four orthogonal knobs consumed by the
engine:

  alloc     what to train        all | all_groups | divergence | magnitude |
                                 random | depth
  budgets   how much to train    elastic (Eq. 7) | none
  agg       how to aggregate     cohort (Eq. 3-4) | fedavg | dimension |
                                 helora
  personal  what stays local     leaf-path substrings never aggregated
                                 (+ optional cluster mixing)

Baseline fidelity note (DESIGN.md §7): baselines are *protocol-level*
reimplementations of the published mechanisms (what is trained, how updates
are aggregated, what is communicated); system-specific engineering from the
original papers (e.g. FedEL's window scheduler internals, DarkDistill's
distillation temperature) is approximated by the nearest protocol with the
same selection semantics — each docstring states the approximation.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    # which groups each client trains:
    #   full       — the whole model, incl. absent-modality parameters
    #                (classical FL: the paper's Q2 waste mechanism)
    #   accessible — only groups of owned modalities (modality-aware)
    #   divergence/magnitude/random/depth — scored top-k within budget
    alloc: str = "full"
    budgets: str = "none"  # elastic (Eq.7) | none
    agg: str = "fedavg"  # cohort | fedavg | dimension | helora
    mandatory: bool = False  # enforce {A_m : m in M_n} inclusion
    prox_mu: float = 0.0  # FedProx proximal coefficient
    personal: tuple[str, ...] = ()  # leaf substrings kept local
    cluster_mix: bool = False  # personal leaves mixed within modality clusters
    rank_caps: tuple[float, ...] = ()  # HeLoRA per-type rank fractions
    share_only: tuple[str, ...] = ()  # if set, aggregate ONLY these leaves
    depth_rotate: bool = False  # FedICU: rotate depth window per round


def relief(**kw) -> Strategy:
    """V0 — full RELIEF: divergence-guided elastic + cohort aggregation."""
    return Strategy("relief", alloc="divergence", budgets="elastic",
                    agg="cohort", mandatory=True, **kw)


def relief_no_elastic() -> Strategy:
    """V1 — cohort aggregation only (trains everything accessible)."""
    return Strategy("relief_v1_no_elastic", alloc="accessible", budgets="none",
                    agg="cohort", mandatory=True)


def relief_no_cohort() -> Strategy:
    """V2 — elastic only, naive FedAvg aggregation (no mandatory set, same
    budget => paper notes V2/V3 speedup exceeds V0)."""
    return Strategy("relief_v2_no_cohort", alloc="divergence",
                    budgets="elastic", agg="fedavg", mandatory=False)


def relief_random_alloc() -> Strategy:
    """V3 — random allocation at the same budgets, cohort aggregation."""
    return Strategy("relief_v3_random", alloc="random", budgets="elastic",
                    agg="cohort", mandatory=False)


def fedavg() -> Strategy:
    """McMahan et al. — full local training, uniform averaging."""
    return Strategy("fedavg", alloc="full", agg="fedavg")


def fedprox(mu: float = 0.01) -> Strategy:
    """Li et al. — FedAvg + proximal term mu/2 ||theta - theta^r||^2."""
    return Strategy("fedprox", alloc="full", agg="fedavg", prox_mu=mu)


def fedel_like() -> Strategy:
    """FedEL (Zhang et al.): elastic tensor selection by update magnitude
    within a runtime budget. Modality-UNAWARE: candidates include groups for
    absent sensors (candidates = ALL groups), reproducing the paper's zero-gradient
    waste. Approximates the sliding-window scheduler by magnitude top-k."""
    return Strategy("fedel", alloc="magnitude", budgets="elastic",
                    agg="fedavg", mandatory=False)


def fedicu_like() -> Strategy:
    """FedICU (Liao et al.): importance-aware model splitting — weak devices
    train a contiguous depth window that rotates across rounds; plain
    averaging. Approximates importance scoring by round-robin coverage."""
    return Strategy("fedicu", alloc="depth", budgets="elastic", agg="fedavg",
                    depth_rotate=True)


def darkdistill_like() -> Strategy:
    """DarkDistill (Qu et al.): difficulty-aligned early-exit training —
    weak devices train the shallow prefix + head (fixed depth prefix, no
    rotation); distillation between exits is not modeled."""
    return Strategy("darkdistill", alloc="depth", budgets="elastic",
                    agg="fedavg")


def harmony_like() -> Strategy:
    """Harmony (Ouyang et al.): modality-wise federation; the fusion layer
    (and head) are NOT federated — they remain local to each device."""
    return Strategy("harmony", alloc="accessible", agg="cohort",
                    personal=("fusion", "head"))


def pilot_like() -> Strategy:
    """Pilot / FediLoRA-style dimension-wise aggregation: each row of the
    fusion projection is averaged over the clients with a non-zero update
    (cohort-aware rows) but without RELIEF's B-weighting or elastic budget."""
    return Strategy("pilot", alloc="accessible", agg="dimension")


def fedsa_lora() -> Strategy:
    """FedSA-LoRA (Guo et al.): share only the A matrices (input-side,
    ``['a']`` leaves in our storage); B matrices stay local."""
    return Strategy("fedsa_lora", alloc="full", agg="fedavg",
                    share_only=("['a']", "head"))


def helora_like(rank_caps=(1.0, 0.5, 0.25)) -> Strategy:
    """HeLoRA (Fan et al.): heterogeneous LoRA ranks by device tier
    (full/mid/low fractions of rho); zero-pad reconciliation at the server
    = rank-masked elementwise mean."""
    return Strategy("helora", alloc="full", agg="helora", rank_caps=rank_caps)


def fedlease_like() -> Strategy:
    """FedLEASE (Wang et al.): clients clustered by representation
    similarity get cluster-expert adapters; we cluster by modality-set
    identity (the dominant similarity factor here) and aggregate adapter
    leaves within clusters."""
    return Strategy("fedlease", alloc="full", agg="fedavg",
                    personal=("lora",), cluster_mix=True)


# ---------------------------------------------------------------------------
# asynchronous (event-driven) strategies — consumed by core/async_engine.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AsyncStrategy(Strategy):
    """Strategy + the event-driven runtime's knobs.

    buffer_size         K: server aggregates once K completions are buffered
                        (FedBuff-style). K = N with a homogeneous fleet
                        degenerates to the synchronous engine.
    staleness_exponent  a in the polynomial discount 1/(1+s)^a, s = server
                        versions elapsed since the client pulled its model.
                        a = 0 disables discounting.
    max_staleness       drop (never aggregate) updates staler than this;
                        None = keep everything.
    """
    buffer_size: int = 4
    staleness_exponent: float = 0.5
    max_staleness: int | None = None
    # Byzantine-robust within-cohort reduction (core/aggregation.py):
    #   mean | trimmed | median | krum. Non-mean modes reduce whole flush
    #   cohorts with bounded-breakdown estimators; see robust_combine.
    robust: str = "mean"
    trim_frac: float = 0.1  # beta for robust="trimmed"
    krum_f: int = 1  # assumed Byzantine count per cohort for robust="krum"
    # FedMFS-style selective modality communication (arXiv:2310.07048):
    # after local training, upload ONLY the modality-block deltas whose
    # Shapley-style utility-per-byte clears a greedy knapsack under
    # comm_budget x (full upload bytes). Compute cost is unchanged; the
    # server aggregates the shrunk upload set.
    selective: bool = False
    comm_budget: float = 0.5  # fraction of the trained-set upload bytes kept


def async_relief(buffer_size: int = 4, staleness_exponent: float = 0.5,
                 **kw) -> AsyncStrategy:
    """RELIEF's allocation + cohort aggregation on the async runtime."""
    return AsyncStrategy("async_relief", alloc="divergence",
                         budgets="elastic", agg="cohort", mandatory=True,
                         buffer_size=buffer_size,
                         staleness_exponent=staleness_exponent, **kw)


def async_accessible(buffer_size: int = 4, staleness_exponent: float = 0.5,
                     **kw) -> AsyncStrategy:
    """Modality-aware async without elastic budgeting (V1 analog)."""
    return AsyncStrategy("async_accessible", alloc="accessible",
                         budgets="none", agg="cohort", mandatory=True,
                         buffer_size=buffer_size,
                         staleness_exponent=staleness_exponent, **kw)


def async_fedbuff(buffer_size: int = 4, staleness_exponent: float = 0.5,
                  **kw) -> AsyncStrategy:
    """FedBuff (Nguyen et al.): modality-UNAWARE buffered async FedAvg —
    every buffered client averaged into every group with the staleness
    discount as its only weighting."""
    return AsyncStrategy("async_fedbuff", alloc="full", budgets="none",
                         agg="fedavg", buffer_size=buffer_size,
                         staleness_exponent=staleness_exponent, **kw)


def relief_trimmed(trim_frac: float = 0.1, **kw) -> AsyncStrategy:
    """async_relief with beta-trimmed-mean cohort reduction. Cheapest robust
    rule; keeps combine weights; breaks down past ~trim_frac Byzantine."""
    return AsyncStrategy("relief_trimmed", alloc="divergence",
                         budgets="elastic", agg="cohort", mandatory=True,
                         robust="trimmed", trim_frac=trim_frac, **kw)


def relief_median(**kw) -> AsyncStrategy:
    """async_relief with coordinate-median cohort reduction. Breakdown point
    1/2 per coordinate; ignores combine weights (every member counts once)."""
    return AsyncStrategy("relief_median", alloc="divergence",
                         budgets="elastic", agg="cohort", mandatory=True,
                         robust="median", **kw)


def relief_krum(krum_f: int = 1, **kw) -> AsyncStrategy:
    """async_relief with blockwise Krum cohort reduction: per modality group,
    the single member delta closest to its k-f-2 nearest co-members is taken
    verbatim. Strongest against collusion (never mixes attacker mass in);
    assumes cohorts of at least f+3 members to be selective."""
    return AsyncStrategy("relief_krum", alloc="divergence",
                         budgets="elastic", agg="cohort", mandatory=True,
                         robust="krum", krum_f=krum_f, **kw)


def fedmfs_selective(comm_budget: float = 0.5, **kw) -> AsyncStrategy:
    """FedMFS (Yuan et al., arXiv:2310.07048): modality-aware local training
    with *selective modality-block upload* — each client ranks its trained
    blocks by Shapley-style utility per byte (||delta_g||^2 / bytes_g, the
    marginal-contribution proxy) and uploads greedily until the byte budget
    is spent. No elastic compute budgeting: the selection is purely a
    communication mechanism layered on accessible allocation."""
    return AsyncStrategy("fedmfs_selective", alloc="accessible",
                         budgets="none", agg="cohort", mandatory=True,
                         selective=True, comm_budget=comm_budget, **kw)


def relief_selective(comm_budget: float = 0.5, **kw) -> AsyncStrategy:
    """async_relief + FedMFS selective upload: divergence-guided elastic
    compute allocation AND utility-per-byte upload pruning."""
    return AsyncStrategy("relief_selective", alloc="divergence",
                         budgets="elastic", agg="cohort", mandatory=True,
                         selective=True, comm_budget=comm_budget, **kw)


ASYNC_STRATEGIES = {
    "async_relief": async_relief, "async_accessible": async_accessible,
    "async_fedbuff": async_fedbuff, "relief_trimmed": relief_trimmed,
    "relief_median": relief_median, "relief_krum": relief_krum,
    "fedmfs_selective": fedmfs_selective,
    "relief_selective": relief_selective,
}


ALL_BASELINES = {
    "fedavg": fedavg, "fedprox": fedprox, "fedel": fedel_like,
    "fedicu": fedicu_like, "darkdistill": darkdistill_like,
    "harmony": harmony_like, "pilot": pilot_like, "fedsa_lora": fedsa_lora,
    "helora": helora_like, "fedlease": fedlease_like,
}

ABLATIONS = {
    "v0": relief, "v1": relief_no_elastic, "v2": relief_no_cohort,
    "v3": relief_random_alloc,
}


# ---------------------------------------------------------------------------
# name-keyed registry — the single lookup surface for benchmarks/examples/
# scenarios; the factory callables above remain as thin aliases
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, object] = {
    "relief": relief, "v0": relief, "v1": relief_no_elastic,
    "v2": relief_no_cohort, "v3": relief_random_alloc,
    **ALL_BASELINES, **ASYNC_STRATEGIES,
}


def register(name: str, factory) -> None:
    """Add a zero-arg (or all-defaults) Strategy factory under ``name``."""
    _REGISTRY[name] = factory


def names() -> list[str]:
    """Registered strategy names (aliases like ``v0`` included)."""
    return sorted(_REGISTRY)


def get(name: str, **overrides) -> Strategy:
    """Look up a strategy by name, optionally overriding any dataclass field:

        strategies.get("relief_trimmed", trim_frac=0.2, buffer_size=8)

    Overrides apply via ``dataclasses.replace`` on the factory's default
    instance, so any field of Strategy/AsyncStrategy can be set — unknown
    fields raise TypeError, unknown names raise ValueError."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown strategy {name!r}; known: {names()}")
    strat = _REGISTRY[name]()
    return dataclasses.replace(strat, **overrides) if overrides else strat


def get_strategy(name: str) -> Strategy:
    """Deprecated alias for :func:`get` (kept for older scripts)."""
    return get(name)
