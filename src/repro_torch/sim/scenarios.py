"""Scenario matrix: one frozen spec -> dataset + fleet + strategy + runtime.

Every experiment used to wire `make_har_dataset` / `make_fleet` /
`AsyncFedConfig` together by hand with copy-pasted kwargs, which is why the
repo only ever ran the paper's single coupled-heterogeneity scenario. A
``ScenarioSpec`` is the single constructor input for both async runtimes:

    spec = get_scenario("static30")
    run, sc = make_run(spec)                      # heap runtime, on the card
    run.run(sc.dataset)

The missing-modality side is a pluggable generator family in the
fed-multimodal style (10/30/50% ratios):

    none       the paper's coupled fleet — possession is tied to device
               tier at construction (full=all, mid=2, low=1 modalities)
    static     per-client masks drawn once, *exact* global missing count
               round(ratio * N * M), every client keeps >= 1 modality
    tiered     missing correlated with device tier: the fastest tier drops
               nothing, the slowest drops ~2x the ratio, fleet-average ~=
               ratio (reproduces the paper's coupled heterogeneity on an
               arbitrary fleet)
    streaming  time-varying masks — modalities appear/disappear mid-run on
               per-(client, modality) duty cycles; a per-client anchor
               modality never drops. Masks are a *pure function of
               (seed, client, modality, sim-time)*, never of event order,
               so the heap and vectorized runtimes stay history-equivalent
               (tests/test_torch_scenarios.py).

Determinism: every draw is keyed by (spec.seed, salt[, client]) with
``np.random.default_rng`` sequence seeds — independent of runtime
interleaving and of fleet subset order. Masks and schedules are numpy
(float64 times and periods), never tensors: both runtimes evaluate
``masks_at`` on bit-equal host floats, on the card as on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core import strategies
from repro_torch.data.registry import get_provider
from repro_torch.sim.devices import FleetConfig, make_fleet, scale_fleet
from repro_torch.sim.faults import FaultModel

MISSING_GENERATORS = ("none", "static", "tiered", "streaming")

# rng stream salts — distinct sub-streams of spec.seed
_STATIC_SALT = 0x57A7
_TIER_SALT = 0x7123
_STREAM_SALT = 0x5E4A
_SCALE_SALT = 0x5CA1


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """The whole experiment in one frozen value.

    ``strategy`` is a name in :mod:`repro_torch.core.strategies`'s registry;
    ``strategy_args`` is a tuple of ``(field, value)`` pairs applied as
    overrides (tuples keep the spec hashable). The training knobs mirror
    FedConfig so ``AsyncFedConfig.from_scenario(spec)`` needs nothing else.
    """
    name: str
    # data
    dataset: str = "pamap2"  # provider name (data/registry.py)
    alpha: float = 1.0  # Dirichlet concentration of client class priors
    windows_per_subject: int = 240
    # missing-modality generator
    missing: str = "none"  # none | static | tiered | streaming
    missing_ratio: float = 0.3  # 0.1 / 0.3 / 0.5 in the sweep
    stream_period: float = 40.0  # mean sim-seconds per on/off duty cycle
    # fleet
    fleet: tuple[int, int, int] = (3, 3, 2)  # (n_full, n_mid, n_low)
    n_clients: int | None = None  # scale_fleet target; None = sum(fleet)
    hetero_scale: float | None = None  # Full/Low compute gap (10/55/100)
    # protocol
    strategy: str = "async_relief"
    strategy_args: tuple[tuple[str, Any], ...] = ()
    uplink_codec: str = "none"  # none | int8
    faults: FaultModel | None = None
    # model
    backbone: str = "cnn"
    small_model: bool = True
    # training/runtime knobs (consumed by AsyncFedConfig.from_scenario)
    rounds: int = 20
    local_epochs: int = 5
    steps_per_epoch: int = 4
    batch_size: int = 32
    lr: float = 1e-3
    eval_every: int = 5
    t_overhead: float = 0.05
    utilization: float = 2e-5
    jitter_sigma: float = 0.0
    total_updates: int | None = None
    grad_mode: str = "dispatch"
    seed: int = 0

    def __post_init__(self):
        if self.missing not in MISSING_GENERATORS:
            raise ValueError(f"missing must be one of {MISSING_GENERATORS}, "
                             f"got {self.missing!r}")
        if not 0.0 <= self.missing_ratio < 1.0:
            raise ValueError("missing_ratio must be in [0, 1)")

    def build_strategy(self) -> strategies.Strategy:
        return strategies.get(self.strategy, **dict(self.strategy_args))


# ---------------------------------------------------------------------------
# missing-modality generators
# ---------------------------------------------------------------------------


def static_missing_mask(base: np.ndarray, ratio: float,
                        seed: int) -> np.ndarray:
    """Drop exactly ``round(ratio * N * M)`` (client, modality) pairs from
    the ``base`` possession mask, never leaving a client with 0 modalities.

    A seeded permutation of all pairs is walked until the target count is
    reached, skipping drops that would empty a client — deterministic in
    (seed, N, M) and independent of anything runtime-side. Feasible for
    ratio <= (M-1)/M on a full base.
    """
    base = np.asarray(base, bool)
    N, M = base.shape
    mask = base.copy()
    target = int(round(ratio * N * M))
    rng = np.random.default_rng([seed, _STATIC_SALT])
    dropped = 0
    for p in rng.permutation(N * M):
        if dropped >= target:
            break
        n, m = divmod(int(p), M)
        if mask[n, m] and mask[n].sum() > 1:
            mask[n, m] = False
            dropped += 1
    if dropped < target:
        raise ValueError(f"cannot drop {target} pairs while keeping every "
                         f"client >=1 modality (N={N}, M={M})")
    return mask


def device_tiers(fleet: FleetConfig) -> np.ndarray:
    """[N] tier index, 0 = fastest, from the distinct compute levels."""
    levels = np.unique(fleet.tops)[::-1]  # descending
    return np.searchsorted(-levels, -fleet.tops).astype(np.int64)


def tiered_missing_mask(base: np.ndarray, tiers: np.ndarray, ratio: float,
                        seed: int) -> np.ndarray:
    """Missing correlated with device tier: tier t of T drops a
    ``ratio * 2t/(T-1)`` fraction of its modalities (fastest tier drops 0,
    slowest ~2x ratio; fleet-average ~= ratio for balanced tiers), each
    client keeping >= 1. Which modalities drop is a per-client seeded
    permutation, so the mask is order-free."""
    base = np.asarray(base, bool)
    tiers = np.asarray(tiers)
    N, M = base.shape
    T = int(tiers.max()) + 1
    mask = base.copy()
    for n in range(N):
        frac = ratio * (2.0 * tiers[n] / (T - 1)) if T > 1 else ratio
        n_drop = min(int(round(frac * M)), int(base[n].sum()) - 1)
        if n_drop <= 0:
            continue
        rng = np.random.default_rng([seed, _TIER_SALT, n])
        owned = np.nonzero(base[n])[0]
        mask[n, rng.permutation(owned)[:n_drop]] = False
    return mask


@dataclasses.dataclass(frozen=True, eq=False)
class StreamingSchedule:
    """Time-varying modality availability, evaluated lazily at dispatch.

    Client n's modality m is ON at sim-time t iff

        frac(t / period[n, m] + phase[n, m]) < 1 - ratio

    intersected with the static possession ``base`` and with the per-client
    ``anchor`` modality forced always-on (so allocation always has >= 1
    accessible group). Pure in (t, n, m): both async runtimes evaluating the
    same (time, client) dispatch get bit-identical masks regardless of
    event interleaving, which is what keeps heap/vectorized history parity.
    """
    period: np.ndarray  # [N, M] sim-seconds per duty cycle
    phase: np.ndarray  # [N, M] in [0, 1)
    duty: float  # on-fraction = 1 - missing_ratio
    anchor: np.ndarray  # [N] always-on modality per client
    base: np.ndarray  # [N, M] static possession

    @property
    def N(self) -> int:
        return self.base.shape[0]

    @property
    def M(self) -> int:
        return self.base.shape[1]

    def masks_at(self, t: float, idx: np.ndarray | None = None) -> np.ndarray:
        """[B, M] live masks for clients ``idx`` (None = whole fleet)."""
        sl = slice(None) if idx is None else np.asarray(idx)
        on = ((t / self.period[sl] + self.phase[sl]) % 1.0) < self.duty
        out = on & self.base[sl]
        rows = np.arange(out.shape[0])
        anchor = self.anchor[sl]
        out[rows, anchor] = self.base[sl][rows, anchor]
        return out


def streaming_schedule(base: np.ndarray, ratio: float, period: float,
                       seed: int) -> StreamingSchedule:
    """Build the per-(client, modality) duty cycles: periods log-uniform in
    [period/e^.4, period*e^.4] (clients never toggle in lockstep), phases
    uniform, anchor a seeded choice among each client's possessed set."""
    base = np.asarray(base, bool)
    N, M = base.shape
    rng = np.random.default_rng([seed, _STREAM_SALT])
    per = period * np.exp(rng.uniform(-0.4, 0.4, (N, M)))
    phase = rng.random((N, M))
    anchor = np.array([rng.choice(np.nonzero(base[n])[0]) for n in range(N)],
                      np.int64)
    return StreamingSchedule(per, phase, 1.0 - ratio, anchor, base.copy())


# ---------------------------------------------------------------------------
# scenario construction
# ---------------------------------------------------------------------------


def build_fleet(spec: ScenarioSpec) -> FleetConfig:
    """Fleet for a spec. ``missing="none"`` keeps the paper's coupled
    possession (mid=2 modalities, low=1); every other generator starts from
    full possession on all tiers and drops via its own mechanism (static/
    tiered mutate the mask here; streaming keeps the full base and toggles
    at dispatch via the schedule on AsyncFedConfig)."""
    provider = get_provider(spec.dataset)
    M = len(provider.modalities())
    n_full, n_mid, n_low = spec.fleet
    if spec.missing == "none":
        fleet = make_fleet(n_full, n_mid, n_low, M=M,
                           mid_modalities=tuple(range(min(2, M))),
                           low_modalities=(0,),
                           hetero_scale=spec.hetero_scale)
    else:
        full = tuple(range(M))
        fleet = make_fleet(n_full, n_mid, n_low, M=M, mid_modalities=full,
                           low_modalities=full,
                           hetero_scale=spec.hetero_scale)
    if spec.n_clients is not None and spec.n_clients != fleet.N:
        fleet = scale_fleet(fleet, spec.n_clients,
                            np.random.default_rng([spec.seed, _SCALE_SALT]))
    if spec.missing == "static":
        fleet.modality_mask = static_missing_mask(
            fleet.modality_mask, spec.missing_ratio, spec.seed)
    elif spec.missing == "tiered":
        fleet.modality_mask = tiered_missing_mask(
            fleet.modality_mask, device_tiers(fleet), spec.missing_ratio,
            spec.seed)
    return fleet


def schedule_for(spec: ScenarioSpec,
                 fleet: FleetConfig | None = None) -> StreamingSchedule | None:
    """The spec's StreamingSchedule (None unless ``missing="streaming"``)."""
    if spec.missing != "streaming":
        return None
    base = (fleet or build_fleet(spec)).modality_mask
    return streaming_schedule(base, spec.missing_ratio, spec.stream_period,
                              spec.seed)


@dataclasses.dataclass
class Scenario:
    """A fully-materialized spec: everything a runtime constructor takes."""
    spec: ScenarioSpec
    dataset: Any  # HARDataset-shaped (provider.build output)
    fleet: FleetConfig
    strategy: strategies.Strategy
    fed: Any  # AsyncFedConfig
    schedule: StreamingSchedule | None


def build_scenario(spec: ScenarioSpec, **fed_overrides) -> Scenario:
    from repro_torch.core.async_engine import AsyncFedConfig

    provider = get_provider(spec.dataset)
    fleet = build_fleet(spec)
    ds = provider.build(seed=spec.seed, n_clients=fleet.N, alpha=spec.alpha,
                        windows_per_subject=spec.windows_per_subject)
    fed = AsyncFedConfig.from_scenario(spec, fleet=fleet, **fed_overrides)
    return Scenario(spec, ds, fleet, spec.build_strategy(), fed,
                    fed.modality_schedule)


def make_run(spec: ScenarioSpec, vectorized: bool = False, *,
             params: Any = None, device: Any = None, **fed_overrides):
    """Spec -> ready (run, Scenario). ``run.run(scenario.dataset)`` goes.

    The model's weights are drawn from ``spec.seed`` unless ``params``
    carries them (a nested dict of arrays, e.g. the reference's
    ``task.params(trainable)``); ``device`` defaults to the CUDA card."""
    import torch

    from repro_torch.core.async_engine import (AsyncFedRun,
                                               VectorizedAsyncFedRun)
    from repro_torch.core.tasks import MMTask

    sc = build_scenario(spec, **fed_overrides)
    cfg = get_provider(spec.dataset).mm_config(spec.backbone,
                                               small=spec.small_model)
    task, tr0 = MMTask.create(
        cfg, generator=torch.Generator().manual_seed(spec.seed),
        params=params, device=device)
    cls = VectorizedAsyncFedRun if vectorized else AsyncFedRun
    run = cls.create(task, tr0, sc.strategy, sc.fleet, sc.fed)
    return run, sc


# ---------------------------------------------------------------------------
# scenario library (fed-multimodal-style sweep presets)
# ---------------------------------------------------------------------------

_LIB = [
    # the paper's coupled fleet, no extra missing generator
    ScenarioSpec("paper", missing="none"),
    # static masks at the fed-multimodal ratios on a full-possession fleet
    ScenarioSpec("static10", missing="static", missing_ratio=0.1),
    ScenarioSpec("static30", missing="static", missing_ratio=0.3),
    ScenarioSpec("static50", missing="static", missing_ratio=0.5),
    # tier-correlated missing (the paper's coupling, generator-driven)
    ScenarioSpec("tiered30", missing="tiered", missing_ratio=0.3),
    # time-varying streaming masks (arXiv:2505.16138-style online clients)
    ScenarioSpec("stream30", missing="streaming", missing_ratio=0.3),
    # audio+video two-modality scenario on the UCF101-style provider
    ScenarioSpec("ucf101_static30", dataset="ucf101_av", missing="static",
                 missing_ratio=0.3, fleet=(6, 6, 4)),
]
SCENARIOS = {s.name: s for s in _LIB}


def get_scenario(name: str, **replace) -> ScenarioSpec:
    """Library preset by name, optionally with field overrides."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(SCENARIOS)}")
    spec = SCENARIOS[name]
    return dataclasses.replace(spec, **replace) if replace else spec


def scenario_names() -> list[str]:
    return sorted(SCENARIOS)
