"""Device profiles and fleet construction (paper Sec. VI-A3 + VII).

FLOP-proportional timing calibrated to edge TOPS; power from Jetson AGX Orin
datasheet modes. The paper's three device types couple modality count with
compute (the "device cost gradient"):

    Full      4 modalities, 275 TOPS (AGX Orin MAXN, 60 W)
    Mid       2 modalities,  21 TOPS (Xavier NX, 30 W mode -> 30 W)
    Low       1 modality,     5 TOPS (low-end IoT, 15 W mode -> 5..15 W)

Heterogeneity scales (10x / 55x / 100x, Tables IV-V) rescale the Mid/Low
compute relative to Full.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    tops: float  # effective trillion ops/s
    active_power_w: float
    comm_power_w: float
    idle_frac: float = 0.2  # idle power = 20% of active (paper VI-A3)
    bandwidth_mbps: float = 100.0  # uplink

    @property
    def idle_power_w(self) -> float:
        return self.idle_frac * self.active_power_w


DEVICE_PROFILES = {
    "full": DeviceProfile("full", 275.0, 60.0, 10.0),
    "mid": DeviceProfile("mid", 21.0, 30.0, 8.0),
    "low": DeviceProfile("low", 5.0, 15.0, 5.0),
    # real-device testbed analogues (Sec. VII, Jetson power modes)
    "orin_maxn": DeviceProfile("orin_maxn", 275.0, 60.0, 10.0),
    "orin_30w": DeviceProfile("orin_30w", 92.0, 30.0, 8.0),
    "orin_15w": DeviceProfile("orin_15w", 40.0, 15.0, 6.0),
}


@dataclasses.dataclass
class FleetConfig:
    """N devices with coupled system-modality heterogeneity."""
    modality_mask: np.ndarray  # [N, M] bool
    tops: np.ndarray  # [N]
    active_power: np.ndarray  # [N] W
    comm_power: np.ndarray  # [N] W
    idle_power: np.ndarray  # [N] W
    bandwidth_mbps: np.ndarray  # [N]
    type_names: list[str]  # immutable after construction (cached below)
    # lazily-built str array mirror of type_names, so repeated subset() calls
    # (one per event-loop dispatch) fancy-index instead of list-comprehending.
    # Built once on first use — mutating type_names afterwards is unsupported
    # (a length heuristic would miss same-length in-place replacement).
    _names_arr: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def N(self) -> int:
        return len(self.tops)

    @property
    def M(self) -> int:
        return self.modality_mask.shape[1]

    def names_array(self) -> np.ndarray:
        if self._names_arr is None:
            self._names_arr = np.asarray(self.type_names)
        return self._names_arr

    def subset(self, idx) -> FleetConfig:
        """Fleet restricted to client indices ``idx`` (sliced arrays; names
        via the cached string array, not a per-call list comprehension)."""
        idx = np.asarray(idx)
        return FleetConfig(self.modality_mask[idx], self.tops[idx],
                           self.active_power[idx], self.comm_power[idx],
                           self.idle_power[idx], self.bandwidth_mbps[idx],
                           self.names_array()[idx].tolist())

    @classmethod
    def from_scenario(cls, spec) -> FleetConfig:
        """Build the fleet a :class:`repro_torch.sim.scenarios.ScenarioSpec`
        describes (tier counts, hetero scale, missing-modality generator)."""
        from repro_torch.sim.scenarios import build_fleet  # import cycle

        return build_fleet(spec)


def make_fleet(n_full: int, n_mid: int, n_low: int, M: int = 4,
               mid_modalities: tuple[int, ...] = (0, 1),
               low_modalities: tuple[int, ...] = (0,),
               hetero_scale: float | None = None) -> FleetConfig:
    """Paper fleets: PAMAP2 = (3,3,2), MHEALTH = (3,3,4).

    hetero_scale: compute gap Full/Low (10/55/100); None = profile defaults
    (275/5 = 55x, the paper's "Moderate").
    """
    rows = ([("full", tuple(range(M)))] * n_full +
            [("mid", mid_modalities)] * n_mid +
            [("low", low_modalities)] * n_low)
    N = len(rows)
    mask = np.zeros((N, M), bool)
    tops = np.zeros(N)
    pa = np.zeros(N)
    pc = np.zeros(N)
    pi = np.zeros(N)
    bw = np.zeros(N)
    names = []
    for i, (ty, mods) in enumerate(rows):
        prof = DEVICE_PROFILES[ty]
        mask[i, list(mods)] = True
        t = prof.tops
        if hetero_scale is not None and ty != "full":
            base = DEVICE_PROFILES["full"].tops
            # keep the paper's mid/low ratio but rescale the full/low gap
            rel = {"mid": 21.0 / 5.0, "low": 1.0}[ty]
            t = base / hetero_scale * rel
        tops[i] = t
        pa[i], pc[i], pi[i] = prof.active_power_w, prof.comm_power_w, prof.idle_power_w
        bw[i] = prof.bandwidth_mbps
        names.append(ty)
    return FleetConfig(mask, tops, pa, pc, pi, bw, names)


def scale_fleet(fleet: FleetConfig, n_clients: int,
                rng: np.random.Generator) -> FleetConfig:
    """Tables IV-V fleet-size sweep: replicate the type mixture to N."""
    idx = rng.integers(0, fleet.N, size=n_clients)
    return fleet.subset(idx)
