"""Fleet fault injection: dropout, stalls, and Byzantine delta corruption.

Real IoT fleets drop, stall, and lie — and RELIEF's cohort-wise aggregation
(paper Eq. 3) makes rare-modality cohorts *small by construction*, so a
single corrupted client can dominate an entire modality block. This module
is the attack side of that story: a composable ``FaultModel`` consumed by
both async runtimes (core/async_engine.py), with the robust within-cohort
reducers in core/aggregation.py as the defence.

Fault channels (all optional, all applied only to the *faulty population*
selected by ``byzantine_frac`` / ``target_modality``):

    dropout      the cycle's completion never reaches the server: no energy
                 is accrued, nothing is buffered, the client is simply
                 redispatched at the time the completion would have fired
                 (a mid-round crash + reboot)
    stall        the cycle's compute time is multiplied by ``stall_factor``
                 (thermal throttling / contention); energy scales with it
    corruption   the uploaded delta is replaced before the (optional) int8
                 uplink quantization:
                   sign_flip   d -> -scale * d        (gradient inversion)
                   gauss       d -> d + scale * N(0,I) (blow-up noise)
                   collusion   d -> scale * u          (all Byzantine clients
                               push one shared pseudo-random direction u)

Determinism: Byzantine membership is a pure function of (seed, fleet);
per-cycle draws are keyed by (seed, client, dispatch ticket) — counter-based
like the cohort-mode batch draws — so fault realizations are independent of
event interleaving and the heap / vectorized runtimes stay history-
equivalent under an identical ``FaultModel`` (tests/test_torch_faults.py).

Per-cohort targeting: ``target_modality = m`` restricts the Byzantine set
to clients *possessing* modality m, concentrating the attack inside that
modality's aggregation cohort — the configuration that breaks plain-mean
cohort aggregation at the smallest global attacker budget.

Caveat: ``dropout_prob = 1.0`` with ``byzantine_frac = 1.0`` never absorbs
a completion — the run cannot terminate. Keep some honest clients.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, map_with_path

CORRUPTIONS = ("none", "sign_flip", "gauss", "collusion")

# rng stream salts — distinct sub-streams of the model seed
_BYZ_SALT = 0xB12A
_CYCLE_SALT = 0xFA017
_GAUSS_SALT = 0x6A55
_COLLUDE_SALT = 0xC011


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Declarative fault/attack configuration (hangs off AsyncFedConfig)."""
    seed: int = 0
    byzantine_frac: float = 0.0  # fraction of the candidate set that faults
    corruption: str = "sign_flip"  # none | sign_flip | gauss | collusion
    corruption_scale: float = 10.0
    dropout_prob: float = 0.0  # P(cycle's completion is lost), per cycle
    stall_prob: float = 0.0  # P(cycle is stalled), per cycle
    stall_factor: float = 10.0  # compute-time multiplier when stalled
    target_modality: int | None = None  # restrict faults to possessors of m
    # the collusion direction per (leaf shapes, device), drawn once
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False, hash=False)

    def __post_init__(self):
        if self.corruption not in CORRUPTIONS:
            raise ValueError(f"corruption must be one of {CORRUPTIONS}, "
                             f"got {self.corruption!r}")
        if not 0.0 <= self.byzantine_frac <= 1.0:
            raise ValueError("byzantine_frac must be in [0, 1]")

    @property
    def active(self) -> bool:
        return self.byzantine_frac > 0.0

    # -- membership -----------------------------------------------------------

    def byzantine_mask(self, modality_mask: np.ndarray) -> np.ndarray:
        """[N, M] possession -> [N] bool faulty membership.

        A seeded permutation of the candidate set (possessors of
        ``target_modality``, or the whole fleet) takes the first
        round(byzantine_frac * n_candidates) clients — deterministic in
        (seed, fleet) and independent of runtime event order.
        """
        mm = np.asarray(modality_mask, bool)
        byz = np.zeros(mm.shape[0], bool)
        if self.byzantine_frac <= 0.0:
            return byz
        if self.target_modality is not None:
            cand = np.nonzero(mm[:, self.target_modality])[0]
        else:
            cand = np.arange(mm.shape[0])
        n_byz = int(round(self.byzantine_frac * len(cand)))
        rng = np.random.default_rng([self.seed, _BYZ_SALT])
        byz[rng.permutation(cand)[:n_byz]] = True
        return byz

    # -- per-cycle system faults ----------------------------------------------

    def cycle_faults(self, byz: np.ndarray, clients: np.ndarray,
                     tickets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """-> (dropped [B] bool, slowdown [B] float) for one dispatch batch.

        Draws are keyed by (seed, client, ticket) so a cycle's fate is a
        pure function of *which* cycle it is, not of when the runtime
        happens to simulate it.
        """
        B = len(clients)
        dropped = np.zeros(B, bool)
        slow = np.ones(B)
        if self.dropout_prob <= 0.0 and self.stall_prob <= 0.0:
            return dropped, slow
        for i in np.nonzero(byz[clients])[0]:
            r = np.random.default_rng(
                [self.seed, _CYCLE_SALT, int(clients[i]), int(tickets[i])])
            u_drop, u_stall = r.random(2)
            dropped[i] = u_drop < self.dropout_prob
            if u_stall < self.stall_prob:
                slow[i] = self.stall_factor
        return dropped, slow

    # -- delta corruption -----------------------------------------------------

    def _collusion_direction(self, shapes: tuple, device) -> list:
        """The shared attack direction u, pre-multiplied by the scale: one
        pseudo-random draw per leaf (in flattened leaf order), identical for
        every colluder and every cycle; drawn once per tree of shapes and
        device."""
        key = (shapes, str(device))
        if key not in self._cache:
            rng = np.random.default_rng([self.seed, _COLLUDE_SALT])
            c = np.float32(self.corruption_scale)
            self._cache[key] = [
                torch.as_tensor(c * rng.standard_normal(s).astype(np.float32),
                                device=device) for s in shapes]
        return self._cache[key]

    def corrupt_stack(self, deltas: Any, byz_rows: np.ndarray,
                      clients: np.ndarray, tickets: np.ndarray) -> Any:
        """Corrupt the Byzantine rows of a client-stacked delta tree, on the
        leaves' own device.

        deltas: [B, ...] leaves (fp32, pre-quantization); byz_rows: [B]
        bool; clients/tickets: [B] draw keys. Gaussian noise is drawn on the
        host per (seed, client, ticket), sequentially over the flattened
        leaf order (sorted keys), and copied over, so any two callers
        corrupting the same cycle of the same client produce bit-identical
        payloads regardless of batch composition.
        """
        if self.corruption == "none":
            return deltas
        rows = np.nonzero(np.asarray(byz_rows, bool))[0]
        if len(rows) == 0:
            return deltas
        paths = [p for p, _ in leaves_with_path(deltas)]
        out = {p: x.float().clone() for p, x in leaves_with_path(deltas)}
        dev = next(iter(out.values())).device
        rows_t = torch.as_tensor(rows, device=dev)
        c = float(np.float32(self.corruption_scale))
        if self.corruption == "sign_flip":
            for x in out.values():
                x[rows_t] = -c * x[rows_t]
        elif self.corruption == "gauss":
            c32 = np.float32(self.corruption_scale)
            for i in rows:
                rng = np.random.default_rng(
                    [self.seed, _GAUSS_SALT, int(clients[i]),
                     int(tickets[i])])
                for p in paths:
                    x = out[p]
                    noise = c32 * rng.standard_normal(
                        tuple(x.shape[1:])).astype(np.float32)
                    x[i] = x[i] + torch.as_tensor(noise, device=dev)
        else:  # collusion
            u = self._collusion_direction(
                tuple(tuple(out[p].shape[1:]) for p in paths), dev)
            for p, d in zip(paths, u):
                out[p][rows_t] = d
        return map_with_path(lambda p, _: out[p], deltas)


class FaultRuntime:
    """Per-run fault-injection state shared by both async runtimes: the
    resolved Byzantine membership and the per-client dispatch ticket counter
    that keys the counter-based fault draws."""

    def __init__(self, model: FaultModel, modality_mask: np.ndarray):
        self.model = model
        self.byz = model.byzantine_mask(modality_mask)
        self.tickets = np.zeros(len(self.byz), np.int64)

    def on_dispatch(self, clients: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
        """Advance the dispatch tickets for ``clients`` and draw this
        cycle's faults -> (dropped [B], slowdown [B], byz_rows [B],
        tickets [B])."""
        t = self.tickets[clients].copy()
        self.tickets[clients] += 1
        dropped, slow = self.model.cycle_faults(self.byz, clients, t)
        return dropped, slow, self.byz[clients], t

    def corrupt(self, deltas: Any, byz_rows: np.ndarray, clients: np.ndarray,
                tickets: np.ndarray) -> Any:
        return self.model.corrupt_stack(deltas, byz_rows, clients, tickets)
