"""Event-driven simulation primitives for the asynchronous federated runtime.

The synchronous engine advances time one barrier per round; here time is a
priority queue of client-completion events. Each client cycles

    dispatch (pull model v) -> local compute -> upload -> COMPLETION event

with (compute + comm) duration drawn from the same FLOP-proportional device
model as the synchronous simulator (sim/timing.py:per_client_times), plus an
optional lognormal jitter for non-deterministic system noise. Ties in
completion time (homogeneous fleets) are broken by push order, so event
processing is fully deterministic for a fixed seed — this is what makes the
sync-parity test bit-for-bit reproducible.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections.abc import Iterator
from typing import Any

import numpy as np

from repro_torch.sim.devices import FleetConfig
from repro_torch.sim.timing import per_client_times

COMPLETION = "completion"


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence. Ordering: (time, seq) — seq is the queue's
    monotone push counter, so equal-time events pop FIFO."""
    time: float
    seq: int
    client: int
    kind: str = COMPLETION
    payload: Any = None


class EventQueue:
    """Deterministic min-heap of Events keyed by (time, push order)."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0

    def push(self, time: float, client: int, kind: str = COMPLETION,
             payload: Any = None) -> Event:
        ev = Event(float(time), self._seq, int(client), kind, payload)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        self._seq += 1
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def peek_time(self) -> float:
        return self._heap[0][0]

    def pop_simultaneous(self) -> list[Event]:
        """Pop every event sharing the current minimum time (FIFO within the
        tie). Simultaneous completions are batched so the runtime can stack
        them through one vmapped local-update call."""
        if not self._heap:
            return []
        t0 = self.peek_time()
        out = [self.pop()]
        while self._heap and self.peek_time() == t0:
            out.append(self.pop())
        return out

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield self.pop()


def completion_times(fleet: FleetConfig, clients: np.ndarray,
                     trained_flops: np.ndarray, fixed_flops: np.ndarray,
                     upload_bytes: np.ndarray, t_overhead: float,
                     utilization: float,
                     jitter_sigma: float = 0.0,
                     rng: np.random.Generator | None = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cycle durations for a dispatched subset of clients.

    clients: [K] fleet indices; trained/fixed/upload: [K] aligned with it.
    -> (duration [K], t_comp [K], t_comm [K]); duration includes the
    per-interaction server overhead. jitter_sigma > 0 multiplies compute by
    lognormal(0, sigma) noise (mean ~1), modelling OS/thermal variance.
    """
    sub = fleet.subset(clients)
    t_comp, t_comm = per_client_times(sub, trained_flops, fixed_flops,
                                      upload_bytes, utilization)
    if jitter_sigma > 0.0 and rng is not None:
        t_comp = t_comp * rng.lognormal(0.0, jitter_sigma, size=t_comp.shape)
    return t_comp + t_comm + t_overhead, t_comp, t_comm


@dataclasses.dataclass
class AsyncTrace:
    """Running account of the simulated execution (async analog of
    timing.RoundCost, but cumulative: there is no round to amortize over)."""
    sim_time: float = 0.0
    completions: int = 0
    flushes: int = 0
    energy_j: float = 0.0
    upload_mb: float = 0.0
    per_client_updates: np.ndarray | None = None

    def init_fleet(self, n: int) -> None:
        self.per_client_updates = np.zeros(n, np.int64)

    def record_completion(self, fleet: FleetConfig, client: int,
                          t_comp: float, t_comm: float,
                          upload_bytes: float) -> None:
        self.completions += 1
        self.energy_j += (fleet.active_power[client] * t_comp
                          + fleet.comm_power[client] * t_comm)
        self.upload_mb += upload_bytes / 1e6
        if self.per_client_updates is not None:
            self.per_client_updates[client] += 1

    def record_completions(self, fleet: FleetConfig, clients: np.ndarray,
                           t_comp: np.ndarray, t_comm: np.ndarray,
                           upload_bytes: np.ndarray) -> None:
        """Vectorized ``record_completion`` over a completion batch (the
        structure-of-arrays runtime absorbs whole timestamp groups)."""
        clients = np.asarray(clients)
        self.completions += int(clients.size)
        self.energy_j += float(
            np.sum(fleet.active_power[clients] * t_comp
                   + fleet.comm_power[clients] * t_comm))
        self.upload_mb += float(np.sum(upload_bytes)) / 1e6
        if self.per_client_updates is not None:
            np.add.at(self.per_client_updates, clients, 1)

    def as_dict(self) -> dict:
        return {"sim_time_s": self.sim_time, "completions": self.completions,
                "flushes": self.flushes, "energy_j": self.energy_j,
                "upload_mb": self.upload_mb}
