"""Structure-of-arrays fleet state for million-client async simulation
(numpy only; the reference's ``sim/fleet.py``).

The event-driven runtime (core/async_engine.py + sim/events.py) keeps one
Python ``_Pending`` object per in-flight client and one heap entry per
completion — fine at N~100, hopeless at the ROADMAP's 10^5-10^6 clients.
Here every piece of per-client system state lives in a flat NumPy array
indexed by client id:

    t_next       [N] next completion time (+inf = idle or departed)
    seq          [N] dispatch counter at the last dispatch — replays the
                 event queue's FIFO tie-break exactly (equal times pop in
                 dispatch order), so the vectorized runtime reproduces the
                 heap-based loop event for event
    version      [N] server model version pulled at dispatch
    group_bits   [N] trained-group selection packed into a uint64 bitmask
    t_comp/t_comm/upload_bytes
                 [N] the in-flight cycle's cost split
    energy_j / updates
                 [N] cumulative per-client account (the SoA analog of
                 AsyncTrace.per_client_updates)
    alive        [N] population membership (churn model below)
    lost         [N] the client's pending completion was cancelled by a
                 departure — claimed-but-unabsorbed events can't be told
                 apart from idle by ``t_next`` alone, so cancellation is
                 tracked explicitly; only the next dispatch clears it
                 (re-arrival does NOT resurrect a lost update)

Event extraction replaces the heap with ``peek_window``: one
``np.partition`` pass finds the k-th smallest completion time, one threshold
scan collects every event at or below it (so FIFO tie groups are never
split), and the window is truncated to events provably unaffected by
redispatches of earlier events in the same window — a redispatched client
cannot complete sooner than ``gap`` (the per-cycle server overhead) after
its completion, so every event strictly inside ``[t0, t0 + gap)`` is safe
to process in one batch. With ``gap = 0`` this degenerates to the exact
``pop_simultaneous`` semantics of the heap loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.devices import FleetConfig

_EMPTY = np.empty(0, np.int64)


def pack_group_bits(S: np.ndarray) -> np.ndarray:
    """[B, G] bool selection -> [B] uint64 bitmask (bit g = group g)."""
    S = np.asarray(S, bool)
    G = S.shape[1]
    if G > 64:
        raise ValueError(f"group bitmask supports G <= 64, got G={G}")
    weights = np.uint64(1) << np.arange(G, dtype=np.uint64)
    return (S.astype(np.uint64) * weights[None, :]).sum(1, dtype=np.uint64)


def unpack_group_bits(bits: np.ndarray, G: int) -> np.ndarray:
    """[B] uint64 bitmask -> [B, G] bool selection."""
    weights = np.uint64(1) << np.arange(G, dtype=np.uint64)
    return (np.asarray(bits)[:, None] & weights[None, :]) != 0


@dataclasses.dataclass
class FleetState:
    """Flat per-client arrays for the vectorized async runtime."""
    t_next: np.ndarray  # [N] float64, +inf = no event scheduled
    seq: np.ndarray  # [N] int64 dispatch order (FIFO tie-break)
    version: np.ndarray  # [N] int64 pulled server version
    group_bits: np.ndarray  # [N] uint64 uploaded-group bitmask
    mod_bits: np.ndarray  # [N] uint64 live modality mask at dispatch
    t_comp: np.ndarray  # [N] in-flight compute seconds
    t_comm: np.ndarray  # [N] in-flight comm seconds
    upload_bytes: np.ndarray  # [N] in-flight upload volume
    energy_j: np.ndarray  # [N] cumulative energy
    updates: np.ndarray  # [N] int64 cumulative completions
    alive: np.ndarray  # [N] bool population membership
    lost: np.ndarray  # [N] bool pending completion cancelled by departure
    next_seq: int = 0
    in_flight: int = 0

    @classmethod
    def create(cls, n: int) -> FleetState:
        return cls(t_next=np.full(n, np.inf),
                   seq=np.zeros(n, np.int64),
                   version=np.zeros(n, np.int64),
                   group_bits=np.zeros(n, np.uint64),
                   mod_bits=np.zeros(n, np.uint64),
                   t_comp=np.zeros(n), t_comm=np.zeros(n),
                   upload_bytes=np.zeros(n), energy_j=np.zeros(n),
                   updates=np.zeros(n, np.int64),
                   alive=np.ones(n, bool),
                   lost=np.zeros(n, bool))

    @property
    def N(self) -> int:
        return self.t_next.shape[0]

    # -- scheduling -----------------------------------------------------------

    def dispatch(self, idx: np.ndarray, now: float, version: int,
                 bits: np.ndarray, dur: np.ndarray, t_comp: np.ndarray,
                 t_comm: np.ndarray, upload_bytes: np.ndarray) -> None:
        """Schedule completion events for (idle) clients ``idx``. ``idx``
        order defines the FIFO tie-break, matching EventQueue push order."""
        b = len(idx)
        if b == 0:
            return
        self.t_next[idx] = now + dur
        self.seq[idx] = np.arange(self.next_seq, self.next_seq + b)
        self.next_seq += b
        self.version[idx] = version
        self.group_bits[idx] = bits
        self.t_comp[idx] = t_comp
        self.t_comm[idx] = t_comm
        self.upload_bytes[idx] = upload_bytes
        self.lost[idx] = False
        self.in_flight += b

    def peek_window(self, k: int, gap: float
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Next-k extraction: -> (times, client idx), sorted by (time, seq).

        Includes every tie of the k-th smallest time (FIFO groups are never
        split) and truncates to events < t0 + ``gap`` — the earliest instant
        a redispatch of this window's first event could complete — so batch
        processing is order-identical to popping the heap one event at a
        time. Does not consume the events; call ``claim`` on (a prefix of)
        the returned indices."""
        t = self.t_next
        if self.in_flight == 0:
            return np.empty(0), _EMPTY
        k = min(max(k, 1), t.shape[0])
        kth = np.partition(t, k - 1)[k - 1]
        if np.isinf(kth):
            idx = np.nonzero(np.isfinite(t))[0]
        else:
            idx = np.nonzero(t <= kth)[0]
        idx = idx[np.lexsort((self.seq[idx], t[idx]))]
        times = t[idx]
        t0 = times[0]
        if gap > 0.0:
            cut = int(np.searchsorted(times, t0 + gap, side="left"))
        else:
            cut = int(np.searchsorted(times, t0, side="right"))
        return times[:cut].copy(), idx[:cut]

    def claim(self, idx: np.ndarray) -> None:
        """Consume scheduled events (the completions are being processed)."""
        self.t_next[idx] = np.inf
        self.in_flight -= len(idx)

    def complete(self, fleet: FleetConfig, idx: np.ndarray) -> None:
        """Accrue the finished cycle's energy/updates for clients ``idx``."""
        self.energy_j[idx] += (fleet.active_power[idx] * self.t_comp[idx]
                               + fleet.comm_power[idx] * self.t_comm[idx])
        self.updates[idx] += 1

    # -- population membership ------------------------------------------------

    def depart(self, idx: np.ndarray) -> None:
        """Remove clients from the population: any in-flight work is lost
        and they stop accruing energy/updates until they re-arrive. ``lost``
        marks the cancelled completion so a claimed-but-unabsorbed event is
        dropped at absorb time even if the client re-arrives first."""
        if len(idx) == 0:
            return
        self.in_flight -= int(np.isfinite(self.t_next[idx]).sum())
        self.t_next[idx] = np.inf
        self.alive[idx] = False
        self.lost[idx] = True

    def arrive(self, idx: np.ndarray) -> None:
        """Re-admit departed clients (idle until the runtime dispatches;
        ``lost`` stays set — a cancelled completion is never resurrected)."""
        self.alive[idx] = True


@dataclasses.dataclass(frozen=True)
class PopulationModel:
    """Memoryless arrivals/churn over the fleet population.

    Between consecutive event timestamps (dt apart), each alive client
    departs with probability 1 - exp(-churn_rate * dt) and each departed
    client re-arrives with probability 1 - exp(-arrival_rate * dt) —
    i.e. exponential sojourn times in both states. Departing in-flight
    clients lose their update (the completion never fires)."""
    churn_rate: float = 0.0  # departures per alive client per sim-second
    arrival_rate: float = 0.0  # re-arrivals per departed client per sim-sec

    def step(self, rng: np.random.Generator, state: FleetState, dt: float
             ) -> tuple[np.ndarray, np.ndarray]:
        """Advance membership by ``dt`` -> (departed idx, arrived idx)."""
        departed, arrived = _EMPTY, _EMPTY
        if dt <= 0.0:
            return departed, arrived
        if self.churn_rate > 0.0:
            p = -np.expm1(-self.churn_rate * dt)
            alive = np.nonzero(state.alive)[0]
            departed = alive[rng.random(alive.size) < p]
            state.depart(departed)
        if self.arrival_rate > 0.0:
            p = -np.expm1(-self.arrival_rate * dt)
            gone = np.nonzero(~state.alive)[0]
            arrived = gone[rng.random(gone.size) < p]
            state.arrive(arrived)
        return departed, arrived
