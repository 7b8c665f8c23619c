"""Event-driven asynchronous federated runtime (RELIEF beyond the barrier).

Each client trains continuously against the freshest model it pulled;
completions arrive on a priority queue of simulated (compute + comm) times
(sim/events.py), and the server applies buffered, staleness-discounted
cohort aggregation:

  * a FedBuff-style buffer of size K -- the server folds the model forward
    once K completions are queued (K = N on a homogeneous fleet reproduces
    the synchronous engine);
  * each buffered update is discounted by 1/(1+s)^a, s = server versions
    elapsed since the client pulled;
  * aggregation goes through the streaming ``aggregation.CohortAggBuffer``,
    so rare-modality blocks aggregate only within their possession cohort
    and an empty cohort freezes its block. Every flush launches one fused
    cohort-agg kernel on the fusion leaf: the fp32 kernel, or with
    ``uplink_codec="int8"`` the quantized-ingest kernel.

Ported: the heap runtime ``AsyncFedRun`` on Backbone 1 with both uplink
codecs (client-side int8 error feedback included). Not ported yet, and
refused by ``_check_strategy`` or the buffer: fault injection, time-varying
modality schedules, selective upload, robust reducers, HeLoRA rank caps,
Backbone 2's layer-stacked groups; the vectorized runtime waits as well.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core import aggregation as AG
from repro_torch.core import mdlora
from repro_torch.core.engine import (AllocPlan, FedConfig, allocate,
                                     allocate_rows, draw_client_batches,
                                     make_local_update, plan_allocation,
                                     simulated_flops)
from repro_torch.core.strategies import AsyncStrategy
from repro_torch.core.tasks import MMTask
from repro_torch.sim import FleetConfig
from repro_torch.sim.events import AsyncTrace, EventQueue, completion_times
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AsyncFedConfig(FedConfig):
    """FedConfig + event-runtime knobs. ``rounds`` keeps its meaning as the
    *logical* round budget: the default total work is rounds * N client
    updates. Where the cohort reduction runs follows the trainable's device
    (the CUDA kernels on the card, their plain versions on the CPU)."""
    jitter_sigma: float = 0.0  # lognormal compute-time noise (0 = exact)
    total_updates: int | None = None  # overrides rounds * N when set
    # uplink codec: "none" ships fp32 deltas; "int8" quantizes client-side
    # with error feedback and the server ingests the int8 payload natively
    # (dequantization and staleness discount fused into the reduction)
    uplink_codec: str = "none"
    faults: Any = None  # fault injection: not ported, must stay None
    modality_schedule: Any = None  # streaming masks: not ported, must be None


@dataclasses.dataclass
class AsyncFedState:
    round: int  # server model version = number of flushes applied
    trainable: Any
    dbar: np.ndarray  # [G] EMA divergence (drives allocation, Eq. 5-6)
    mag_ema: np.ndarray  # [G]
    rng: np.random.Generator
    sim_time: float = 0.0


def _make_state(G: int, trainable0: Any, seed: int) -> AsyncFedState:
    return AsyncFedState(round=0, trainable=trainable0,
                         dbar=np.ones(G) * 1e-6, mag_ema=np.ones(G),
                         rng=np.random.default_rng(seed))


UPLINK_CODECS = ("none", "int8")


def _check_strategy(strategy: AsyncStrategy, fed: AsyncFedConfig) -> None:
    if strategy.personal or strategy.share_only:
        raise ValueError("async runtime keeps one global model; "
                         "personalized strategies are sync-only")
    if strategy.agg not in ("cohort", "fedavg"):
        raise ValueError(f"async runtime supports cohort/fedavg "
                         f"aggregation, not {strategy.agg!r}")
    if fed.uplink_codec not in UPLINK_CODECS:
        raise ValueError(f"uplink_codec must be one of {UPLINK_CODECS}, "
                         f"got {fed.uplink_codec!r}")
    for what, unported in (("robust reducers", strategy.robust != "mean"),
                           ("HeLoRA rank caps", bool(strategy.rank_caps)),
                           ("selective upload", strategy.selective),
                           ("fault injection", fed.faults is not None),
                           ("modality schedules",
                            fed.modality_schedule is not None)):
        if unported:
            raise NotImplementedError(f"{what} are not ported yet")


def _history_init() -> dict:
    return {"flush": [], "loss": [], "sim_time_s": [], "energy_j": [],
            "upload_mb": [], "staleness_mean": [], "f1": [],
            "f1_flush": [], "divergence": [], "selected_frac": []}


@dataclasses.dataclass
class _Pending:
    """One in-flight client update, created at dispatch (the delta is a pure
    function of the pulled model + batch draw, so simulation computes it
    eagerly; only its *arrival time* is event-driven)."""
    client: int
    version: int  # server version pulled at dispatch
    delta: Any  # trainable-shaped update, or (int8 tree, scale tree)
    loss: float
    S_row: np.ndarray  # [G] groups trained and uploaded
    t_comp: float
    t_comm: float
    upload_bytes: float
    mmask_row: np.ndarray  # [M] modality mask at dispatch


class _ServerFlushMixin:
    """The server-side flush. Expects ``task/strategy/fleet/fed/state/
    trace/history/aggbuf`` attributes on self; ``aggbuf`` is the
    run-lifetime CohortAggBuffer, reset between flushes."""

    @property
    def _uplink_bytes_per_param(self) -> float:
        """Simulated uplink cost per shipped parameter (int8 = 1 byte)."""
        return 1.0 if self.fed.uplink_codec == "int8" else 4.0

    def _flush_arrays(self, deltas: Any, S: np.ndarray,
                      client_ids: np.ndarray, losses: np.ndarray,
                      staleness: np.ndarray,
                      mmask_rows: np.ndarray | None = None) -> dict:
        """Fold one buffered cohort into the global model (one server
        version). ``deltas``: client-stacked tree ([K, ...] leaves) or an
        ``aggregation.QuantizedStack``; rows aligned with ``S``/
        ``client_ids``/``losses``/``staleness``, sorted by client id."""
        task, fleet, fed = self.task, self.fleet, self.fed
        layout, state = task.layout, self.state
        dev = leaves(state.trainable)[0].device
        K = len(client_ids)
        quant = isinstance(deltas, AG.QuantizedStack)
        staleness = np.asarray(staleness, np.float64)
        if mmask_rows is None:
            mmask_rows = fleet.modality_mask[client_ids]
        fresh = np.ones(K, bool)
        if self.strategy.max_staleness is not None:
            fresh = staleness <= self.strategy.max_staleness
            S = S * fresh[:, None]

        f32 = dict(dtype=torch.float32, device=dev)
        trained = torch.as_tensor(S, **f32)
        mmask = torch.as_tensor(mmask_rows, **f32)
        stale_t = torch.as_tensor(staleness, **f32)
        a = self.strategy.staleness_exponent
        scale = None if a == 0.0 else AG.staleness_discounts(stale_t, a)
        # quantized ingest applies the discount *inside* the fused
        # reduction, so keep it out of the numerator (defer_scale)
        wkw = dict(client_scale=scale, defer_scale=quant)
        if self.strategy.agg == "cohort":
            W = AG.cohort_weights(layout, trained, mmask, **wkw)
        else:  # fedavg: every (fresh) buffered client into every group
            ones = torch.as_tensor(
                np.tile(layout.sizes[None, :] > 0, (K, 1)) & fresh[:, None],
                **f32)
            W = AG.cohort_weights(layout, ones, torch.ones_like(mmask), **wkw)

        # divergence cohort: possession AND trained (Eq. 5 on the buffer)
        C = torch.as_tensor(layout.accessible(mmask_rows) & (S > 0), **f32)

        self.aggbuf.reset()
        if quant:
            self.aggbuf.push_quantized(deltas.q, deltas.scales, W, C,
                                       stale_t, a)
        else:
            self.aggbuf.push(deltas, W, C)
        agg_tree, d, cnt = self.aggbuf.finalize()

        state.trainable = tree_map(
            lambda t, g: (t.float() + fed.server_lr * g).to(t.dtype),
            state.trainable, agg_tree)

        d_np = d.cpu().numpy()
        touched = cnt.cpu().numpy() > 0
        state.dbar[touched] = (fed.gamma * d_np
                               + (1.0 - fed.gamma) * state.dbar)[touched]
        # magnitude EMA diagnostic over the K-client buffer (dequantizes the
        # int8 stack for stats only; the reduction above never built it)
        norm_src = (dist.dequantize_int8_stacked(deltas.q, deltas.scales)
                    if quant else deltas)
        per_client_norms = mdlora.group_norms(layout, norm_src,
                                              batch_dims=1).cpu().numpy()
        denom = np.maximum(S.sum(0), 1)
        mag = (per_client_norms * S).sum(0) / denom
        sel = S.any(0)
        state.mag_ema[sel] = (0.5 * state.mag_ema + 0.5 * mag)[sel]

        state.round += 1
        self.trace.flushes += 1
        rec = {"flush": state.round, "sim_time_s": state.sim_time,
               "loss": float(np.mean(losses)),
               "staleness_mean": float(staleness.mean()),
               "energy_j": self.trace.energy_j,
               "upload_mb": self.trace.upload_mb,
               "selected_frac": float(S.mean()), "divergence": d_np}
        for key in ("flush", "loss", "sim_time_s", "energy_j", "upload_mb",
                    "staleness_mean", "selected_frac", "divergence"):
            self.history[key].append(rec[key])
        return rec

    def _log_and_eval(self, rec: dict, dataset, log_every: int,
                      tag: str) -> None:
        if log_every and rec["flush"] % log_every == 0:
            print(f"[{tag}] flush "
                  f"{rec['flush']:5d} t={rec['sim_time_s']:9.3f}s"
                  f" loss {rec['loss']:.4f} "
                  f"stale {rec['staleness_mean']:.1f}")
        if (self.fed.eval_every and dataset is not None
                and rec["flush"] % self.fed.eval_every == 0):
            self.history["f1"].append(self.evaluate(dataset))
            self.history["f1_flush"].append(rec["flush"])

    def evaluate(self, dataset) -> float:
        xs = np.concatenate(dataset.test_x)
        ys = np.concatenate(dataset.test_y)
        return self.task.eval_f1(self.state.trainable, xs, ys)


@dataclasses.dataclass
class AsyncFedRun(_ServerFlushMixin):
    task: MMTask
    strategy: AsyncStrategy
    fleet: FleetConfig
    fed: AsyncFedConfig
    state: AsyncFedState
    local_update: Any
    queue: EventQueue
    buffer: list
    trace: AsyncTrace
    history: dict
    aggbuf: AG.CohortAggBuffer
    # client-side error-feedback residuals (uplink_codec="int8"): the
    # quantization error stays on the device and is added to its next
    # update, so the compressed stream telescopes to the uncompressed one
    ef: dict = dataclasses.field(default_factory=dict)
    # fleet-static allocation inputs (None for alloc="random", which redraws
    # fleet-shaped noise per dispatch through allocate() to keep its stream)
    plan: AllocPlan | None = None

    @classmethod
    def create(cls, task: MMTask, trainable0: Any, strategy: AsyncStrategy,
               fleet: FleetConfig, fed: AsyncFedConfig) -> AsyncFedRun:
        _check_strategy(strategy, fed)
        state = _make_state(task.layout.G, trainable0, fed.seed)
        trace = AsyncTrace()
        trace.init_fleet(fleet.N)
        plan = (plan_allocation(strategy, task, fleet, fed, task.layout.flops)
                if strategy.alloc != "random" else None)
        return cls(task, strategy, fleet, fed, state,
                   make_local_update(task, fed, strategy.prox_mu),
                   EventQueue(), [], trace, _history_init(),
                   AG.CohortAggBuffer(task.layout, trainable0), plan=plan)

    # -- client dispatch ------------------------------------------------------

    def _dispatch(self, clients: np.ndarray, now: float, dataset) -> None:
        """Pull the current model to ``clients``, run their local training
        eagerly, and schedule their completion events."""
        task, fed, fleet = self.task, self.fed, self.fleet
        layout, state = task.layout, self.state
        clients = np.asarray(clients, np.int64)
        K = len(clients)
        if K == 0:
            return
        dev = leaves(state.trainable)[0].device

        live_mm = fleet.modality_mask[clients]
        if self.plan is None:  # alloc="random": full-fleet rng draw
            S_full, _ = allocate(self.strategy, state, task, fleet, fed,
                                 layout.flops)
            S = S_full[clients]  # [K, G]
        else:
            S = allocate_rows(self.plan, self.strategy, state, clients)

        steps = fed.local_epochs * fed.steps_per_epoch
        batches = draw_client_batches(state.rng, dataset, clients, steps,
                                      fed.batch_size, dev)
        start = tree_map(lambda g: g.expand((K,) + g.shape), state.trainable)
        gates = torch.as_tensor(S, dtype=torch.float32, device=dev)
        mmasks = torch.as_tensor(live_mm, dtype=torch.float32, device=dev)
        deltas, losses = self.local_update(start, batches, mmasks, gates,
                                           fed.lr)

        trained_fl, fixed_fl = simulated_flops(task, fed, S)
        upload = ((np.asarray(S, np.float64) @ layout.sizes)
                  * self._uplink_bytes_per_param)
        dur, t_comp, t_comm = completion_times(
            fleet, clients, trained_fl, fixed_fl, upload, fed.t_overhead,
            fed.utilization, fed.jitter_sigma, state.rng)

        quantize = fed.uplink_codec == "int8"
        losses_np = losses.detach().cpu().numpy()
        for i, c in enumerate(clients):
            d_i = tree_map(lambda x, i=i: x[i], deltas)
            if quantize:  # client-side compression, EF residual stays local
                q_i, s_i, resid = dist.quantize_int8_ef(d_i, self.ef.get(int(c)))
                self.ef[int(c)] = resid
                d_i = (q_i, s_i)
            pend = _Pending(int(c), state.round, d_i, float(losses_np[i]),
                            S[i], float(t_comp[i]), float(t_comm[i]),
                            float(upload[i]), live_mm[i])
            self.queue.push(now + dur[i], int(c), payload=pend)

    # -- server flush ---------------------------------------------------------

    def _flush(self) -> dict:
        """Stack the buffered cohort (client-id order) and fold it into the
        global model through the shared ``_flush_arrays``."""
        entries = sorted(self.buffer, key=lambda e: e.client)
        self.buffer = []
        stack = lambda *xs: torch.stack(xs)  # noqa: E731
        if self.fed.uplink_codec == "int8":
            deltas = AG.QuantizedStack(
                tree_map(stack, *[e.delta[0] for e in entries]),
                tree_map(stack, *[e.delta[1] for e in entries]))
        else:
            deltas = tree_map(stack, *[e.delta for e in entries])
        S = np.stack([e.S_row for e in entries])  # [K, G]
        client_ids = np.array([e.client for e in entries])
        staleness = np.array([self.state.round - e.version for e in entries],
                             np.float64)
        losses = np.array([e.loss for e in entries])
        mmask_rows = np.stack([e.mmask_row for e in entries])
        return self._flush_arrays(deltas, S, client_ids, losses, staleness,
                                  mmask_rows=mmask_rows)

    # -- the event loop -------------------------------------------------------

    def run(self, dataset, total_updates: int | None = None,
            log_every: int = 0) -> dict:
        """Process client completions until ``total_updates`` of them have
        been absorbed (default: rounds * N, the sync engine's total work)."""
        fed, fleet = self.fed, self.fleet
        total = (total_updates or fed.total_updates
                 or fed.rounds * fleet.N)
        K = max(1, min(self.strategy.buffer_size, fleet.N))
        if not len(self.queue):
            self._dispatch(np.arange(fleet.N), self.state.sim_time, dataset)
        processed = 0
        while processed < total and self.queue:
            events = self.queue.pop_simultaneous()
            now = events[0].time
            self.state.sim_time = now
            completed = []
            for ev in events:
                pend: _Pending = ev.payload
                completed.append(ev.client)
                self.buffer.append(pend)
                self.trace.record_completion(fleet, ev.client, pend.t_comp,
                                             pend.t_comm, pend.upload_bytes)
                processed += 1
                if len(self.buffer) >= K:
                    rec = self._flush()
                    self._log_and_eval(rec, dataset, log_every,
                                       self.strategy.name)
                if processed >= total:
                    break
            if processed < total:
                self._dispatch(np.array(completed), now, dataset)
        self.trace.sim_time = self.state.sim_time
        if not self.history["f1"]:
            self.history["f1"].append(self.evaluate(dataset))
            self.history["f1_flush"].append(self.state.round)
        return self.history
