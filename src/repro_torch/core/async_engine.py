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
    ``uplink_codec="int8"`` the quantized-ingest kernel (a robust reducer
    dequantizes first and takes the fp32 kernel for the statistics).

Two runtimes share one server flush (``_ServerFlushMixin._flush_arrays``):

``AsyncFedRun``           the event loop: a heap of per-client ``_Pending``
                          updates, gradients computed eagerly at dispatch.
``VectorizedAsyncFedRun`` the structure-of-arrays fleet simulator
                          (sim/fleet.py): per-client state in flat arrays,
                          vectorized next-K extraction with the heap's FIFO
                          tie-break, and ``grad_mode``:

    "dispatch"  gradients at dispatch for every dispatched client: event for
                event the heap loop's history (small fleets).
    "cohort"    the whole fleet's time, energy and staleness are simulated,
                but local training runs only for the K flushed clients, each
                from the ring snapshot of the version it pulled, with
                counter-based batch draws (seed, client, ticket).
    "none"      system simulation only: no gradients, loss NaN.

Both take fault injection (``faults``: dropout, stalls, Byzantine
corruption before the int8 quantization), the robust cohort reducers of the
strategy, HeLoRA rank caps (the heap loop only, as in the reference),
time-varying modality schedules (``modality_schedule``, a
``sim.scenarios.StreamingSchedule``: each dispatch allocates and trains on
the masks live at its time, and the flush's cohorts follow them) and FedMFS
selective upload (``strategy.selective``: each client uploads the blocks of
highest norm per byte within ``comm_budget``; the vectorized runtime only in
grad mode "dispatch", where the deltas exist at dispatch). The vectorized
one also takes churn and re-arrivals.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core import aggregation as AG
from repro_torch.core import mdlora
from repro_torch.core.engine import (AllocPlan, FedConfig, ResidentWindows,
                                     _rank_gates, allocate, allocate_rows,
                                     hold_windows, make_local_update,
                                     plan_allocation, scenario_fed_kwargs,
                                     simulated_flops)
from repro_torch.core.strategies import AsyncStrategy
from repro_torch.core.tasks import MMTask
from repro_torch.sim import FaultModel, FaultRuntime, FleetConfig
from repro_torch.sim import timing as T
from repro_torch.sim.events import AsyncTrace, EventQueue, completion_times
from repro_torch.sim.fleet import (FleetState, PopulationModel,
                                   pack_group_bits, unpack_group_bits)
from repro_torch.tree import leaves, tree_map

GRAD_MODES = ("dispatch", "cohort", "none")


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
    # --- vectorized fleet runtime (VectorizedAsyncFedRun) ---
    grad_mode: str = "dispatch"  # dispatch | cohort | none (module doc)
    snapshot_ring: int = 8  # retained model versions for cohort gradients
    churn_rate: float = 0.0  # departures per alive client per sim-second
    arrival_rate: float = 0.0  # re-arrivals per departed client per sim-sec
    # fleet fault injection (sim/faults.py): Byzantine delta corruption,
    # mid-round dropout, stalls. None (or byzantine_frac = 0) = fault-free
    faults: FaultModel | None = None
    # time-varying modality availability (sim/scenarios.StreamingSchedule):
    # when set, each dispatch evaluates the client's live modality mask at
    # the dispatch time; allocation candidates, local-training masks and the
    # flush's cohorts follow it. None = the fleet's static possession mask
    modality_schedule: Any = None

    @classmethod
    def from_scenario(cls, spec, fleet=None, **overrides):
        """The async runtime config a ``sim.scenarios.ScenarioSpec``
        describes (duck-typed). A streaming scenario derives its
        ``modality_schedule`` from the spec (``fleet`` reuses an already
        built fleet's possession base)."""
        kw = scenario_fed_kwargs(spec) | dict(
            jitter_sigma=spec.jitter_sigma, total_updates=spec.total_updates,
            uplink_codec=spec.uplink_codec, grad_mode=spec.grad_mode,
            faults=spec.faults)
        if (getattr(spec, "missing", None) == "streaming"
                and "modality_schedule" not in overrides):
            from repro_torch.sim.scenarios import schedule_for

            kw["modality_schedule"] = schedule_for(spec, fleet)
        return cls(**(kw | overrides))


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


def _check_strategy(strategy: AsyncStrategy, fed: AsyncFedConfig,
                    fleet: FleetConfig | None = None) -> None:
    if strategy.personal or strategy.share_only:
        raise ValueError("async runtime keeps one global model; "
                         "personalized strategies are sync-only")
    if strategy.agg not in ("cohort", "fedavg"):
        raise ValueError(f"async runtime supports cohort/fedavg "
                         f"aggregation, not {strategy.agg!r}")
    if fed.uplink_codec not in UPLINK_CODECS:
        raise ValueError(f"uplink_codec must be one of {UPLINK_CODECS}, "
                         f"got {fed.uplink_codec!r}")
    if strategy.robust not in AG.ROBUST_AGGREGATORS:
        raise ValueError(f"robust must be one of {AG.ROBUST_AGGREGATORS}, "
                         f"got {strategy.robust!r}")
    if strategy.selective and not 0.0 < strategy.comm_budget <= 1.0:
        raise ValueError(f"comm_budget must be in (0, 1], "
                         f"got {strategy.comm_budget}")
    sched = fed.modality_schedule
    if sched is not None:
        if strategy.alloc == "random":
            raise ValueError("alloc='random' redraws fleet-shaped noise per "
                             "dispatch; incompatible with a time-varying "
                             "modality schedule")
        if fleet is not None and (sched.N != fleet.N or sched.M != fleet.M):
            raise ValueError(f"modality_schedule shape ({sched.N}, {sched.M})"
                             f" does not match fleet ({fleet.N}, {fleet.M})")


def _make_fault_runtime(fed: AsyncFedConfig,
                        fleet: FleetConfig) -> FaultRuntime | None:
    if fed.faults is not None and fed.faults.active:
        return FaultRuntime(fed.faults, fleet.modality_mask)
    return None


def _make_aggbuf(task: MMTask, trainable0: Any,
                 strategy: AsyncStrategy) -> AG.CohortAggBuffer:
    return AG.CohortAggBuffer(task.layout, trainable0, robust=strategy.robust,
                              trim_frac=strategy.trim_frac,
                              krum_f=strategy.krum_f)


def _selective_upload(layout: mdlora.GroupLayout, deltas: Any,
                      S: np.ndarray, budget: float) -> np.ndarray:
    """FedMFS selective modality communication: which trained blocks to
    upload. Per client, blocks are ranked by utility per byte,
    ||delta_g||^2 / size_g (the marginal-contribution proxy of
    arXiv:2310.07048), and taken greedily while the cumulative size fits
    ``budget`` x (the client's full trained upload). The top block is always
    taken (an empty upload would stall the protocol); a later block that
    overflows is skipped, not a stop, so the knapsack packs tightly.

    Deterministic in (deltas, S): no rng, a stable sort, and norms summed
    without atomics (``mdlora.group_norms``), so both runtimes select the
    same sets for the same dispatches, call after call."""
    norms = mdlora.group_norms(layout, deltas,
                               batch_dims=1).cpu().numpy()  # [K, G] squared
    sizes = np.asarray(layout.sizes, np.float64)
    S = np.asarray(S, bool)
    S_up = np.zeros_like(S)
    for k in range(S.shape[0]):
        cand = np.nonzero(S[k])[0]
        if len(cand) == 0:
            continue
        cap = budget * float(sizes[cand].sum())
        density = norms[k, cand] / np.maximum(sizes[cand], 1.0)
        order = cand[np.argsort(-density, kind="stable")]
        spent = 0.0
        for j, g in enumerate(order):
            if j == 0 or spent + sizes[g] <= cap:
                S_up[k, g] = True
                spent += sizes[g]
    return S_up


def _gate_rows(layout: mdlora.GroupLayout, deltas: Any,
               S_up: np.ndarray) -> Any:
    """Zero the blocks a client does not upload in a client-stacked tree."""
    dev = leaves(deltas)[0].device
    return mdlora.group_gate_tree(
        layout, deltas, torch.as_tensor(S_up, dtype=torch.float32,
                                        device=dev))


def _live_masks(fed: AsyncFedConfig, fleet: FleetConfig, clients: np.ndarray,
                now: float) -> np.ndarray:
    """[B, M] modality masks of ``clients`` at dispatch time ``now``: the
    schedule's live masks, or the fleet's static possession without one."""
    sched = fed.modality_schedule
    return (sched.masks_at(now, clients) if sched is not None
            else fleet.modality_mask[clients])


def _allocate_live(plan: AllocPlan, strategy: AsyncStrategy, state: Any,
                   layout: mdlora.GroupLayout, clients: np.ndarray,
                   live_mm: np.ndarray, fed: AsyncFedConfig) -> np.ndarray:
    """S rows for a dispatch. Under a modality schedule the candidates (and
    the mandatory fusion blocks) follow the masks live at dispatch; the
    budgets stay the plan's, solved over the base fleet."""
    if fed.modality_schedule is None:
        return allocate_rows(plan, strategy, state, clients)
    unaware = strategy.alloc in ("full", "magnitude", "depth")
    return allocate_rows(
        plan, strategy, state, clients,
        cand=None if unaware else layout.accessible(live_mm),
        mandatory=(layout.mandatory(live_mm) if strategy.mandatory
                   else None))


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
    S_row: np.ndarray  # [G] groups uploaded (= trained unless selective)
    t_comp: float
    t_comm: float
    upload_bytes: float
    mmask_row: np.ndarray  # [M] live modality mask at dispatch
    # fault-injected mid-round crash: the completion event still fires (it
    # times the client's reboot and redispatch) but is never absorbed: no
    # buffer entry, no energy or upload accounting, no progress
    dropped: bool = False


class _ServerFlushMixin:
    """The server-side flush, shared by both runtimes. Expects
    ``task/strategy/fleet/fed/state/trace/history/aggbuf`` attributes on
    self; ``aggbuf`` is the run-lifetime CohortAggBuffer, reset between
    flushes."""

    @property
    def _uplink_bytes_per_param(self) -> float:
        """Simulated uplink cost per shipped parameter (int8 = 1 byte)."""
        return 1.0 if self.fed.uplink_codec == "int8" else 4.0

    def _flush_arrays(self, deltas: Any, S: np.ndarray,
                      client_ids: np.ndarray, losses: np.ndarray | None,
                      staleness: np.ndarray,
                      mmask_rows: np.ndarray | None = None) -> dict:
        """Fold one buffered cohort into the global model (one server
        version). ``deltas``: client-stacked tree ([K, ...] leaves) or an
        ``aggregation.QuantizedStack``; rows aligned with ``S``/
        ``client_ids``/``losses``/``staleness``, sorted by client id.
        ``deltas=None`` is a system-only flush (grad_mode "none"):
        staleness and energy accounting advance, the model and divergence
        state stay as they are, and the loss records as NaN."""
        task, fleet, fed = self.task, self.fleet, self.fed
        layout, state = task.layout, self.state
        K = len(client_ids)
        quant = isinstance(deltas, AG.QuantizedStack)
        staleness = np.asarray(staleness, np.float64)
        # cohorts are per flush: under a streaming schedule each buffered
        # update carries the modality mask it was dispatched with, and both
        # the Eq. 3-4 cohort weights and the Eq. 5 divergence cohorts follow
        # it instead of the fleet's static possession
        if mmask_rows is None:
            mmask_rows = fleet.modality_mask[client_ids]
        fresh = np.ones(K, bool)
        if self.strategy.max_staleness is not None:
            fresh = staleness <= self.strategy.max_staleness
            S = S * fresh[:, None]

        if deltas is not None:
            dev = leaves(state.trainable)[0].device
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
                    np.tile(layout.sizes[None, :] > 0, (K, 1))
                    & fresh[:, None], **f32)
                W = AG.cohort_weights(layout, ones, torch.ones_like(mmask),
                                      **wkw)

            # divergence cohort: possession AND trained (Eq. 5 on the buffer)
            C = torch.as_tensor(layout.accessible(mmask_rows) & (S > 0),
                                **f32)

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
            # magnitude EMA diagnostic over the K-client buffer (dequantizes
            # the int8 stack for stats only; the reduction never built it)
            norm_src = (dist.dequantize_int8_stacked(deltas.q, deltas.scales)
                        if quant else deltas)
            per_client_norms = mdlora.group_norms(layout, norm_src,
                                                  batch_dims=1).cpu().numpy()
            denom = np.maximum(S.sum(0), 1)
            mag = (per_client_norms * S).sum(0) / denom
            sel = S.any(0)
            state.mag_ema[sel] = (0.5 * state.mag_ema + 0.5 * mag)[sel]
            loss = float(np.mean(losses))
        else:  # system-only simulation: no gradient work this flush
            d_np = np.zeros(layout.G)
            loss = float("nan")

        state.round += 1
        self.trace.flushes += 1
        rec = {"flush": state.round, "sim_time_s": state.sim_time,
               "loss": loss, "staleness_mean": float(staleness.mean()),
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
    rank_gate: Any  # [N]-stacked HeLoRA gates, None without rank caps
    queue: EventQueue
    buffer: list
    trace: AsyncTrace
    history: dict
    aggbuf: AG.CohortAggBuffer
    # client-side error-feedback residuals (uplink_codec="int8"): the
    # quantization error stays on the device and is added to its next
    # update, so the compressed stream telescopes to the uncompressed one
    ef: dict = dataclasses.field(default_factory=dict)
    fx: FaultRuntime | None = None  # fault injection (fed.faults)
    # fleet-static allocation inputs (None for alloc="random", which redraws
    # fleet-shaped noise per dispatch through allocate() to keep its stream)
    plan: AllocPlan | None = None
    windows: ResidentWindows | None = None  # built by the first draw

    @classmethod
    def create(cls, task: MMTask, trainable0: Any, strategy: AsyncStrategy,
               fleet: FleetConfig, fed: AsyncFedConfig) -> AsyncFedRun:
        _check_strategy(strategy, fed, fleet)
        state = _make_state(task.layout.G, trainable0, fed.seed)
        trace = AsyncTrace()
        trace.init_fleet(fleet.N)
        plan = (plan_allocation(strategy, task, fleet, fed, task.layout.flops)
                if strategy.alloc != "random" else None)
        return cls(task, strategy, fleet, fed, state,
                   make_local_update(task, fed, strategy.prox_mu),
                   _rank_gates(trainable0, strategy, fleet), EventQueue(),
                   [], trace, _history_init(),
                   _make_aggbuf(task, trainable0, strategy),
                   fx=_make_fault_runtime(fed, fleet), plan=plan)

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

        live_mm = _live_masks(fed, fleet, clients, now)
        if self.plan is None:  # alloc="random": full-fleet rng draw
            S_full, _ = allocate(self.strategy, state, task, fleet, fed,
                                 layout.flops)
            S = S_full[clients]  # [K, G]
        else:
            S = _allocate_live(self.plan, self.strategy, state, layout,
                               clients, live_mm, fed)
        fault = self.fx.on_dispatch(clients) if self.fx is not None else None

        steps = fed.local_epochs * fed.steps_per_epoch
        self.windows = hold_windows(self.windows, dataset, dev)
        batches = self.windows.draw(state.rng, clients, steps, fed.batch_size)
        start = tree_map(lambda g: g.expand((K,) + g.shape), state.trainable)
        gates = torch.as_tensor(S, dtype=torch.float32, device=dev)
        mmasks = torch.as_tensor(live_mm, dtype=torch.float32, device=dev)
        rank_gate = None
        if self.rank_gate is not None:
            rows = torch.as_tensor(clients, device=dev)
            rank_gate = tree_map(lambda x: x[rows], self.rank_gate)
        deltas, losses = self.local_update(start, batches, mmasks, gates,
                                           fed.lr, rank_gate)
        if fault is not None:  # corrupt pre-quantization, like a real client
            dropped, slow, byz_rows, tickets = fault
            deltas = self.fx.corrupt(deltas, byz_rows, clients, tickets)
        S_up = S
        if self.strategy.selective:  # FedMFS: shrink the upload, not compute
            S_up = _selective_upload(layout, deltas, S,
                                     self.strategy.comm_budget)
            deltas = _gate_rows(layout, deltas, S_up)

        trained_fl, fixed_fl = simulated_flops(task, fed, S)
        upload = ((np.asarray(S_up, np.float64) @ layout.sizes)
                  * self._uplink_bytes_per_param)
        dur, t_comp, t_comm = completion_times(
            fleet, clients, trained_fl, fixed_fl, upload, fed.t_overhead,
            fed.utilization, fed.jitter_sigma, state.rng)
        if fault is not None:  # stalls stretch compute time (and its energy)
            dur = dur + t_comp * (slow - 1.0)
            t_comp = t_comp * slow

        quantize = fed.uplink_codec == "int8"
        losses_np = losses.detach().cpu().numpy()
        for i, c in enumerate(clients):
            d_i = tree_map(lambda x, i=i: x[i], deltas)
            if quantize:  # client-side compression, EF residual stays local
                q_i, s_i, resid = dist.quantize_int8_ef(d_i, self.ef.get(int(c)))
                self.ef[int(c)] = resid
                d_i = (q_i, s_i)
            pend = _Pending(int(c), state.round, d_i, float(losses_np[i]),
                            S_up[i], float(t_comp[i]), float(t_comm[i]),
                            float(upload[i]), live_mm[i],
                            dropped=fault is not None and bool(dropped[i]))
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
                if pend.dropped:  # crash: reboot + redispatch, nothing lands
                    continue
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


# ---------------------------------------------------------------------------
# the vectorized fleet runtime
# ---------------------------------------------------------------------------


class VectorizedAsyncFedRun(_ServerFlushMixin):
    """Structure-of-arrays async runtime for fleet-scale N (sim/fleet.py).

    The protocol of ``AsyncFedRun`` -- FedBuff buffer-K flushes with
    staleness-discounted cohort aggregation -- with all per-client system
    state in flat arrays, events from vectorized next-K extraction instead
    of a heap, and gradient work decoupled from the system simulation by
    ``fed.grad_mode`` (module docstring). With ``grad_mode="dispatch"`` the
    flush history (loss, staleness, selected_frac, sim_time) is event for
    event the heap loop's.
    """

    def __init__(self, task: MMTask, strategy: AsyncStrategy,
                 fleet: FleetConfig, fed: AsyncFedConfig,
                 state: AsyncFedState, local_update: Any, plan: AllocPlan,
                 fstate: FleetState, population: PopulationModel | None,
                 trace: AsyncTrace, history: dict,
                 aggbuf: AG.CohortAggBuffer, proto: Any):
        self.task = task
        self.strategy = strategy
        self.fleet = fleet
        self.fed = fed
        self.state = state
        self.local_update = local_update
        self.plan = plan
        self.fstate = fstate
        self.population = population
        self.trace = trace
        self.history = history
        self.aggbuf = aggbuf
        self.proto = proto
        self.grad_mode = fed.grad_mode
        self.device = leaves(proto)[0].device
        self.ring_clamped = 0  # cohort-mode pulls older than the ring
        # fault injection: drop/stall/corruption flags are drawn at dispatch
        # (counter-based, as in the heap loop) and read at absorb/flush time
        self.fx = _make_fault_runtime(fed, fleet)
        self._drop_next = np.zeros(fleet.N, bool)  # in-flight cycle crashes
        self._fault_ticket = np.zeros(fleet.N, np.int64)  # in-flight ticket
        # buffered (completed, not yet flushed) client state, by column
        self._buf_client: list[np.ndarray] = []
        self._buf_version: list[np.ndarray] = []
        self._buf_bits: list[np.ndarray] = []
        self._buf_mmbits: list[np.ndarray] = []  # modality masks
        self._buf_ticket: list[np.ndarray] = []
        self._buf_fticket: list[np.ndarray] = []  # fault tickets (fx only)
        self._buf_loss: list[np.ndarray] = []
        self._buf_deltas: list[Any] = []
        self._buf_scales: list[Any] = []  # uplink_codec="int8" only
        self._buf_count = 0
        # dispatch-mode in-flight updates ([N, ...] leaves on the device):
        # int8 codes with uplink_codec="int8", their [N] per-leaf scales in
        # ``_pend_scales`` and the fp32 [N, ...] error-feedback rows in
        # ``_ef``
        self._pend_deltas: Any = None
        self._pend_loss: np.ndarray | None = None
        self._pend_scales: Any = None
        self._ef: Any = None
        # cohort-mode ring of the last ``snapshot_ring`` model versions,
        # written in place (each slot a copy of the trainable)
        self._ring: Any = None
        if fed.grad_mode == "cohort":
            R = max(1, fed.snapshot_ring)
            self._ring = tree_map(
                lambda x: x.expand((R,) + x.shape).clone(), proto)
        self._churn_rng = np.random.default_rng([fed.seed, 0x5EED])
        self.windows: ResidentWindows | None = None  # built by the first draw

    @classmethod
    def create(cls, task: MMTask, trainable0: Any, strategy: AsyncStrategy,
               fleet: FleetConfig, fed: AsyncFedConfig
               ) -> VectorizedAsyncFedRun:
        _check_strategy(strategy, fed, fleet)
        if fed.grad_mode not in GRAD_MODES:
            raise ValueError(f"grad_mode must be one of {GRAD_MODES}, "
                             f"got {fed.grad_mode!r}")
        if strategy.selective and fed.grad_mode != "dispatch":
            raise ValueError("selective upload ranks the actual deltas at "
                             "dispatch; grad_mode='cohort'/'none' never "
                             "materializes them")
        if strategy.rank_caps:
            raise ValueError("rank_caps build an [N, ...]-stacked gate tree "
                             "-- unsupported at fleet scale")
        if strategy.alloc == "random":
            raise ValueError("alloc='random' draws fleet-shaped noise per "
                             "dispatch; use the event-loop AsyncFedRun")
        state = _make_state(task.layout.G, trainable0, fed.seed)
        trace = AsyncTrace()
        trace.init_fleet(fleet.N)
        plan = plan_allocation(strategy, task, fleet, fed, task.layout.flops)
        pop = (PopulationModel(fed.churn_rate, fed.arrival_rate)
               if (fed.churn_rate > 0.0 or fed.arrival_rate > 0.0) else None)
        lu = (make_local_update(task, fed, strategy.prox_mu)
              if fed.grad_mode != "none" else None)
        return cls(task, strategy, fleet, fed, state, lu, plan,
                   FleetState.create(fleet.N), pop, trace, _history_init(),
                   _make_aggbuf(task, trainable0, strategy), trainable0)

    # -- client dispatch ------------------------------------------------------

    def _dispatch_vec(self, idx: np.ndarray, now: float, dataset) -> None:
        """Pull the current model to clients ``idx`` and schedule their
        completions: array-resident, O(batch) given the AllocPlan."""
        task, fed, fleet = self.task, self.fed, self.fleet
        layout, state = task.layout, self.state
        idx = np.asarray(idx, np.int64)
        B = len(idx)
        if B == 0:
            return
        live_mm = _live_masks(fed, fleet, idx, now)
        S = _allocate_live(self.plan, self.strategy, state, layout, idx,
                           live_mm, fed)  # [B, G]
        fault = None
        if self.fx is not None:
            fault = self.fx.on_dispatch(idx)
            self._drop_next[idx] = fault[0]
            self._fault_ticket[idx] = fault[3]

        S_up = S  # uploaded set (= trained unless selective shrinks it)
        if self.grad_mode == "dispatch":
            S_up = self._train_at_dispatch(idx, S, live_mm, fault, dataset)

        trained_fl, fixed_fl = simulated_flops(task, fed, S)
        upload = ((np.asarray(S_up, np.float64) @ layout.sizes)
                  * self._uplink_bytes_per_param)
        dur, t_comp, t_comm = T.cycle_times(
            fleet, idx, trained_fl, fixed_fl, upload, fed.t_overhead,
            fed.utilization, fed.jitter_sigma, state.rng)
        if fault is not None:  # stalls stretch compute time (and energy)
            slow = fault[1]
            dur = dur + t_comp * (slow - 1.0)
            t_comp = t_comp * slow
        self.fstate.dispatch(idx, now, state.round, pack_group_bits(S_up),
                             dur, t_comp, t_comm, upload)
        self.fstate.mod_bits[idx] = pack_group_bits(live_mm)

    def _train_at_dispatch(self, idx: np.ndarray, S: np.ndarray,
                           live_mm: np.ndarray, fault, dataset) -> np.ndarray:
        """grad_mode "dispatch": local training for the dispatched clients
        now, stored (int8-compressed with the int8 uplink) in the [N, ...]
        pending rows until their completion is flushed -> the uploaded
        groups ``S_up`` [B, G] (``S`` unless the strategy is selective)."""
        fed, state, dev = self.fed, self.state, self.device
        B = len(idx)
        steps = fed.local_epochs * fed.steps_per_epoch
        self.windows = hold_windows(self.windows, dataset, dev)
        batches = self.windows.draw(state.rng, idx, steps, fed.batch_size)
        start = tree_map(lambda g: g.expand((B,) + g.shape), state.trainable)
        f32 = dict(dtype=torch.float32, device=dev)
        deltas, losses = self.local_update(
            start, batches, torch.as_tensor(live_mm, **f32),
            torch.as_tensor(S, **f32), fed.lr)
        if fault is not None:  # corrupt pre-quantization (heap parity)
            deltas = self.fx.corrupt(deltas, fault[2], idx, fault[3])
        S_up = S
        if self.strategy.selective:  # FedMFS: shrink the upload, not compute
            S_up = _selective_upload(self.task.layout, deltas, S,
                                     self.strategy.comm_budget)
            deltas = _gate_rows(self.task.layout, deltas, S_up)
        quantize = fed.uplink_codec == "int8"
        N = self.fleet.N
        if self._pend_deltas is None:
            dtype = torch.int8 if quantize else torch.float32
            self._pend_deltas = tree_map(
                lambda x: torch.zeros((N,) + x.shape, dtype=dtype,
                                      device=dev), self.proto)
            self._pend_loss = np.full(N, np.nan)
            if quantize:
                self._pend_scales = tree_map(
                    lambda x: torch.zeros(N, **f32), self.proto)
                self._ef = tree_map(
                    lambda x: torch.zeros((N,) + x.shape, **f32), self.proto)
        rows = torch.as_tensor(idx, device=dev)

        def put(buf, v):
            buf[rows] = v
            return buf

        if quantize:  # compress client-side, EF residual stays per row
            q, sc, resid = dist.quantize_int8_stacked(
                deltas, tree_map(lambda r: r[rows], self._ef))
            self._pend_deltas = tree_map(put, self._pend_deltas, q)
            self._pend_scales = tree_map(put, self._pend_scales, sc)
            self._ef = tree_map(put, self._ef, resid)
        else:
            self._pend_deltas = tree_map(put, self._pend_deltas, deltas)
        self._pend_loss[idx] = losses.detach().cpu().numpy()
        return S_up

    # -- completion absorption / flush ----------------------------------------

    def _buf_append(self, chunk: np.ndarray) -> None:
        fs = self.fstate
        self._buf_client.append(chunk.copy())
        self._buf_version.append(fs.version[chunk].copy())
        self._buf_bits.append(fs.group_bits[chunk].copy())
        self._buf_mmbits.append(fs.mod_bits[chunk].copy())
        self._buf_ticket.append(fs.updates[chunk].copy())
        if self.fx is not None:  # the cycle's fault ticket, before redispatch
            self._buf_fticket.append(self._fault_ticket[chunk].copy())
        if self.grad_mode == "dispatch":
            self._buf_loss.append(self._pend_loss[chunk].copy())
            rows = torch.as_tensor(chunk, device=self.device)
            # index-gathers: fresh tensors, never views of the store
            self._buf_deltas.append(
                tree_map(lambda x: x[rows], self._pend_deltas))
            if self._pend_scales is not None:
                self._buf_scales.append(
                    tree_map(lambda x: x[rows], self._pend_scales))
        self._buf_count += len(chunk)

    def _cohort_update(self, dataset, ids: np.ndarray, versions: np.ndarray,
                       tickets: np.ndarray, S: np.ndarray,
                       mmask_rows: np.ndarray) -> tuple[Any, np.ndarray]:
        """Cohort-sampled gradients: local updates for the K flushed clients
        only, each from the ring snapshot of the version it pulled (pulls
        older than the ring clamp to the oldest retained snapshot;
        ``ring_clamped`` counts those). ``start`` is an index-gather of the
        ring, a copy: the ring's next in-place write cannot reach it."""
        fed, state, dev = self.fed, self.state, self.device
        R = max(1, fed.snapshot_ring)
        vmin = max(0, state.round - R + 1)
        v_eff = np.maximum(versions, vmin)
        self.ring_clamped += int(np.sum(v_eff != versions))
        slots = torch.as_tensor(v_eff % R, device=dev)
        start = tree_map(lambda x: x[slots], self._ring)

        steps = fed.local_epochs * fed.steps_per_epoch
        self.windows = win = hold_windows(self.windows, dataset, dev)
        batches = win.gather(np.stack([  # counter-based draws: order-free
            win.rows(np.random.default_rng([fed.seed, int(c), int(t)]),
                     int(c), steps, fed.batch_size)
            for c, t in zip(ids, tickets)]))
        f32 = dict(dtype=torch.float32, device=dev)
        deltas, losses = self.local_update(
            start, batches, torch.as_tensor(mmask_rows, **f32),
            torch.as_tensor(S, **f32), fed.lr)
        return deltas, losses.detach().cpu().numpy()

    def _flush_vec(self, dataset) -> dict:
        client = np.concatenate(self._buf_client)
        order = np.argsort(client, kind="stable")  # client-id order (parity)
        ids = client[order]
        versions = np.concatenate(self._buf_version)[order]
        tickets = np.concatenate(self._buf_ticket)[order]
        S = unpack_group_bits(np.concatenate(self._buf_bits)[order],
                              self.task.layout.G)
        mmask_rows = unpack_group_bits(
            np.concatenate(self._buf_mmbits)[order], self.fleet.M)
        staleness = (self.state.round - versions).astype(np.float64)
        quantize = self.fed.uplink_codec == "int8"
        if self.grad_mode == "dispatch":
            losses = np.concatenate(self._buf_loss)[order]
            rows = torch.as_tensor(order, device=self.device)
            cat = lambda *xs: torch.cat(xs, 0)[rows]  # noqa: E731
            deltas = tree_map(cat, *self._buf_deltas)
            if quantize:  # buffered rows are already the int8 uplink
                deltas = AG.QuantizedStack(deltas,
                                           tree_map(cat, *self._buf_scales))
        elif self.grad_mode == "cohort":
            deltas, losses = self._cohort_update(dataset, ids, versions,
                                                 tickets, S, mmask_rows)
            if self.fx is not None:  # corrupt with the *buffered* cycle's
                # fault ticket: the client may already be redispatched
                ftickets = np.concatenate(self._buf_fticket)[order]
                deltas = self.fx.corrupt(deltas, self.fx.byz[ids], ids,
                                         ftickets)
            if quantize:  # cohort-sampled gradients quantize at the edge
                # of the simulated uplink (no EF: each (client, ticket)
                # update is drawn exactly once, at flush time)
                qt, sc, _ = dist.quantize_int8_stacked(deltas)
                deltas = AG.QuantizedStack(qt, sc)
        else:
            deltas, losses = None, None
        for buf in (self._buf_client, self._buf_version, self._buf_bits,
                    self._buf_mmbits, self._buf_ticket, self._buf_fticket,
                    self._buf_loss, self._buf_deltas, self._buf_scales):
            buf.clear()
        self._buf_count = 0

        rec = self._flush_arrays(deltas, S, ids, losses, staleness,
                                 mmask_rows=mmask_rows)
        if self.grad_mode == "cohort":  # retain the new version's snapshot
            slot = self.state.round % max(1, self.fed.snapshot_ring)
            for ring, t in zip(leaves(self._ring),
                               leaves(self.state.trainable)):
                ring[slot] = t
        return rec

    def _absorb(self, gidx: np.ndarray, dataset, K: int,
                log_every: int) -> None:
        """Absorb one timestamp group of completions: energy accounting,
        buffer append, a flush at every K-th entry; chunked so the trace at
        each flush matches the one-event-at-a-time loop."""
        fleet, fs = self.fleet, self.fstate
        pos = 0
        while pos < len(gidx):
            room = K - self._buf_count
            chunk = gidx[pos:pos + room]
            pos += len(chunk)
            fs.complete(fleet, chunk)
            self.trace.record_completions(fleet, chunk, fs.t_comp[chunk],
                                          fs.t_comm[chunk],
                                          fs.upload_bytes[chunk])
            self._buf_append(chunk)
            if self._buf_count >= K:
                rec = self._flush_vec(dataset)
                self._log_and_eval(rec, dataset if self.grad_mode != "none"
                                   else None, log_every,
                                   f"vec:{self.strategy.name}")

    # -- the vectorized event loop --------------------------------------------

    def run(self, dataset=None, total_updates: int | None = None,
            log_every: int = 0) -> dict:
        """Absorb ``total_updates`` completions (default rounds * N), with
        vectorized next-K event extraction over the completion-time array.
        ``dataset`` may be None with ``grad_mode="none"``."""
        fed, fleet, state = self.fed, self.fleet, self.state
        if self.grad_mode != "none" and dataset is None:
            raise ValueError(f"grad_mode={self.grad_mode!r} needs a dataset")
        total = (total_updates or fed.total_updates
                 or fed.rounds * fleet.N)
        K = max(1, min(self.strategy.buffer_size, fleet.N))
        fs = self.fstate
        if fs.in_flight == 0:
            self._dispatch_vec(np.nonzero(fs.alive)[0], state.sim_time,
                               dataset)
        processed = 0
        last_t = state.sim_time
        while processed < total and fs.in_flight > 0:
            times, cand = fs.peek_window(K, fed.t_overhead)
            remaining = total - processed
            if self.fx is not None:
                # dropped completions never count toward ``total``: cut the
                # window after the ``remaining``-th absorbable event, where
                # the heap loop breaks mid-group (a plain prefix cut would
                # split the redispatch batch and desync the jitter stream)
                kept_c = np.cumsum(~self._drop_next[cand])
                if len(cand) and kept_c[-1] > remaining:
                    cut = int(np.searchsorted(kept_c, remaining)) + 1
                    times, cand = times[:cut], cand[:cut]
            elif len(cand) > remaining:
                times, cand = times[:remaining], cand[:remaining]
            fs.claim(cand)
            arrivals: list[np.ndarray] = []
            gstart = 0
            while gstart < len(cand):
                t0 = float(times[gstart])
                gend = gstart + int(np.searchsorted(
                    times[gstart:], t0, side="right"))
                gidx = cand[gstart:gend]
                gstart = gend
                state.sim_time = t0
                if self.population is not None:
                    _, arrived = self.population.step(self._churn_rng, fs,
                                                      t0 - last_t)
                    if len(arrived):
                        arrivals.append(arrived)
                    # departures lose their update, even if they re-arrive
                    # before their claimed event's group is processed
                    gidx = gidx[fs.alive[gidx] & ~fs.lost[gidx]]
                last_t = t0
                if len(gidx) == 0:
                    continue
                kept = (gidx[~self._drop_next[gidx]]
                        if self.fx is not None else gidx)
                self._absorb(kept, dataset, K, log_every)
                processed += len(kept)
                if processed >= total:
                    break
                # redispatch everything claimed: a dropped client reboots
                # at the time its completion would have fired
                self._dispatch_vec(gidx, t0, dataset)
            if arrivals and processed < total:
                # re-arrivals from population.step() only (claimed events
                # of this window all have t_next = inf, so an idle scan
                # would dispatch twice); after the window, since dispatch
                # clears ``lost``
                arr = np.unique(np.concatenate(arrivals))
                self._dispatch_vec(arr[fs.alive[arr]], state.sim_time,
                                   dataset)
        self.trace.sim_time = state.sim_time
        self.trace.per_client_updates = fs.updates.copy()
        if (self.grad_mode != "none" and dataset is not None
                and not self.history["f1"]):
            self.history["f1"].append(self.evaluate(dataset))
            self.history["f1_flush"].append(self.state.round)
        return self.history
