"""The RELIEF round engine (paper Algorithm 1) and its baselines.

One round of ``FedRun`` = (1) server allocation: EMA divergence -> Eq. 7
budgets -> top-k group selection; (2) parallel local training: clients run
E epochs with gradients gated to their assigned groups; (3) server
aggregation: cohort-wise masked means (Eq. 3-4) + divergence update (Eq.
5-6). Client participation is a per-round mask, so any dropout pattern
aggregates well (an empty cohort freezes its block). The asynchronous
runtime (``async_engine.py``) reuses the local update, the batch draws and
the allocation. The training windows stay on the run's device for the run
(``ResidentWindows``): a draw copies its row indices there and gathers.

Local training is ``torch.func.vmap(torch.func.grad_and_value(loss))`` over
the client axis, with a Python loop over the E x steps Adam steps; the
trainable tree carries N stacked copies. Every numpy rng call of the
reference's round is made in the same order (participation, dropout,
allocation, batch draws), so a round here and a round there draw the same
clients, gates and batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import aggregation as AG
from repro_torch.core import allocation as AL
from repro_torch.core import divergence as DV
from repro_torch.core import mdlora
from repro_torch.core.strategies import Strategy
from repro_torch.core.tasks import MMTask
from repro_torch.optim import adam_init, adam_update
from repro_torch.sim import FleetConfig
from repro_torch.sim import timing as T
from repro_torch.tree import leaves, map_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class FedConfig:
    rounds: int = 50
    local_epochs: int = 5  # E (paper VI-A3)
    steps_per_epoch: int = 4
    batch_size: int = 32
    lr: float = 1e-3
    gamma: float = 0.9  # EMA coefficient (Eq. 6)
    server_lr: float = 1.0
    participation: float = 1.0
    t_overhead: float = 0.05
    utilization: float = 0.3
    eval_every: int = 5
    seed: int = 0
    dropout_prob: float = 0.0  # random client failures (fault injection)
    # timing model: "flop_proportional" = the paper's Sec. VI-A3 simulator
    # (compute ~ trained-group FLOPs only); "fwd_aware" = the Sec. VII model
    # charging the fixed full-model forward to everyone.
    sim_mode: str = "flop_proportional"

    @classmethod
    def from_scenario(cls, spec, **overrides):
        """Training knobs from a ``sim.scenarios.ScenarioSpec`` (duck-typed:
        anything with the same field names works)."""
        return cls(**(scenario_fed_kwargs(spec) | overrides))


def scenario_fed_kwargs(spec) -> dict:
    """The FedConfig fields a ScenarioSpec carries, as constructor kwargs."""
    return dict(rounds=spec.rounds, local_epochs=spec.local_epochs,
                steps_per_epoch=spec.steps_per_epoch,
                batch_size=spec.batch_size, lr=spec.lr,
                eval_every=spec.eval_every, t_overhead=spec.t_overhead,
                utilization=spec.utilization, seed=spec.seed)


# ---------------------------------------------------------------------------
# local update (shared by every strategy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FedState:
    round: int
    trainable: Any  # global trainable tree
    client_trainable: Any  # [N, ...] stacked (personalized leaves live here)
    dbar: np.ndarray  # [G] EMA divergence
    mag_ema: np.ndarray  # [G] update-magnitude EMA (FedEL-like alloc)
    rng: np.random.Generator


def make_local_update(task: MMTask, fed: FedConfig, prox_mu: float):
    """-> local_update(start, batches, mmasks, gates, lr, rank_gate=None)
    -> (deltas [K, ...] tree, mean losses [K]).

    start: [K, ...] stacked trainable; batches: {"x": [K, steps, B, T, C],
    "y": [K, steps, B]}; mmasks: [K, M]; gates: [K, G]; rank_gate: a
    trainable-shaped tree of [K, ...] multiplicative masks (HeLoRA rank
    caps), None for all ones. Gradients and the returned delta are gated to
    each client's selected groups (and ranks), as in the reference."""
    layout = task.layout

    def loss_one(tr, x, y, mmask):
        return task.loss(tr, {"x": x, "y": y, "modality_mask": mmask})

    grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_one))

    def local_update(start, batches, mmasks, gates, lr, rank_gate=None):
        tr, opt = start, adam_init(start)
        losses = []
        for s in range(batches["x"].shape[1]):
            with trace.span("fed.local_step", step=s):
                with trace.span("local.grad") as sp:
                    grads, loss = grad_fn(tr, batches["x"][:, s],
                                          batches["y"][:, s], mmasks)
                    if sp is not trace.OFF:  # the (client, group) work done
                        sp.attrs["computed"] = float(
                            layout.rows_per_group(grads) @ layout.flops)
                with trace.span("local.adam"):
                    if prox_mu > 0.0:
                        grads = tree_map(
                            lambda g, t, t0: g + prox_mu * (t - t0), grads,
                            tr, start)
                    grads = mdlora.group_gate_tree(layout, grads, gates)
                    if rank_gate is not None:
                        grads = tree_map(torch.mul, grads, rank_gate)
                    tr, opt = adam_update(tr, grads, opt, lr)
            losses.append(loss)
        delta = tree_map(lambda a, b: a.float() - b.float(), tr, start)
        delta = mdlora.group_gate_tree(layout, delta, gates)
        if rank_gate is not None:
            delta = tree_map(torch.mul, delta, rank_gate)
        return delta, torch.stack(losses, 1).mean(1)

    return local_update


# ---------------------------------------------------------------------------
# data plumbing (the reference's rng call sequence, so batches match bit for
# bit)
# ---------------------------------------------------------------------------


class ResidentWindows:
    """Every subject's training windows on the run's device, for the run:
    ``x`` [sum n, T, C] in the windows' dtype and ``y`` [sum n] int64, the
    subjects end to end, with ``offsets`` and ``counts`` [subjects] on the
    host. A draw copies only its row indices to the device and gathers the
    batches there. Built from anything with ``train_x`` / ``train_y`` lists;
    it holds that dataset, so a run rebuilds it only for another one
    (``hold_windows``)."""

    def __init__(self, dataset, device: torch.device | str):
        self.dataset = dataset
        self.counts = np.array([len(y) for y in dataset.train_y], np.int64)
        self.offsets = np.cumsum(self.counts) - self.counts
        self.x = torch.as_tensor(np.concatenate(dataset.train_x),
                                 device=device)
        self.y = torch.as_tensor(np.concatenate(dataset.train_y),
                                 dtype=torch.int64, device=device)

    @property
    def nbytes(self) -> int:
        return self.x.nbytes + self.y.nbytes

    def rows(self, rng: np.random.Generator, client: int, steps: int,
             batch_size: int) -> np.ndarray:
        """[steps, batch_size] rows of ``x`` for ``client``: one
        ``rng.integers`` call over the windows of its subject, ``client %
        subjects``."""
        src = client % len(self.counts)
        return self.offsets[src] + rng.integers(
            0, self.counts[src], size=(steps, batch_size))

    def draw(self, rng: np.random.Generator, clients, steps: int,
             batch_size: int) -> dict:
        """Stacked local-training batches for ``clients`` (one rng.integers
        call per client, in iteration order)."""
        return self.gather(np.stack([self.rows(rng, n, steps, batch_size)
                                     for n in clients]))

    def gather(self, rows: np.ndarray) -> dict:
        """{"x": [*rows.shape, T, C], "y": [*rows.shape] int64}, on the
        device: one copy of ``rows``, then a gather of each."""
        idx = torch.as_tensor(rows, device=self.x.device)
        return {"x": self.x[idx], "y": self.y[idx]}


def hold_windows(held: ResidentWindows | None, dataset,
                 device: torch.device | str) -> ResidentWindows:
    """``held`` if it was built from ``dataset``, else a new copy of
    ``dataset``'s windows on ``device``."""
    if held is not None and held.dataset is dataset:
        return held
    return ResidentWindows(dataset, device)


# ---------------------------------------------------------------------------
# allocation dispatch
# ---------------------------------------------------------------------------


def _depth_order(layout: mdlora.GroupLayout) -> np.ndarray:
    """Shallow-to-deep group ordering for depth-based baselines."""
    def rank(i):
        n, k = layout.names[i], layout.kinds[i]
        if k == mdlora.KIND_ENCODER:
            lay = int(n.split("_L")[-1]) if "_L" in n else 0
            return (0, lay)
        if k == mdlora.KIND_FUSION_BLOCK:
            return (1, 0)
        if k == mdlora.KIND_FUSION_B:
            return (1, 1)
        return (2, 0)
    return np.array(sorted(range(layout.G), key=rank), np.int32)


@dataclasses.dataclass(frozen=True)
class AllocPlan:
    """Fleet-static inputs of allocation, precomputed once per run:
    candidate and mandatory masks and the elastic budgets (Eq. 7 -- t_star
    is a fleet-wide binary search, so it is solved over the FULL fleet even
    when only a dispatch batch is allocated)."""
    cand: np.ndarray  # [N, G] candidate groups
    mandatory: np.ndarray  # [N, G] forced inclusions
    k: np.ndarray  # [N] group budgets
    depth_order: np.ndarray | None = None  # [G] (depth baselines only)


def plan_allocation(strategy: Strategy, task: MMTask, fleet: FleetConfig,
                    fed: FedConfig, group_flops: np.ndarray) -> AllocPlan:
    layout = task.layout
    N, G = fleet.N, layout.G
    accessible = layout.accessible(fleet.modality_mask)
    if strategy.alloc in ("full", "magnitude", "depth"):
        # modality-unaware: every (non-empty) group is a training candidate
        cand = np.tile(layout.sizes[None, :] > 0, (N, 1))
    else:
        cand = accessible
    mandatory = (layout.mandatory(fleet.modality_mask) if strategy.mandatory
                 else np.zeros((N, G), bool))
    n_mand = mandatory.sum(1)
    g_max = cand.sum(1)

    if strategy.budgets == "elastic":
        examples = fed.local_epochs * fed.steps_per_epoch * fed.batch_size
        tau = T.profile_tau(fleet, group_flops, examples, fed.utilization)
        t_star = AL.solve_t_star(tau, fed.t_overhead, n_mand, g_max)
        k = AL.elastic_budgets(tau, t_star, fed.t_overhead, n_mand, g_max)
    else:
        k = g_max.copy()
    order = _depth_order(layout) if strategy.alloc == "depth" else None
    return AllocPlan(cand, mandatory, k, order)


def allocate_rows(plan: AllocPlan, strategy: Strategy, state: Any,
                  idx: np.ndarray, cand: np.ndarray | None = None,
                  mandatory: np.ndarray | None = None) -> np.ndarray:
    """S rows [len(idx), G] for the client subset ``idx``; row-identical to
    ``allocate(...)[0][idx]`` for every deterministic allocator.
    ``cand``/``mandatory`` ([len(idx), G]) override the plan's fleet-static
    masks: under a streaming modality schedule the candidates follow the
    masks live at dispatch, while the Eq. 7 budgets ``k`` stay solved over
    the base fleet."""
    idx = np.asarray(idx)
    cand = plan.cand[idx] if cand is None else np.asarray(cand, bool)
    mandatory = (plan.mandatory[idx] if mandatory is None
                 else np.asarray(mandatory, bool))
    k = plan.k[idx]
    if strategy.alloc in ("full", "accessible"):
        return cand
    if strategy.alloc == "divergence":
        score = state.dbar
    elif strategy.alloc == "magnitude":
        score = state.mag_ema
    elif strategy.alloc == "random":
        return AL.allocate_topk(state.dbar, cand, mandatory, k,
                                rng=state.rng, randomize=True)
    elif strategy.alloc == "depth":
        G = cand.shape[1]
        order = plan.depth_order
        S = np.zeros_like(cand)
        offset = (state.round % max(G, 1)) if strategy.depth_rotate else 0
        for n in range(len(idx)):
            take = [order[(offset + i) % G] for i in range(G)
                    if cand[n, order[(offset + i) % G]]][: int(k[n])]
            S[n, take] = True
        return S
    else:
        raise ValueError(strategy.alloc)
    return AL.allocate_topk(score, cand, mandatory, k)


def allocate(strategy: Strategy, state: Any, task: MMTask,
             fleet: FleetConfig, fed: FedConfig,
             group_flops: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """-> (S [N, G] bool selection, k [N] budgets)."""
    plan = plan_allocation(strategy, task, fleet, fed, group_flops)
    return allocate_rows(plan, strategy, state, np.arange(fleet.N)), plan.k


def simulated_flops(task: MMTask, fed: FedConfig,
                    S: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(trained, fixed) FLOPs of each client's local work, for the timing
    model. ``flop_proportional``: the paper's Sec. VI-A3 simulator (the
    profiled mean per-group cost, compute proportional to the trained groups
    only); ``fwd_aware``: Sec. VII (per-group FLOPs for the maskable
    backward, the full-model forward a fixed cost)."""
    examples = fed.local_epochs * fed.steps_per_epoch * fed.batch_size
    S = np.asarray(S, np.float64)
    if fed.sim_mode == "flop_proportional":
        trained = S.sum(1) * float(np.mean(task.layout.flops)) * examples * 3.0
        return trained, np.zeros(len(S))
    return ((S @ task.layout.flops) * examples * 2.0,
            np.full(len(S), task.forward_flops_per_example() * examples))


# ---------------------------------------------------------------------------
# personalization helpers
# ---------------------------------------------------------------------------


def _personal_leaf_mask(proto: Any, strategy: Strategy) -> Any:
    """Tree of bool: True where the leaf stays local (never aggregated)."""
    def is_personal(p: str, _leaf) -> bool:
        if strategy.share_only:
            return not any(s in p for s in strategy.share_only)
        return any(s in p for s in strategy.personal)
    return map_with_path(is_personal, proto)


def _clusters(fleet: FleetConfig) -> np.ndarray:
    """[N] cluster id by identical modality sets (FedLEASE-like)."""
    keys = [tuple(row) for row in fleet.modality_mask.astype(int)]
    uniq = {k: i for i, k in enumerate(dict.fromkeys(keys))}
    return np.array([uniq[k] for k in keys], np.int32)


def _rank_gates(proto: Any, strategy: Strategy, fleet: FleetConfig) -> Any:
    """HeLoRA: [N]-stacked multiplicative masks zeroing the LoRA rank tails
    of slower devices (rank fractions ``rank_caps`` by compute tier). None
    without ``rank_caps``: every gate would be one, and the local update
    leaves the multiplication out."""
    if not strategy.rank_caps:
        return None
    N = fleet.N
    q = np.quantile(fleet.tops, [0.34, 0.67])
    tier = np.digitize(-fleet.tops, [-q[1], -q[0]])  # 0=fast..2=slow
    caps = np.array(strategy.rank_caps)[
        np.clip(tier, 0, len(strategy.rank_caps) - 1)]

    def mk(p, leaf):
        base = torch.ones((N,) + tuple(leaf.shape), device=leaf.device)
        if "lora" in p and leaf.dim() >= 2 and (p.endswith("['a']")
                                                or p.endswith("['b']")):
            r_axis = leaf.dim() - 1 if p.endswith("['a']") else leaf.dim() - 2
            r = leaf.shape[r_axis]
            for n in range(N):
                sl = [slice(None)] * (leaf.dim() + 1)
                sl[0] = n
                sl[r_axis + 1] = slice(max(1, int(caps[n] * r)), None)
                base[tuple(sl)] = 0.0
        return base

    return map_with_path(mk, proto)


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FedRun:
    task: MMTask
    strategy: Strategy
    fleet: FleetConfig
    fed: FedConfig
    state: FedState
    local_update: Any
    rank_gate: Any  # None without rank caps
    personal_mask: Any
    history: dict
    proto: Any  # trainable prototype (zero-round shapes/dtypes)
    windows: ResidentWindows | None = None  # built by the first draw

    @classmethod
    def create(cls, task: MMTask, trainable0: Any, strategy: Strategy,
               fleet: FleetConfig, fed: FedConfig) -> FedRun:
        """The round runs where ``trainable0`` lives: the CUDA kernels on
        the card, their plain versions on the CPU."""
        state = FedState(
            round=0, trainable=trainable0,
            client_trainable=tree_map(
                lambda x: x.expand((fleet.N,) + x.shape), trainable0),
            dbar=np.ones(task.layout.G) * 1e-6, mag_ema=np.ones(task.layout.G),
            rng=np.random.default_rng(fed.seed))
        history = {"round": [], "loss": [], "round_time_s": [],
                   "energy_j": [], "upload_mb": [], "f1": [], "f1_round": [],
                   "divergence": [], "selected_frac": []}
        return cls(task, strategy, fleet, fed, state,
                   make_local_update(task, fed, strategy.prox_mu),
                   _rank_gates(trainable0, strategy, fleet),
                   _personal_leaf_mask(trainable0, strategy), history,
                   trainable0)

    @property
    def device(self) -> torch.device:
        return leaves(self.state.trainable)[0].device

    @property
    def _has_personal(self) -> bool:
        return any(leaves(self.personal_mask))

    # -- data plumbing --------------------------------------------------------

    def _round_batches(self, dataset) -> dict:
        """Every client's local-training batches for one round, drawn from
        the run's rng (the round draws through this, as does an instrumented
        caller such as ``experiments.motivation``)."""
        fed = self.fed
        self.windows = hold_windows(self.windows, dataset, self.device)
        return self.windows.draw(self.state.rng, range(self.fleet.N),
                                 fed.local_epochs * fed.steps_per_epoch,
                                 fed.batch_size)

    # -- one round ------------------------------------------------------------

    def round(self, dataset) -> dict:
        with trace.span("fed.round", round=self.state.round + 1):
            return self._round(dataset)

    def _round(self, dataset) -> dict:
        task, strategy, fleet, fed = (self.task, self.strategy, self.fleet,
                                      self.fed)
        layout, state, dev = task.layout, self.state, self.device
        N, G = fleet.N, layout.G
        f32 = dict(dtype=torch.float32, device=dev)

        # --- participation / fault injection
        participating = np.ones(N, bool)
        if fed.participation < 1.0:
            m = max(1, int(fed.participation * N))
            participating[:] = False
            participating[state.rng.choice(N, m, replace=False)] = True
        if fed.dropout_prob > 0:
            participating &= state.rng.random(N) > fed.dropout_prob
            if not participating.any():
                participating[state.rng.integers(N)] = True

        with trace.span("fed.allocate"):
            S, _ = allocate(strategy, state, task, fleet, fed, layout.flops)
            S &= participating[:, None]

        # --- clients: local training
        with trace.span("fed.draw") as sp:
            held = self.windows
            batches = self._round_batches(dataset)
            if sp is not trace.OFF:  # the row indices (int64, one a label)
                # and, on a build, the windows
                built = self.windows is not held
                sp.attrs["built"] = int(built)
                sp.attrs["h2d_bytes"] = batches["y"].nbytes + (
                    self.windows.nbytes if built else 0)
        start = self._start_trainable()
        trained = torch.as_tensor(S, **f32)
        mmasks = torch.as_tensor(fleet.modality_mask, **f32)
        # ``selected``: the gradient work per step that the allocation asks
        # for, against each ``local.grad``'s ``computed``
        with trace.span("fed.local_update") as sp:
            if sp is not trace.OFF:
                sp.attrs["selected"] = float((S @ layout.flops).sum())
            deltas, losses = self.local_update(start, batches, mmasks,
                                               trained, fed.lr,
                                               self.rank_gate)

        with trace.span("fed.aggregate"):
            if strategy.agg == "cohort":
                W = AG.cohort_weights(layout, trained, mmasks)
            elif strategy.agg in ("dimension", "helora"):
                # cohort-style masked means without Eq. 4's B-weighting
                W = AG.cohort_weights(layout, trained, torch.ones_like(mmasks))
            else:  # fedavg: every participant averaged into every group
                W = AG.fedavg_weights(N, G,
                                      torch.as_tensor(participating, **f32))
            if strategy.agg == "helora":
                new_trainable = self._helora_aggregate(deltas, W)
            else:
                new_trainable = AG.aggregate(layout, state.trainable, deltas,
                                             W, fed.server_lr)
            # personalized leaves are NEVER aggregated into the global model
            new_trainable = tree_map(
                lambda old, new, pers: old if pers else new, state.trainable,
                new_trainable, self.personal_mask)
            self._update_personal(start, deltas, participating)

        # --- divergence tracking (Eq. 5-6) on possession cohorts
        with trace.span("fed.divergence"):
            cohort = torch.as_tensor(layout.accessible(fleet.modality_mask)
                                     & participating[:, None] & S, **f32)
            d = DV.group_divergence(layout, deltas, cohort)
            with trace.wait("divergence.to_host"):
                d = d.cpu().numpy()
            # fp32, as the reference's jnp update makes it
            state.dbar = DV.ema_update(state.dbar.astype(np.float32), d,
                                       fed.gamma)
            norms = mdlora.group_norms(layout, deltas, batch_dims=1)
            with trace.wait("norms.to_host"):
                per_client_norms = norms.cpu().numpy()
            mag = (per_client_norms * S).sum(0) / np.maximum(S.sum(0), 1)
            touched = S.any(0)
            state.mag_ema[touched] = (0.5 * state.mag_ema + 0.5 * mag)[touched]

        # --- system simulation (time / energy / comm)
        with trace.span("fed.simulate"):
            trained_fl, fixed_fl = simulated_flops(task, fed, S)
            upload = (np.asarray(S, np.float64) @ layout.sizes) * 4.0
            cost = T.simulate_round(fleet, participating, trained_fl,
                                    fixed_fl, upload, fed.t_overhead,
                                    fed.utilization)

        state.trainable = new_trainable
        state.round += 1
        with trace.wait("loss.to_host"):
            loss = float(losses.mean())
        rec = {"round": state.round, "loss": loss,
               **cost.as_dict(), "selected_frac": float(S.mean()),
               "divergence": d}
        for key in ("round", "loss", "round_time_s", "upload_mb",
                    "divergence", "selected_frac"):
            self.history[key].append(rec[key])
        self.history["energy_j"].append(rec["fleet_energy_j"])
        return rec

    # -- helpers ---------------------------------------------------------------

    def _start_trainable(self) -> Any:
        """Per-client starting point: personalized leaves from client state,
        shared leaves broadcast from the global model."""
        N = self.fleet.N
        return tree_map(lambda g, c, pers: c if pers
                        else g.expand((N,) + g.shape),
                        self.state.trainable, self.state.client_trainable,
                        self.personal_mask)

    def _update_personal(self, start, deltas, participating) -> None:
        if not self._has_personal:
            return
        dev = self.device
        part = torch.as_tensor(participating, dtype=torch.float32, device=dev)
        cluster = _clusters(self.fleet)
        onehot = torch.as_tensor(
            cluster[:, None] == np.unique(cluster)[None, :],
            dtype=torch.float32, device=dev) * part[:, None]
        mix = onehot @ (onehot / onehot.sum(0, keepdim=True).clamp(min=1.0)
                        ).T  # [N, N] cluster-mean mix

        def upd(c_old, s, d, pers):
            if not pers:
                return c_old
            new = s.float() + d
            if self.strategy.cluster_mix:
                new = torch.einsum("nk,k...->n...", mix, new)
            else:  # keep own value; non-participants keep the previous one
                keep = part.reshape((-1,) + (1,) * (new.dim() - 1)) > 0
                new = torch.where(keep, new, c_old.float())
            return new.to(c_old.dtype)

        self.state.client_trainable = tree_map(
            upd, self.state.client_trainable, start, deltas,
            self.personal_mask)

    def _helora_aggregate(self, deltas, W) -> Any:
        """Elementwise rank-masked mean for LoRA leaves; the group mean
        (``W``: cohort weights without B-weighting) for the others."""
        base = mdlora.weighted_combine(self.task.layout, deltas, W)
        gates = (self.rank_gate if self.rank_gate is not None
                 else tree_map(torch.ones_like, deltas))

        def fix(p, agg, d_stack, m_stack):
            if "lora" not in p:
                return agg
            num = (d_stack.float() * m_stack).sum(0)
            return num / m_stack.sum(0).clamp(min=1e-9)

        agg = map_with_path(fix, base, deltas, gates)
        return tree_map(lambda t, d: (t.float() + self.fed.server_lr * d
                                      ).to(t.dtype),
                        self.state.trainable, agg)

    # -- evaluation -------------------------------------------------------------

    def evaluate(self, dataset) -> float:
        if self._has_personal:
            # personalized strategies: per-client models on local test data
            f1s = []
            start = self._start_trainable()
            for n in range(self.fleet.N):
                tr_n = tree_map(lambda x, n=n: x[n], start)
                src = n % len(dataset.test_y)
                f1s.append(self.task.eval_f1(tr_n, dataset.test_x[src],
                                             dataset.test_y[src]))
            return float(np.mean(f1s))
        return self.task.eval_f1(self.state.trainable,
                                 np.concatenate(dataset.test_x),
                                 np.concatenate(dataset.test_y))

    # -- full loop ---------------------------------------------------------------

    def run(self, dataset, rounds: int | None = None,
            log_every: int = 0) -> dict:
        rounds = rounds or self.fed.rounds
        for r in range(rounds):
            rec = self.round(dataset)
            if (r + 1) % self.fed.eval_every == 0 or r == rounds - 1:
                f1 = self.evaluate(dataset)
                self.history["f1"].append(f1)
                self.history["f1_round"].append(rec["round"])
                if log_every and (r + 1) % log_every == 0:
                    print(f"[{self.strategy.name}] round {rec['round']:4d} "
                          f"loss {rec['loss']:.4f} F1 {f1:.4f} "
                          f"t={rec['round_time_s']:.3f}s")
        return self.history
