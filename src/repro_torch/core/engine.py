"""The pieces of the RELIEF round engine (paper Algorithm 1) that the
asynchronous runtime runs: client local training, batch draws and
divergence-guided elastic allocation (Eq. 7).

Local training is ``torch.func.vmap(torch.func.grad_and_value(loss))`` over
the client axis, with a Python loop over the E x steps Adam steps; the
trainable tree carries K stacked copies. The synchronous ``FedRun`` is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import allocation as AL
from repro_torch.core import mdlora
from repro_torch.core.strategies import Strategy
from repro_torch.core.tasks import MMTask
from repro_torch.optim import adam_init, adam_update
from repro_torch.sim import FleetConfig
from repro_torch.sim import timing as T
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class FedConfig:
    rounds: int = 50
    local_epochs: int = 5  # E (paper VI-A3)
    steps_per_epoch: int = 4
    batch_size: int = 32
    lr: float = 1e-3
    gamma: float = 0.9  # EMA coefficient (Eq. 6)
    server_lr: float = 1.0
    t_overhead: float = 0.05
    utilization: float = 0.3
    eval_every: int = 5
    seed: int = 0
    # timing model: "flop_proportional" = the paper's Sec. VI-A3 simulator
    # (compute ~ trained-group FLOPs only); "fwd_aware" = the Sec. VII model
    # charging the fixed full-model forward to everyone.
    sim_mode: str = "flop_proportional"


# ---------------------------------------------------------------------------
# local update (shared by every strategy)
# ---------------------------------------------------------------------------


def make_local_update(task: MMTask, fed: FedConfig, prox_mu: float):
    """-> local_update(start, batches, mmasks, gates, lr) ->
    (deltas [K, ...] tree, mean losses [K]).

    start: [K, ...] stacked trainable; batches: {"x": [K, steps, B, T, C],
    "y": [K, steps, B]}; mmasks: [K, M]; gates: [K, G]. Gradients and the
    returned delta are gated to each client's selected groups, as in the
    reference."""
    layout = task.layout

    def loss_one(tr, x, y, mmask):
        return task.loss(tr, {"x": x, "y": y, "modality_mask": mmask})

    grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_one))

    def local_update(start, batches, mmasks, gates, lr):
        tr, opt = start, adam_init(start)
        losses = []
        for s in range(batches["x"].shape[1]):
            grads, loss = grad_fn(tr, batches["x"][:, s], batches["y"][:, s],
                                  mmasks)
            if prox_mu > 0.0:
                grads = tree_map(lambda g, t, t0: g + prox_mu * (t - t0),
                                 grads, tr, start)
            grads = mdlora.group_gate_tree(layout, grads, gates)
            tr, opt = adam_update(tr, grads, opt, lr)
            losses.append(loss)
        delta = tree_map(lambda a, b: a.float() - b.float(), tr, start)
        delta = mdlora.group_gate_tree(layout, delta, gates)
        return delta, torch.stack(losses, 1).mean(1)

    return local_update


# ---------------------------------------------------------------------------
# data plumbing (the reference's rng call sequence, so batches match bit for
# bit)
# ---------------------------------------------------------------------------


def draw_client_batches(rng: np.random.Generator, dataset, clients,
                        steps: int, batch_size: int,
                        device: torch.device | str) -> dict:
    """Stacked local-training batches for ``clients`` (one rng.integers call
    per client, in iteration order)."""
    xs, ys = [], []
    for n in clients:
        src = n % len(dataset.train_y)
        idx = rng.integers(0, len(dataset.train_y[src]),
                           size=(steps, batch_size))
        xs.append(dataset.train_x[src][idx])
        ys.append(dataset.train_y[src][idx])
    return {"x": torch.as_tensor(np.stack(xs), device=device),
            "y": torch.as_tensor(np.stack(ys), dtype=torch.int64,
                                 device=device)}


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
                  idx: np.ndarray) -> np.ndarray:
    """S rows [len(idx), G] for the client subset ``idx``; row-identical to
    ``allocate(...)[0][idx]`` for every deterministic allocator."""
    idx = np.asarray(idx)
    cand, mandatory, k = plan.cand[idx], plan.mandatory[idx], plan.k[idx]
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


def _rank_gates(strategy: Strategy) -> None:
    """HeLoRA rank gates. Without ``rank_caps`` every gate is one, and the
    local update leaves the multiplication out; capped ranks are not ported
    yet and raise."""
    if strategy.rank_caps:
        raise NotImplementedError("rank_caps (HeLoRA) are not ported yet")
