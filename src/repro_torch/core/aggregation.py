"""Server-side aggregation (paper Eq. 3-5).

* ``cohort_weights``      -- RELIEF's [N, G] combine weights: each group is
  averaged only over the clients that trained it; the shared fusion B uses
  normalized modality-count weighting (Eq. 4).
* ``fedavg_weights``      -- naive FedAvg over all N participants, the
  paper's interference-prone baseline.
* ``aggregate``           -- the synchronous round's Eq. 3 step through
  ``mdlora.weighted_combine`` (plain reductions).
* ``trimmed_mean``, ``coordinate_median``, ``krum_select`` and
  ``robust_combine`` -- Byzantine-robust location estimates of each group's
  cohort, replacing the weighted mean (membership = W > 0).
* ``lemma1_decomposition`` -- Lemma 1's bias^2 / variance / interference
  split of one fusion block's FedAvg error.
* ``staleness_discounts`` -- FedBuff's polynomial 1/(1+s)^a.
* ``CohortAggBuffer``     -- streaming Eq. 3 aggregate + Eq. 5 divergence
  statistics over a flushed cohort; the row-blocked fusion leaf goes through
  the fused ``kernels/cohort_agg`` ops (the CUDA kernels on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core import mdlora
from repro_torch.kernels.cohort_agg import ops as cohort_ops
from repro_torch.kernels.cohort_agg.ref import staleness_discount_ref
from repro_torch.tree import (leaves, leaves_with_path, map_with_path,
                               tree_map)


def cohort_weights(layout: mdlora.GroupLayout, trained: torch.Tensor,
                   modality_mask: torch.Tensor,
                   client_scale: torch.Tensor | None = None,
                   defer_scale: bool = False) -> torch.Tensor:
    """RELIEF combine weights W: [N, G].

    trained: [N, G] -- which groups each client trained+uploaded.
    modality_mask: [N, M] -- possession, for Eq. 4's w_n = (|M_n|/M)/sum(...).
    client_scale: optional [N] per-client weight applied *inside* the
    normalization (the async runtime's staleness discounts).
    defer_scale: keep ``client_scale`` in the denominator but not the
    numerator, for the quantized ingest that re-applies it inside the fused
    reduction. Empty cohort => all-zero column (the block stays frozen).
    """
    trained = trained.float()
    mcount = modality_mask.float().sum(1)  # [N]
    is_b = torch.as_tensor(np.array(layout.kinds) == mdlora.KIND_FUSION_B,
                           device=trained.device)  # [G]
    u = torch.where(is_b[None, :], (mcount / layout.n_modalities)[:, None],
                    1.0)  # [N, G]
    w = num = trained * u
    if client_scale is not None:
        w = w * client_scale.float()[:, None]
        if not defer_scale:
            num = w
    denom = w.sum(0, keepdim=True)  # [1, G]
    return torch.where(denom > 0, num / denom.clamp(min=1e-12), 0.0)


def fedavg_weights(n_clients: int, G: int,
                   participating: torch.Tensor | None = None,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """Naive FedAvg: every participant weighted 1/N_part for every group."""
    if participating is None:
        participating = torch.ones(n_clients, device=device)
    p = participating.float()
    return (p / p.sum().clamp(min=1.0))[:, None].expand(n_clients, G)


def aggregate(layout: mdlora.GroupLayout, global_trainable: Any,
              deltas: Any, W: torch.Tensor, server_lr: float = 1.0) -> Any:
    """theta^{r+1} = theta^r + server_lr * sum_n W[n,g] * delta_n (Eq. 3)."""
    agg = mdlora.weighted_combine(layout, deltas, W)
    return tree_map(lambda t, d: (t.float() + server_lr * d).to(t.dtype),
                    global_trainable, agg)


def lemma1_decomposition(block_deltas: torch.Tensor,
                         cohort: torch.Tensor) -> dict:
    """Empirical Lemma 1 for one fusion block.

    block_deltas: [N, d, r] per-client updates to one block A_m; cohort:
    [N] bool -- C_m (possession). -> the scaling / interference /
    intra-cohort terms, the exact FedAvg error and their bound (Eq. 12-13).
    """
    c = cohort.float()
    x = block_deltas.float()
    N = x.shape[0]
    nC = c.sum()
    g_bar = torch.einsum("n,n...->...", c / nC.clamp(min=1.0), x)
    g_hat = x.mean(0)  # FedAvg over all N
    eps_hat = torch.einsum("n,n...->...",
                           (1 - c) / (N - nC).clamp(min=1.0), x)
    err = (g_hat - g_bar).square().sum()
    scaling = (1 - nC / N) ** 2 * g_bar.square().sum()
    interference = ((N - nC) / N) ** 2 * eps_hat.square().sum()
    intra = torch.einsum("n,n->", c / nC.clamp(min=1.0),
                         (x - g_bar).square().sum(
                             dim=tuple(range(1, x.dim()))))
    return {"error": err, "scaling": scaling, "interference": interference,
            "intra_cohort": intra,
            "bound": 2 * scaling + 2 * interference
            + intra / nC.clamp(min=1.0)}


def staleness_discounts(staleness: torch.Tensor,
                        exponent: float) -> torch.Tensor:
    """FedBuff-style polynomial staleness discount 1/(1+s)^a. s is measured
    in server model versions (flushes) since the client pulled."""
    return 1.0 / torch.pow(1.0 + staleness.float(), exponent)


# Byzantine-robust within-cohort reducers. RELIEF's cohorts (Eq. 3) are
# small by construction, so one corrupted client can own a modality block;
# these replace the weighted mean with bounded-breakdown estimates inside
# each group's cohort (membership = W > 0). Divergence statistics (Eq. 5)
# are unchanged: only the aggregate is robust.

ROBUST_AGGREGATORS = ("mean", "trimmed", "median", "krum")


def trimmed_mean(x: torch.Tensor, w: torch.Tensor,
                 trim_frac: float) -> torch.Tensor:
    """Coordinate-wise beta-trimmed weighted mean along axis 0.

    x: [K, ...]; w: non-negative weights broadcastable to x (w > 0 marks
    membership). Per coordinate the t = floor(beta * k) smallest and largest
    member values are dropped (t <= (k-1)//2, so one survives) and the rest
    averaged with renormalized weights. beta = 0 is the weighted mean; an
    empty coordinate gives 0.
    """
    x = x.float()
    w = torch.broadcast_to(w.float(), x.shape)
    member = w > 0
    k = member.sum(0)
    t = torch.minimum(torch.floor(trim_frac * k),
                      torch.clamp((k - 1) // 2, min=0)).long()
    # non-members sort to the top (stable), so ranks 0..k-1 are the members
    order = torch.argsort(torch.where(member, x, torch.inf), dim=0,
                          stable=True)
    ranks = torch.argsort(order, dim=0, stable=True)
    keep = member & (ranks >= t) & (ranks < k - t)
    wk = torch.where(keep, w, 0.0)
    denom = wk.sum(0)
    return torch.where(denom > 0, (wk * x).sum(0) / denom.clamp(min=1e-12),
                       0.0)


def coordinate_median(x: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over member rows along axis 0 (even counts
    average the two middle values; empty coordinates give 0)."""
    x = x.float()
    member = torch.broadcast_to(member.bool(), x.shape)
    k = member.sum(0)
    s = torch.sort(torch.where(member, x, torch.inf), dim=0, stable=True)[0]
    lo = torch.gather(s, 0, torch.clamp((k - 1) // 2, min=0)[None])
    hi = torch.gather(s, 0, torch.clamp(k // 2, min=0)[None])
    return torch.where(k > 0, 0.5 * (lo + hi)[0], 0.0)


def group_pairwise_sq(layout: mdlora.GroupLayout, deltas: Any) -> torch.Tensor:
    """[K, K, G]: ||delta_i - delta_j||^2 restricted to each group, over
    the layout's three leaf classes (fusion row blocks, layer-stacked
    slices, whole leaves).

    Exactly symmetric and free of atomics on every device: Krum's scores
    tie by construction (two members of a 2- or 3-client cohort score each
    other's distance), and its first-index tie-break must see equal
    values, as the reference's does."""
    acc = None
    for p, leaf in leaves_with_path(deltas):
        x = leaf.float()
        K = x.shape[0]
        if acc is None:
            acc = torch.zeros((K, K, layout.G), device=x.device)
        d = x[:, None] - x[None, :]  # [K, K, ...]
        if p == layout.fusion_a_path:  # contiguous row blocks, one group each
            per = d.square().sum(dim=tuple(range(3, d.dim())))  # [K, K, D]
            for s, e, g in layout.fusion_rows:
                acc[:, :, g] += per[:, :, s:e].sum(-1)
        elif p in layout.leaf_axis0_groups:  # one group per slice, distinct
            ids = layout.split_index(p, leaf.shape[1], leaf.device)
            acc[:, :, ids] += d.square().sum(dim=tuple(range(3, d.dim())))
        elif p in layout.leaf_group:
            acc[:, :, layout.leaf_group[p]] += d.square().sum(
                dim=tuple(range(2, d.dim())))
    return 0.5 * (acc + acc.transpose(0, 1))


def krum_select(d2: torch.Tensor, member: torch.Tensor,
                f: int) -> torch.Tensor:
    """Blockwise Krum (Blanchard et al., NeurIPS'17): per group, score_i =
    the summed distances to i's k - f - 2 nearest co-members (clamped to
    [1, max(k-1, 1)]); the lowest-scoring member (first on ties) is
    selected -> [G] int64 client row (0 for an empty group)."""
    member = member.bool()
    K = member.shape[0]
    k = member.sum(0)  # [G]
    eye = torch.eye(K, dtype=torch.bool, device=member.device)
    pair = member[:, None, :] & member[None, :, :] & ~eye[:, :, None]
    ds = torch.sort(torch.where(pair, d2, torch.inf), dim=1, stable=True)[0]
    csum = torch.cumsum(torch.where(torch.isfinite(ds), ds, 0.0), dim=1)
    nn = torch.minimum(torch.clamp(k - f - 2, min=1),
                       torch.clamp(k - 1, min=1))  # [G]
    idx = (nn - 1)[None, None, :].expand(K, 1, member.shape[1])
    score = torch.gather(csum, 1, idx)[:, 0, :]  # [K, G]
    return torch.argmin(torch.where(member, score, torch.inf), dim=0)


def robust_combine(layout: mdlora.GroupLayout, deltas: Any, W: torch.Tensor,
                   kind: str, trim_frac: float = 0.1,
                   krum_f: int = 1) -> Any:
    """Robust replacement for ``weighted_combine``: per-group location
    estimates of the member deltas (membership = W > 0), at the Eq. 3
    mean's scale. "krum" takes the selected member's block verbatim."""
    if kind not in ROBUST_AGGREGATORS:
        raise ValueError(f"robust kind must be one of {ROBUST_AGGREGATORS}, "
                         f"got {kind!r}")
    W = W.float()
    if kind == "mean":
        return mdlora.weighted_combine(layout, deltas, W)
    if kind == "krum":
        sel = krum_select(group_pairwise_sq(layout, deltas), W > 0, krum_f)
        W_sel = torch.zeros_like(W)
        W_sel[sel, torch.arange(W.shape[1], device=W.device)] = (
            (W > 0).any(0).float())
        return mdlora.weighted_combine(layout, deltas, W_sel)

    def reduce(p, leaf):
        x = leaf.float()
        idx = layout.split_index(p, leaf.shape[1], leaf.device)
        if idx is not None:
            w = W[:, idx]
            w = w.reshape(w.shape + (1,) * (x.dim() - 2))
        elif p in layout.leaf_group:
            w = W[:, layout.leaf_group[p]]
            w = w.reshape(w.shape + (1,) * (x.dim() - 1))
        else:
            return torch.zeros(leaf.shape[1:], device=leaf.device)
        if kind == "trimmed":
            return trimmed_mean(x, w, trim_frac)
        return coordinate_median(x, w > 0)

    return map_with_path(reduce, deltas)


@dataclasses.dataclass
class QuantizedStack:
    """A client-stacked int8 uplink payload: ``q`` leaves are [K, ...] int8
    and ``scales`` leaves the matching [K] per-(client, leaf) dequant
    scales. ``CohortAggBuffer.push_quantized`` ingests it without
    rebuilding the fp32 stack."""
    q: Any
    scales: Any


class CohortAggBuffer:
    """Streaming Eq. 3 aggregate + Eq. 5 divergence sufficient statistics.

        push(deltas [K,...], W [K,G], C [K,G])            fp32 uplink
        push_quantized(q, scales, W, C, staleness, a)     int8 uplink
        finalize() -> (agg tree, divergence [G], cohort counts [G])

    The fusion leaf goes through ``kernels/cohort_agg`` (aggregate and
    per-row sqsum/mean/count in one pass); Backbone 2's layer-stacked leaves
    reduce per slice (one group per layer) and every other leaf is a
    whole-leaf group, with the same masked einsums as the reference. Empty
    cohorts finalize to zero aggregate and zero divergence (frozen block).

    ``robust`` ("mean" | "trimmed" | "median" | "krum") selects the
    within-cohort estimate of the *aggregate*; the divergence statistics
    stay the plain sufficient statistics, so a robust flush still runs the
    fused kernel on the fusion leaf. Order statistics do not stream: a
    robust buffer takes exactly one push per finalize.
    """

    def __init__(self, layout: mdlora.GroupLayout, proto: Any,
                 robust: str = "mean", trim_frac: float = 0.1,
                 krum_f: int = 1):
        if robust not in ROBUST_AGGREGATORS:
            raise ValueError(f"robust must be one of {ROBUST_AGGREGATORS}, "
                             f"got {robust!r}")
        self.layout = layout
        self.robust = robust
        self.trim_frac = trim_frac
        self.krum_f = krum_f
        self._proto = proto
        self.reset()

    def reset(self) -> None:
        """Clear accumulated state so the buffer can serve the next flush."""
        zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)  # noqa: E731
        self._agg = tree_map(zeros, self._proto)
        self._csum = tree_map(zeros, self._proto)
        dev = leaves(self._proto)[0].device
        self._sq = torch.zeros(self.layout.G, device=dev)
        self._cnt = torch.zeros(self.layout.G, device=dev)
        self._pushes = 0

    def _commit(self, pairs: Any, sq: torch.Tensor, C: torch.Tensor) -> None:
        """Add one chunk: ``pairs`` has (aggregate, cohort sum) leaves."""
        self._agg = tree_map(lambda a, pr: a + pr[0], self._agg, pairs)
        self._csum = tree_map(lambda c, pr: c + pr[1], self._csum, pairs)
        self._sq = self._sq + sq
        self._cnt = self._cnt + C.sum(0)

    def push(self, deltas: Any, W: torch.Tensor, C: torch.Tensor) -> None:
        """deltas: client-stacked tree ([K, ...] leaves); W/C: [K, G]
        combine weights and divergence-cohort mask for this chunk."""
        layout = self.layout
        if self.robust != "mean":
            if self._pushes > 0:
                raise RuntimeError(
                    f"robust={self.robust!r} aggregation needs the whole "
                    "cohort in one push; chunked pushes are mean-only")
            self._pushes += 1
        W, C = W.float(), C.float()
        sq = torch.zeros(layout.G, device=W.device)

        def reduce(p, leaf):
            x = leaf.float()
            if p == layout.fusion_a_path:
                rg = layout.row_index(leaf.shape[1], leaf.device)
                agg, sq_rows, mean_rows, cnt_rows = (
                    cohort_ops.cohort_agg_divergence(
                        x.contiguous(), W[:, rg].contiguous(),
                        C[:, rg].contiguous()))
                sq.index_add_(0, rg, sq_rows)
                return agg, mean_rows * cnt_rows[:, None]
            if p in layout.leaf_axis0_groups:
                ids = layout.split_index(p, leaf.shape[1], leaf.device)
                per_l = x.square().sum(dim=tuple(range(2, x.dim())))  # [K, L]
                sq.index_add_(0, ids, (per_l * C[:, ids]).sum(0))
                return (torch.einsum("nl,nl...->l...", W[:, ids], x),
                        torch.einsum("nl,nl...->l...", C[:, ids], x))
            if p in layout.leaf_group:
                g = layout.leaf_group[p]
                per_n = x.square().sum(dim=tuple(range(1, x.dim())))  # [K]
                sq[g] += (per_n * C[:, g]).sum()
                return (torch.einsum("n,n...->...", W[:, g], x),
                        torch.einsum("n,n...->...", C[:, g], x))
            zero = torch.zeros(leaf.shape[1:], device=leaf.device)
            return zero, zero

        pairs = map_with_path(reduce, deltas)
        if self.robust != "mean":  # only the aggregate is replaced
            agg = robust_combine(layout, deltas, W, self.robust,
                                 self.trim_frac, self.krum_f)
            pairs = tree_map(lambda pr, a: (a, pr[1]), pairs, agg)
        self._commit(pairs, sq, C)

    def push_quantized(self, q: Any, scales: Any, W: torch.Tensor,
                       C: torch.Tensor, staleness: torch.Tensor | None = None,
                       exponent: float = 0.0) -> None:
        """One-pass compressed ingest: int8 client chunks, dequantized and
        staleness-discounted inside the reduction.

        q: client-stacked tree ([K, ...] int8 leaves); scales: matching [K]
        dequant scales. W must come from ``cohort_weights(...,
        defer_scale=True)`` when the discount takes part in normalization:
        the effective weight W * 1/(1+staleness)^exponent is applied here,
        inside the fused kernel for the fusion leaf and folded into the [K]
        einsum weights for every other leaf. A robust buffer cannot take
        order statistics over codes with per-client scales: it dequantizes
        the chunk (fresh tensors) and takes ``push`` with the discount
        folded into W.
        """
        layout = self.layout
        W, C = W.float(), C.float()
        if staleness is None:
            staleness = torch.zeros(W.shape[0], device=W.device)
        staleness = staleness.float()
        disc = staleness_discount_ref(staleness, exponent)
        if self.robust != "mean":
            self.push(dist.dequantize_int8_stacked(q, scales),
                      W * disc[:, None], C)
            return
        sq = torch.zeros(layout.G, device=W.device)

        def reduce(p, leaf, f):
            f = f.float()  # [K] dequant scales
            if p == layout.fusion_a_path:
                rg = layout.row_index(leaf.shape[1], leaf.device)
                agg, sq_rows, mean_rows, cnt_rows = (
                    cohort_ops.cohort_agg_divergence_quant(
                        leaf.contiguous(), f.contiguous(),
                        W[:, rg].contiguous(), C[:, rg].contiguous(),
                        staleness.contiguous(), exponent))
                sq.index_add_(0, rg, sq_rows)
                return agg, mean_rows * cnt_rows[:, None]
            x = leaf.float()
            if p in layout.leaf_axis0_groups:
                ids = layout.split_index(p, leaf.shape[1], leaf.device)
                per_l = x.square().sum(dim=tuple(range(2, x.dim())))  # [K, L]
                sq.index_add_(0, ids, (per_l * C[:, ids]
                                       * f.square()[:, None]).sum(0))
                return (torch.einsum("nl,nl...->l...",
                                     W[:, ids] * (disc * f)[:, None], x),
                        torch.einsum("nl,nl...->l...",
                                     C[:, ids] * f[:, None], x))
            if p in layout.leaf_group:
                g = layout.leaf_group[p]
                per_n = x.square().sum(dim=tuple(range(1, x.dim())))  # [K]
                sq[g] += (per_n * C[:, g] * f.square()).sum()
                return (torch.einsum("n,n...->...", W[:, g] * disc * f, x),
                        torch.einsum("n,n...->...", C[:, g] * f, x))
            zero = torch.zeros(leaf.shape[1:], device=leaf.device)
            return zero, zero

        self._commit(map_with_path(reduce, q, scales), sq, C)

    def finalize(self) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """-> (aggregate tree, per-group divergence [G], cohort counts [G]).

        Divergence uses the sufficient-statistics identity
        E||d - mean||^2 = E||d||^2 - ||mean||^2 over each group's cohort.
        """
        cnt = self._cnt
        inv = 1.0 / cnt.clamp(min=1.0)
        mean_tree = mdlora.group_gate_tree(self.layout, self._csum, inv)
        msq = mdlora.group_norms(self.layout, mean_tree)
        d = torch.where(cnt > 0, (self._sq * inv - msq).clamp(min=0.0), 0.0)
        return self._agg, d, cnt
