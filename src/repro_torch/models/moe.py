"""Mixtral-style sparse MoE MLP (top-k routing over SwiGLU experts).

The reference's ``repro/models/moe.py``. Dispatch is sort-based with a
fixed capacity per sequence: each sequence's (token, expert) assignments
are sorted by expert id with a stable sort and gathered into an [E, C, d]
buffer, so the expert products are batched matmuls over the active tokens
(x capacity_factor). Assignments past an expert's capacity are dropped;
which ones depends on the stable order, so it is the reference's.

All B sequences dispatch at once: the sort runs along each row of [B, S*k]
(the row is the sequence part of the (sequence, expert) key), capacity is
per (sequence, expert), and the experts' products run over [E, B*C, d].
The combine gathers each token's ``top_k`` slots and sums them, with no
atomics: with top_k = 2 each token gets two addends, and a + b is the same
in either order, so the result is the reference's scatter-add onto zero.
Those expert products stay plain ``torch.bmm``: the reference computes
them as einsums outside any Pallas kernel. That path ("sparse") is the one
a train step takes, as the reference trains.

``impl="dropless"`` is the inference path (Mixtral as published drops
nothing): one stable sort of all B*S*k assignments of the batch by expert,
across rows; each expert's rows are one contiguous segment, whose ends
``searchsorted`` reads off the sorted ids on the device (CUDA's
``bincount`` would read its maximum on the host); the SwiGLU products are
one grouped product per matrix (``torch._grouped_mm``: on the card in bf16
CUTLASS's grouped GEMM, one set-up kernel and one GEMM launch) over exactly
the B*S*k rows, with no capacity, no drop and no padding row; the combine
puts each row back in (token, k) order and sums the gated k rows, with no
atomics. Its spans are ``moe.route``, ``moe.experts`` (attributes while
recording: ``assignments`` = B*S*k, from the shapes, and ``load``, the [E]
rows each expert got, a device tensor read only after the traced stretch)
and ``moe.combine``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels import runtime
from repro_torch.models import layers as L


def init_moe_mlp(generator: torch.Generator | None, d_model: int, d_ff: int,
                 n_experts: int, device: torch.device | str | None = None,
                 dtype: torch.dtype = torch.float32,
                 layers: int | None = None) -> dict:
    """router [.., d, E] (fp32 in every model, as the reference's), wi and
    wg [.., E, d, f], wo [.., E, f, d]; stacked [layers, ...] when
    ``layers`` is given. Scales 1/sqrt(in)."""
    dev = runtime.resolve_device(device)
    lead = () if layers is None else (layers,)
    E, d, f = n_experts, d_model, d_ff
    return {
        "router": L.normal(generator, lead + (d, E), 1 / math.sqrt(d), dev),
        "wi": L.normal(generator, lead + (E, d, f), 1 / math.sqrt(d), dev,
                       dtype),
        "wg": L.normal(generator, lead + (E, d, f), 1 / math.sqrt(d), dev,
                       dtype),
        "wo": L.normal(generator, lead + (E, f, d), 1 / math.sqrt(f), dev,
                       dtype),
    }


def capacity(S: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per (sequence, expert), as the reference computes them."""
    return max(top_k, int(capacity_factor * S * top_k / n_experts + 0.5))


def route(p: dict, x: torch.Tensor, top_k: int) -> tuple:
    """fp32 router, softmax, top-k on the probabilities with the gates
    renormalised. -> (probs [.., E], gates [.., k], expert ids [.., k])."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True), ids


def dispatch(ids: torch.Tensor, n_experts: int, cap: int) -> tuple:
    """Sort-based dispatch of every sequence at once.

    ids [B, S, k] -> (order [B, A], rank [B, A], slot [B, A]) over the
    A = S*k assignments of each row: ``order`` sorts them by expert (stable,
    so equal experts keep token order), ``rank`` is each sorted
    assignment's place within its expert, ``slot`` = expert * cap + rank
    where rank < cap, else E * cap (dropped)."""
    B = ids.shape[0]
    flat = ids.reshape(B, -1)
    sorted_e, order = torch.sort(flat, dim=-1, stable=True)
    A = flat.shape[1]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(A, device=ids.device) - first
    slot = torch.where(rank < cap, sorted_e * cap + rank, n_experts * cap)
    return order, rank, slot


def _sparse(p: dict, x: torch.Tensor, top_k: int, cap: int,
            activation: str) -> tuple:
    B, S, d = x.shape
    E = p["wi"].shape[0]
    probs, gates, ids = route(p, x, top_k)
    # load-balancing aux loss, per sequence, then averaged
    me = probs.mean(1)  # [B, E]
    ce = F.one_hot(ids, E).float().sum(2).mean(1)
    aux = (E * (me * ce).sum(-1)).mean()

    order, _, slot = dispatch(ids, E, cap)
    A = S * top_k
    token = torch.div(order, top_k, rounding_mode="floor")  # [B, A]
    # each kept slot's token; empty slots read token 0 and get gate 0
    buf_tok = torch.zeros((B, E * cap + 1), dtype=torch.long,
                          device=x.device)
    buf_tok.scatter_(1, slot, token)
    buf_gate = torch.zeros((B, E * cap + 1), dtype=gates.dtype,
                           device=x.device)
    buf_gate.scatter_(1, slot, gates.reshape(B, A).gather(1, order))
    buf_tok, buf_gate = buf_tok[:, :-1], buf_gate[:, :-1]
    xe = x.gather(1, buf_tok[..., None].expand(B, E * cap, d))
    xe = xe.view(B, E, cap, d).transpose(0, 1).reshape(E, B * cap, d)

    act = L._ACTIVATIONS[activation]
    h = act(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wi"])
    ye = torch.bmm(h, p["wo"])  # [E, B*C, d]
    ye = ye.view(E, B, cap, d).transpose(0, 1).reshape(B, E * cap, d)
    ye = ye * buf_gate[..., None].to(ye.dtype)

    # combine: each assignment's slot (E*cap = dropped -> a zero row),
    # gathered per token and summed over its top_k slots
    where = torch.empty_like(slot).scatter_(1, order, slot)  # [B, A]
    ye = torch.cat([ye, ye.new_zeros(B, 1, d)], dim=1)
    out = ye.gather(1, where[..., None].expand(B, A, d))
    out = out.view(B, S, top_k, d).sum(2)
    return out.to(x.dtype), aux


def _dense(p: dict, x: torch.Tensor, top_k: int, activation: str) -> tuple:
    """Every expert on every token, combined with the renormalised top-k
    gates: the sparse path at unbounded capacity."""
    E = p["wi"].shape[0]
    probs, gv, ids = route(p, x, top_k)
    gates = (F.one_hot(ids, E).float() * gv[..., None]).sum(2)  # [B, S, E]
    me = probs.mean((0, 1))
    ce = (gates > 0).float().mean((0, 1))
    aux = E * (me * ce).sum()
    act = L._ACTIVATIONS[activation]
    h = act(torch.einsum("bsd,edf->bsef", x, p["wg"])) * torch.einsum(
        "bsd,edf->bsef", x, p["wi"])
    ye = torch.einsum("bsef,efd->bsed", h, p["wo"])
    out = torch.einsum("bsed,bse->bsd", ye, gates.to(ye.dtype))
    return out.to(x.dtype), aux


def _dropless(p: dict, x: torch.Tensor, top_k: int, activation: str
              ) -> tuple:
    """Every assignment of the batch through its expert, none dropped.
    The load-balancing loss is a training term: this path returns 0.0."""
    B, S, d = x.shape
    E = p["wi"].shape[0]
    A = B * S * top_k
    with trace.span("moe.route"):
        _, gates, ids = route(p, x, top_k)
    with trace.span("moe.experts") as sp:
        sorted_e, order = torch.sort(ids.reshape(A), stable=True)
        ends = torch.searchsorted(
            sorted_e, torch.arange(E, device=x.device, dtype=sorted_e.dtype),
            right=True, out_int32=True)
        xs = x.reshape(B * S, d).index_select(
            0, torch.div(order, top_k, rounding_mode="floor"))
        act = L._ACTIVATIONS[activation]
        h = act(torch._grouped_mm(xs, p["wg"], offs=ends)) \
            * torch._grouped_mm(xs, p["wi"], offs=ends)
        ys = torch._grouped_mm(h, p["wo"], offs=ends)  # [A, d], by expert
        if sp is not trace.OFF:
            sp.attrs.update(assignments=A, load=torch.diff(
                ends, prepend=ends.new_zeros(1)))
    with trace.span("moe.combine"):
        y = torch.empty_like(ys).index_copy_(0, order, ys)  # (token, k) order
        out = (y.view(B, S, top_k, d) * gates[..., None].to(y.dtype)).sum(2)
    return out.to(x.dtype), 0.0


def moe_mlp(p: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, activation: str = "silu",
            impl: str = "sparse") -> tuple:
    """x [B, S, d] -> (out [B, S, d], aux loss). ``impl`` "sparse": the
    per-sequence dispatch at capacity ``capacity(S, ...)``; "dense": every
    expert on every token; "dropless": the batch's assignments grouped by
    expert, none dropped (aux 0.0)."""
    if impl == "dense":
        return _dense(p, x, top_k, activation)
    if impl == "dropless":
        return _dropless(p, x, top_k, activation)
    if impl != "sparse":
        raise ValueError(f"unknown moe impl {impl!r}")
    cap = capacity(x.shape[1], top_k, p["wi"].shape[0], capacity_factor)
    return _sparse(p, x, top_k, cap, activation)
