"""Plain PyTorch versions of the fused cohort aggregation + divergence pass
(the JAX ``repro/kernels/cohort_agg/ref.py`` written in torch).

Inputs
  deltas [N, D, r]  client-stacked updates (r may be 1)
  W      [N, D]     per-(client,row) combine weights (Eq. 3/4)
  C      [N, D]     divergence cohort mask (Eq. 5)
Outputs
  agg    [D, r]     sum_n W[n,d] * deltas[n,d,:]
  sqsum  [D]        sum_n C[n,d] * ||deltas[n,d,:]||^2
  mean   [D, r]     sum_n C[n,d] * deltas[n,d,:] / max(cnt_d, 1)
  cnt    [D]        sum_n C[n,d]

The wrappers in ``ops.py`` use the one-pass versions for CPU tensors; on the
card they and the split-order versions (the kernel's order of sums, for
both uplinks) are the yardsticks the CUDA kernel is held against.
"""
from __future__ import annotations

import torch


def cohort_agg_divergence_ref(deltas, W, C):
    d32 = deltas.float()
    W = W.float()
    C = C.float()
    agg = torch.einsum("nd,ndr->dr", W, d32)
    sqsum = torch.einsum("nd,ndr->d", C, d32.square())
    cnt = C.sum(0)
    mean = torch.einsum("nd,ndr->dr", C, d32) / cnt.clamp(min=1.0)[:, None]
    return agg, sqsum, mean, cnt


def staleness_discount_ref(staleness, exponent: float):
    """FedBuff polynomial discount 1/(1+s)^a (a == 0 -> all-ones)."""
    s = staleness.float()
    if exponent == 0.0:
        return torch.ones_like(s)
    return torch.pow(1.0 + s, -exponent)


def cohort_agg_divergence_quant_ref(q, scales, W, C, staleness,
                                    exponent: float):
    """``cohort_agg_divergence_ref(q * scales, W * disc, C)`` with
    disc = 1/(1+staleness)^a, written with the per-client scalars folded
    into the [N, D] weights as the reference oracle does."""
    q32 = q.float()
    s = scales.float()
    c = C.float()
    w_eff = W.float() * (staleness_discount_ref(staleness, exponent)
                         * s)[:, None]
    agg = torch.einsum("nd,ndr->dr", w_eff, q32)
    sqsum = torch.einsum("nd,ndr->d", c * s.square()[:, None], q32.square())
    cnt = c.sum(0)
    mean = (torch.einsum("nd,ndr->dr", c * s[:, None], q32)
            / cnt.clamp(min=1.0)[:, None])
    return agg, sqsum, mean, cnt


def _split_ref(x32, W, C, s, f, splits: int, lanes: int):
    """The kernel's sums (``csrc/cohort_agg.cu`` ``agg_kernel``) over x32
    [N, D, r] with per-client scalars s (scale) and f (row-weight factor),
    [N] each: the clients in ``splits`` contiguous ranges of ceil(N /
    splits); in a range, lane l takes clients n0 + l, n0 + l + lanes, ...;
    agg += W f_n x, sum += C s_n x, sq += C s_n^2 |x_row|^2 per row, cnt +=
    C; the lanes add in lane order, then the splits in split order; mean =
    sum / max(cnt, 1)."""
    c = C.float()
    N = x32.shape[0]
    chunk = -(-N // splits)
    total = None
    for n0 in range(0, N, chunk):
        part = None
        for lane in range(lanes):
            first, end = n0 + lane, min(N, n0 + chunk)
            n = torch.arange(first, max(first, end), lanes, device=x32.device)
            cs = c[n] * s[n, None]
            terms = (torch.einsum("nd,ndr->dr", W[n].float() * f[n, None],
                                  x32[n]),
                     torch.einsum("nd,ndr->dr", cs, x32[n]),
                     torch.einsum("nd,nd->d", cs * s[n, None],
                                  x32[n].square().sum(-1)),
                     c[n].sum(0))
            part = terms if part is None else tuple(
                a + b for a, b in zip(part, terms))
        total = part if total is None else tuple(
            a + b for a, b in zip(total, part))
    agg, msum, sqsum, cnt = total
    return agg, sqsum, msum / cnt.clamp(min=1.0)[:, None], cnt


def cohort_agg_divergence_split_ref(deltas, W, C, splits: int,
                                    lanes: int = 1):
    """``cohort_agg_divergence_ref`` in the order of the kernel's sums over
    the fp32 uplink: ``_split_ref`` with every per-client scalar 1.
    ``splits`` and ``lanes`` come from ``ops.plan_agg``."""
    ones = torch.ones(deltas.shape[0], device=deltas.device)
    return _split_ref(deltas.float(), W, C, ones, ones, splits, lanes)


def cohort_agg_divergence_quant_split_ref(q, scales, W, C, staleness,
                                          exponent: float, splits: int,
                                          lanes: int = 1):
    """``cohort_agg_divergence_quant_ref`` in the order of the kernel's sums
    over the int8 uplink: ``_split_ref`` over the codes, summed as codes,
    with the scale s_n and f_n = s_n / (1 + staleness_n)^a folded into the
    row weights. ``splits`` and ``lanes`` come from ``ops.plan_agg``."""
    s = scales.float()
    f = s * staleness_discount_ref(staleness, exponent)
    return _split_ref(q.float(), W, C, s, f, splits, lanes)


def divergence_from_stats(sqsum, mean, cnt, row_block_ids, n_blocks: int):
    """Reduce the row statistics to per-block divergences (Eq. 5): per row
    sqsum / cnt - |mean|^2 (0 where cnt = 0), summed over the rows of each
    block. The block sums are a masked reduction over a [n_blocks, D]
    one-hot, not a scatter-add: ``index_add_`` on the card adds with float
    atomics, whose order, and so the sum's last bits, change from call to
    call."""
    cnt = cnt.float()
    per_row = torch.where(cnt > 0, sqsum.float() / cnt.clamp(min=1.0)
                          - mean.float().square().sum(-1),
                          torch.zeros_like(cnt))
    blocks = torch.arange(n_blocks, device=per_row.device)
    onehot = row_block_ids.long()[None, :] == blocks[:, None]
    return torch.where(onehot, per_row[None, :], 0.0).sum(1)
