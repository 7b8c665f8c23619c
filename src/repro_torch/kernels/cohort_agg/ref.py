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

The wrappers in ``ops.py`` use these for CPU tensors; on the card they are
the yardstick the CUDA kernels are held against.
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
