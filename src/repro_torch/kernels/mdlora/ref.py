"""Plain PyTorch versions of the fused block-LoRA projections.

    y = (x * row_mask) @ W0  +  ((x * row_mask) @ a) @ b * scale

``row_mask`` zeroes the input rows of absent modality blocks (Eq. 1/2).
Both products run in fp32 (fp64 for fp64 inputs, which the gradient check
uses) and the result is cast to x's dtype, as in the kernels.
``mdlora_matmul_ref`` (one adapter for every row, kernel ``csrc/mdlora.cu``)
broadcasts over one optional leading batch axis of any operand.
"""
from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the products accumulate in: fp32, or fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def mdlora_matmul_ref(x, w0, a, b, row_mask, scale):
    """x [T, D]; w0 [D, F]; a [D, r]; b [r, F]; row_mask [D] (None = all
    ones) -> [T, F]. Any operand may carry a leading batch axis K (x [K, T,
    D], w0 [K, D, F], row_mask [K, D], ...); the result then is [K, T, F]."""
    acc = acc_dtype(x.dtype)
    xm = x.to(acc)
    if row_mask is not None:
        xm = xm * row_mask.to(acc).unsqueeze(-2)
    lora = (xm @ a.to(acc)) @ b.to(acc) * scale
    return (xm @ w0.to(acc) + lora).to(x.dtype)


def mdlora_matmul_multi_ref(x, w0, a, b, adapter_idx, row_mask, scale):
    """Gathered multi-adapter projection (S-LoRA/punica-style decode).

        y[i] = (x[i] * mask[i]) @ W0
             + ((x[i] * mask[i]) @ a[idx[i]]) @ b[idx[i]] * scale

    x [B, D]; w0 [D, F]; a [A, D, r]; b [A, r, F]; adapter_idx [B] int;
    row_mask [B, D] or None (all rows present) -> [B, F] in x's dtype.
    """
    xm = x.float() if row_mask is None else x.float() * row_mask.float()
    idx = adapter_idx.long()
    u = torch.einsum("bd,bdr->br", xm, a[idx].float())
    lora = torch.einsum("br,brf->bf", u, b[idx].float()) * scale
    return (xm @ w0.float() + lora).to(x.dtype)


def mdlora_matmul_multi_split_ref(x, w0, a, b, adapter_idx, row_mask, scale,
                                  split: int, u_split: int):
    """``mdlora_matmul_multi_ref`` in the order of the bf16 kernel's sums:
    x*m rounded once to x's dtype for the base product, which is summed
    over D splits of ``split`` rows each (fp32 partials, added in split
    order); the bottleneck u from the fp32 x*m, summed over splits of
    ``u_split`` rows in order; then y = base + scale * u @ b[idx], cast to
    x's dtype. ``split`` and ``u_split`` come from ``ops.plan_multi`` and
    ``ops.U_LEN``."""
    xm = x.float() if row_mask is None else x.float() * row_mask.float()
    xb = xm.to(x.dtype).float()
    w = w0.float()
    ag = a[adapter_idx.long()].float()
    D = x.shape[1]
    base = sum(xb[:, d:d + split] @ w[d:d + split]
               for d in range(0, D, split))
    u = sum(torch.einsum("bd,bdr->br", xm[:, d:d + u_split],
                         ag[:, d:d + u_split])
            for d in range(0, D, u_split))
    lora = torch.einsum("br,brf->bf", u, b[adapter_idx.long()].float())
    return (base + scale * lora).to(x.dtype)
