"""Plain PyTorch versions of the fused block-LoRA projections.

    y = (x * row_mask) @ W0  +  ((x * row_mask) @ a) @ b * scale

``row_mask`` zeroes the input rows of absent modality blocks (Eq. 1/2).
Both products run in fp32 (fp64 for fp64 inputs, which the gradient check
uses) and the result is cast to x's dtype, as in the kernels.
``mdlora_matmul_ref`` (one adapter for every row, kernel ``csrc/mdlora.cu``)
broadcasts over one optional leading batch axis of any operand;
``mdlora_matmul_tf32x3_ref`` is the same function in that kernel's
arithmetic.
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


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits
    (0x1000) to the magnitude and clear them. Inf and NaN pass unchanged."""
    bits = v.float().contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = ((bits & ~0x7FFFFFFF) | mag).view(torch.float32)
    return torch.where(torch.isfinite(v), out, v.float())


def mdlora_matmul_tf32x3_ref(x, w0, a, b, row_mask, scale, groups: int = 4):
    """``mdlora_matmul_ref`` in the arithmetic of ``csrc/mdlora.cu``'s
    tensor-core products: x*m (rounded to bf16 once for bf16 x) times
    [W0 | a] side by side, each operand split into TF32 hi = rna(v) and lo
    = rna(v - hi). D is cut into k-steps of the kernel's depth (8 d in fp32,
    16 in bf16); k-step i belongs to k-group i % ``groups``, which adds, per
    k-step in ascending order, lo*hi, then hi*lo, then hi*hi to its fp32
    sums; the k-groups are added in order. Then y = base + scale * u @ b in
    fp32, cast to x's dtype. bf16 operands are exact in TF32 (lo = 0)."""
    xm = x.float()
    if row_mask is not None:
        xm = xm * row_mask.float().unsqueeze(-2)
    if x.dtype == torch.bfloat16:
        xm = xm.to(torch.bfloat16).float()
    lead = torch.broadcast_shapes(x.shape[:-2], w0.shape[:-2], a.shape[:-2],
                                  b.shape[:-2])
    wa = torch.cat([w0.float().expand(lead + w0.shape[-2:]),
                    a.float().expand(lead + a.shape[-2:])], -1)
    xh, wh = tf32_rna(xm), tf32_rna(wa)
    xl, wl = tf32_rna(xm - xh), tf32_rna(wa - wh)
    step = 16 if x.dtype == torch.bfloat16 else 8
    sums = [torch.zeros(lead + (x.shape[-2], wa.shape[-1]), device=x.device)
            for _ in range(groups)]
    for i, d in enumerate(range(0, x.shape[-1], step)):
        k = slice(d, d + step)
        acc = sums[i % groups] + xl[..., k] @ wh[..., k, :]
        acc = acc + xh[..., k] @ wl[..., k, :]
        sums[i % groups] = acc + xh[..., k] @ wh[..., k, :]
    acc = sums[0]
    for part in sums[1:]:
        acc = acc + part
    F = w0.shape[-1]
    lora = acc[..., F:] @ b.float()
    return (acc[..., :F] + scale * lora).to(x.dtype)


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
