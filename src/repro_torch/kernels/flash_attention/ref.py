"""Plain PyTorch version of the flash-attention kernel.

q [B, S, K, G, hd]; k, v [B, T, K, hd]; q_pos [S]; kv_pos [T] (-1 marks an
empty cache slot); window in tokens (int32 max = global); softcap or None.
mask = causal & in window & kv_pos >= 0. A row with no valid key gives 0,
as the kernel (and the TPU kernel, ``kernel.py:59``) does; the reference's
XLA oracle gives the mean of v there instead.
"""
from __future__ import annotations

import math

import torch

GLOBAL_WINDOW = 2**31 - 1


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   window: int | None) -> torch.Tensor:
    """[S, T] bool: which keys each query row may see."""
    window = GLOBAL_WINDOW if window is None else int(window)
    qp, kp = q_pos.long()[:, None], kv_pos.long()[None, :]
    return (qp >= kp) & ((qp - kp) < window) & (kp >= 0)


def flash_attention_ref(q, k, v, q_pos, kv_pos, window=None, softcap=None):
    hd = q.shape[-1]
    s = torch.einsum("bqkgh,btkh->bqkgt", q.float() / math.sqrt(hd),
                     k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(q_pos, kv_pos, window)[None, :, None, None, :]
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    o = torch.einsum("bqkgt,btkh->bqkgh", p, v.float())
    return (o / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)
