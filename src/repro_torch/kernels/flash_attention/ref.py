"""Plain PyTorch versions of the flash-attention kernels.

q [B, S, K, G, hd]; k, v [B, T, K, hd]; q_pos [S]; kv_pos [T] (-1 marks an
empty cache slot); window in tokens (int32 max = global); softcap or None.
mask = causal & in window & kv_pos >= 0. A row with no valid key gives 0,
as the kernel (and the TPU kernel, ``kernel.py:59``) does; the reference's
XLA oracle gives the mean of v there instead.

``flash_attention_ref`` is the function in one pass;
``flash_attention_split_ref`` is the split-KV algorithm of the bf16 decode
kernel: T cut into ``n_split`` contiguous chunks of whole 64-key tiles
(``split_bounds``), a partial (m, l, acc) per chunk, merged in ascending
chunk order.
"""
from __future__ import annotations

import math

import torch

GLOBAL_WINDOW = 2**31 - 1
KV_TILE = 64  # keys per K/V tile of the bf16 kernels
NEG_INF = -1e30


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
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    o = torch.einsum("bqkgt,btkh->bqkgh", p, v.float())
    return (o / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def split_bounds(T: int, n_split: int) -> list[tuple[int, int]]:
    """The key range [start, end) of each of ``n_split`` chunks: whole tiles,
    ceil(tiles / n_split) per chunk; trailing chunks may be empty."""
    n_tiles = -(-T // KV_TILE)
    per = -(-n_tiles // n_split) * KV_TILE
    return [(min(c * per, T), min((c + 1) * per, T)) for c in range(n_split)]


def flash_attention_split_ref(q, k, v, q_pos, kv_pos, window=None,
                              softcap=None, n_split=1):
    """The same function by split-KV: per chunk the running max m, the sum
    l of exp(s - m) and acc = exp(s - m) @ v; merged in ascending chunk
    order with weights exp(m_c - max_c m_c). A chunk where a row sees no
    key gives m = -1e30, l = 0, acc = 0."""
    hd = q.shape[-1]
    mask = attention_mask(q_pos, kv_pos, window)[None, :, None, None, :]
    parts = []
    for lo, hi in split_bounds(k.shape[1], n_split):
        s = torch.einsum("bqkgh,btkh->bqkgt", q.float(),
                         k[:, lo:hi].float()) / math.sqrt(hd)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mk = mask[..., lo:hi]
        s = s.masked_fill(~mk, NEG_INF)
        m = s.amax(-1) if hi > lo else torch.full(s.shape[:-1], NEG_INF,
                                                  device=s.device)
        p = torch.exp(s - m[..., None]) * mk
        acc = torch.einsum("bqkgt,btkh->bqkgh", p, v[:, lo:hi].float())
        parts.append((m, p.sum(-1), acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    acc = l = 0.0
    for m, lc, ac in parts:
        w = torch.exp(m - mx)
        l = l + lc * w
        acc = acc + ac * w[..., None]
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
