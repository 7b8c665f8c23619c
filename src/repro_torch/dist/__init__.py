"""Uplink compression codecs for client deltas (int8 with error feedback).

Symmetric int8 per leaf: scale = max|x|/127, q = round(x/scale) clipped to
[-127, 127]. ``torch.round`` rounds half to even, as ``jnp.round`` does, so
the codes equal the reference's wherever x/scale rounds the same in fp32.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_map


def _quantize(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def quantize_int8_ef(tree: Any, error: Any | None = None
                     ) -> tuple[Any, Any, Any]:
    """Int8 quantization with error feedback (client-side state).

    Quantizes ``tree + error`` and returns ``(qtree, scales, residual)``
    where residual = (tree + error) - dequant(qtree) is the next round's
    ``error``; summed over rounds the dequantized uploads telescope to the
    uncompressed stream minus the final residual. Scales are 0-d tensors.
    """
    def q(x, e):
        x32 = x.float() if e is None else x.float() + e
        scale = x32.abs().max().clamp(min=1e-12) / 127.0
        qv = _quantize(x32, scale)
        return qv, scale, x32 - qv.float() * scale

    triples = (tree_map(lambda x: q(x, None), tree) if error is None
               else tree_map(q, tree, error))
    return tuple(tree_map(lambda _, t, i=i: t[i], tree, triples)
                 for i in range(3))


def quantize_int8_stacked(tree: Any, error: Any | None = None
                          ) -> tuple[Any, Any, Any]:
    """Per-client int8 for client-stacked trees ([K, ...] leaves): one
    symmetric scale per (client, leaf), so scale leaves are [K] -- the
    layout ``CohortAggBuffer.push_quantized`` ingests. ``error`` ([K, ...]
    residuals) carries per-client error feedback. Returns
    ``(qtree, scales, residual)`` like ``quantize_int8_ef``."""
    def q(x, e):
        x32 = x.float() if e is None else x.float() + e
        red = tuple(range(1, x32.dim()))
        scale = x32.abs().amax(dim=red).clamp(min=1e-12) / 127.0
        sb = scale.reshape((-1,) + (1,) * (x32.dim() - 1))
        qv = _quantize(x32, sb)
        return qv, scale, x32 - qv.float() * sb

    triples = (tree_map(lambda x: q(x, None), tree) if error is None
               else tree_map(q, tree, error))
    return tuple(tree_map(lambda _, t, i=i: t[i], tree, triples)
                 for i in range(3))


def dequantize_int8_stacked(qtree: Any, scales: Any) -> Any:
    """Inverse of ``quantize_int8_stacked`` ([K] scale leaves broadcast)."""
    return tree_map(
        lambda q, s: q.float() * s.reshape((-1,) + (1,) * (q.dim() - 1)),
        qtree, scales)
