"""The layers Backbone 1 needs, as plain functions on tensors.

Conventions follow ``repro/models/layers.py``: dense weights are
``[in_dim, out_dim]`` (forward is ``x @ w``), activations are channels-last,
and a conv weight is stored ``[W, I, O]`` as in XLA's ``WIO`` layout. Init
draws the reference's shapes and scales from a ``torch.Generator``; it does
not reproduce ``jax.random`` (tests carry the reference's weights over).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _randn(shape: tuple[int, ...], generator: torch.Generator | None,
           device: torch.device | str) -> torch.Tensor:
    # draw on the CPU so one seed gives the same weights on every device
    return torch.randn(shape, generator=generator).to(device)


def dense_init(generator: torch.Generator | None, in_dim: int, out_dim: int,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return _randn((in_dim, out_dim), generator, device) / math.sqrt(in_dim)


def init_conv1d(generator: torch.Generator | None, in_ch: int, out_ch: int,
                ksize: int, device: torch.device | str = "cpu") -> dict:
    w = _randn((ksize, in_ch, out_ch), generator, device)
    return {"w": w / math.sqrt(in_ch * ksize),
            "b": torch.zeros(out_ch, device=device)}


def conv1d(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: [B, T, C_in] -> [B, T', C_out] with XLA ``SAME`` padding.

    SAME pads (total // 2, total - total // 2) around the time axis, which is
    asymmetric for kernel 5 / stride 2 (T=256 pads (1, 2)), so the padding
    is explicit and the convolution itself unpadded; ``nn.Conv1d(padding=2)``
    would shift every output by one sample.
    """
    w = p["w"]  # [W, I, O]
    k, T = w.shape[0], x.shape[-2]
    t_out = -(-T // stride)
    total = max((t_out - 1) * stride + k - T, 0)
    xt = F.pad(x.transpose(-1, -2), (total // 2, total - total // 2))
    y = F.conv1d(xt, w.permute(2, 1, 0), stride=stride)
    return y.transpose(-1, -2) + p["b"]


def cross_entropy_logits(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; logits [..., V], labels [...] int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()
