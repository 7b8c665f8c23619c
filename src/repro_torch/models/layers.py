"""Core building blocks as plain functions on tensors: Backbone 1's dense
and conv layers, and the LM blocks (embedding, norms, RoPE, softcap, GQA
attention, GLU MLP, cross-entropy).

Conventions follow ``repro/models/layers.py``: dense weights are
``[in_dim, out_dim]`` (forward is ``x @ w``), activations are channels-last,
and a conv weight is stored ``[W, I, O]`` as in XLA's ``WIO`` layout.
``cfg.dtype`` is the activation dtype; norm statistics and softmax run in
fp32. Init draws the reference's shapes and scales from a
``torch.Generator``; it does not reproduce ``jax.random`` (tests carry the
reference's weights over). On the ``meta`` device init draws nothing: it
makes empty tensors of the shapes and dtypes, so a full-width model's tree
costs no memory (``step_fns.abstract_params``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

GLOBAL_WINDOW = 2**31 - 1  # int32 max: "no sliding window"


def _is_meta(device: torch.device | str) -> bool:
    return torch.device(device).type == "meta"


def _randn(shape: tuple[int, ...], generator: torch.Generator | None,
           device: torch.device | str) -> torch.Tensor:
    # draw on the generator's device, so one CPU generator gives the same
    # weights on every device; on meta, draw nothing
    if _is_meta(device):
        return torch.empty(shape, device=device)
    gdev = generator.device if generator is not None else "cpu"
    return torch.randn(shape, generator=generator, device=gdev).to(device)


def normal(generator: torch.Generator | None, shape: tuple[int, ...],
           std: float, device: torch.device | str,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, std^2) in ``dtype``, drawn in fp32 one leading slice at a time so
    a stacked [L, ...] leaf never has an fp32 copy of its own size (on
    meta: the empty tensor)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if _is_meta(device):
        return out
    if len(shape) < 3:
        out.copy_(_randn(shape, generator, device) * std)
        return out
    for i in range(shape[0]):
        out[i].copy_(_randn(shape[1:], generator, device) * std)
    return out


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


def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy; logits [..., V], labels [...] int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# LM blocks
# ---------------------------------------------------------------------------


def embed_init(generator: torch.Generator | None, vocab: int, dim: int,
               device: torch.device | str = "cpu",
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return normal(generator, (vocab, dim), 0.02, device, dtype)


def init_rmsnorm(dim: int, device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros(dim, dtype=dtype, device=device)  # (1 + w) weight


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def init_layernorm(dim: int, device: torch.device | str = "cpu",
                   dtype: torch.dtype = torch.float32) -> dict:
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int


def init_attention(generator: torch.Generator | None, dims: AttnDims,
                   device: torch.device | str = "cpu",
                   dtype: torch.dtype = torch.float32,
                   layers: int | None = None) -> dict:
    """wq/wk/wv/wo, stacked [layers, in, out] when ``layers`` is given."""
    d, h, k, hd = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    lead = () if layers is None else (layers,)
    shapes = {"wq": (d, h * hd), "wk": (d, k * hd), "wv": (d, k * hd),
              "wo": (h * hd, d)}
    return {n: normal(generator, lead + s, 1.0 / math.sqrt(s[0]), device,
                      dtype) for n, s in shapes.items()}


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_positions: torch.Tensor, kv_positions: torch.Tensor,
                       window: int | None, attn_softcap_val: float | None,
                       q_chunk: int) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, chunked over queries:
    the plain attention of the reference's XLA path.

    q [B, S, K, G, hd]; k, v [B, T, K, hd]; q_positions [S] or [B, S];
    kv_positions [T] or [B, T] (-1 marks an empty slot). The [S, T] score
    matrix exists one q_chunk of rows at a time. A row with no valid key
    gets the mean of v, as the reference's softmax over all -1e30 gives.
    """
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    window = GLOBAL_WINDOW if window is None else int(window)
    qp = torch.broadcast_to(q_positions.long(), (B, S))
    kvp = torch.broadcast_to(kv_positions.long(), (B, T))
    k32, v32 = k.float(), v.float()
    outs = []
    for c0 in range(0, S, min(q_chunk, S)):
        qc = q[:, c0:c0 + q_chunk].float() * scale
        qpos = qp[:, c0:c0 + q_chunk]
        s = torch.einsum("bqkgh,btkh->bqkgt", qc, k32)
        s = softcap(s, attn_softcap_val)
        mask = ((qpos[:, :, None] >= kvp[:, None, :])
                & ((qpos[:, :, None] - kvp[:, None, :]) < window)
                & (kvp >= 0)[:, None, :])[:, :, None, None, :]
        p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
        outs.append(torch.einsum("bqkgt,btkh->bqkgh", p, v32).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def init_glu_mlp(generator: torch.Generator | None, d_model: int, d_ff: int,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32,
                 layers: int | None = None) -> dict:
    lead = () if layers is None else (layers,)
    shapes = {"wi": (d_model, d_ff), "wg": (d_model, d_ff),
              "wo": (d_ff, d_model)}
    return {n: normal(generator, lead + s, 1.0 / math.sqrt(s[0]), device,
                      dtype) for n, s in shapes.items()}


_ACTIVATIONS = {
    "silu": F.silu, "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda t: F.gelu(t, approximate="tanh"),
}


def glu_mlp(p: dict, x: torch.Tensor, activation: str = "silu"
            ) -> torch.Tensor:
    return (_ACTIVATIONS[activation](x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
