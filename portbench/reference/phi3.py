"""Plain PyTorch reference of a Phi-3 decoder (arXiv:2404.14219; the
``microsoft/Phi-3-medium-4k-instruct`` config.json) with one RELIEF
modality-block adapter per request, independent of the program.

Each layer: x += Wo(attn(RoPE(Wq h), RoPE(Wk h), Wv h)), h = RMSNorm(x);
x += W2(SiLU(Wg h) * Wu h), h = RMSNorm(x); grouped-query causal
attention; RoPE on the two halves of each head (rotate-half). RMSNorm
weights are stored as w with scale (1 + w). A request's adapter adds
((h @ a) @ b) * alpha/r to the Q and V projections and, on the fusion
projection Wo, zeroes the input columns of the absent modality blocks (one
block per KV head group) before both the base and the adapter product.

``logits`` runs in fp32 with TF32 off, layer by layer, upcasting one
layer's weights at a time. ``weight_precision="fp8"`` is the control one
step below the bf16 the configuration serves in: every projection weight
quantized to float8 e4m3 with one scale per output column.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 128) * 128


def param_specs(m: dict) -> list[tuple[tuple, tuple[int, ...], float]]:
    """(path, shape, std) of the base weights, std 0 for zeros: embedding
    N(0, 0.02^2), projections N(0, 1/fan_in), norm weights 0."""
    d, L, ff = m["hidden_size"], m["num_hidden_layers"], m["intermediate_size"]
    H, K, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    V = padded_vocab(m["vocab_size"])
    b = ("base",)
    lay = b + ("layers",)
    return [
        (b + ("embed",), (V, d), 0.02),
        (lay + ("attn", "wq"), (L, d, H * hd), 1 / math.sqrt(d)),
        (lay + ("attn", "wk"), (L, d, K * hd), 1 / math.sqrt(d)),
        (lay + ("attn", "wv"), (L, d, K * hd), 1 / math.sqrt(d)),
        (lay + ("attn", "wo"), (L, H * hd, d), 1 / math.sqrt(H * hd)),
        (lay + ("ln1",), (L, d), 0.0),
        (lay + ("ln2",), (L, d), 0.0),
        (lay + ("mlp", "wg"), (L, d, ff), 1 / math.sqrt(d)),
        (lay + ("mlp", "wi"), (L, d, ff), 1 / math.sqrt(d)),
        (lay + ("mlp", "wo"), (L, ff, d), 1 / math.sqrt(ff)),
        (b + ("final_norm",), (d,), 0.0),
        (b + ("lm_head",), (d, V), 1 / math.sqrt(d)),
    ]


def block_mask(m: dict, blocks_on: torch.Tensor) -> torch.Tensor:
    """[n_kv_heads] 0/1 -> [n_heads * head_dim] column mask of the fusion
    input (K-major: block k holds the k-th KV group's query heads)."""
    g = m["num_attention_heads"] // m["num_key_value_heads"]
    return blocks_on.float().repeat_interleave(g * m["head_dim"])


def _fp8(w: torch.Tensor) -> torch.Tensor:
    s = w.abs().amax(dim=0, keepdim=True).clamp(min=1e-12) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def _no_tf32():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _rmsnorm(w, x, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, theta):
    """x [S, n, hd] at positions 0..S-1."""
    S, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@torch.no_grad()
def logits(m: dict, base: dict, seqs: list[torch.Tensor],
           adapters: list[dict], masks: list[torch.Tensor],
           positions: list[torch.Tensor], weight_precision: str = "fp32"
           ) -> list[torch.Tensor]:
    """For each sequence [S] (tokens), its adapter {target: (a [L, in, r],
    b [L, r, out])}, its [n_heads*head_dim] fusion mask and the positions
    whose next-token logits are wanted -> [len(positions), vocab] fp32.

    ``base``: flat {path: tensor} as ``param_specs`` lays it out."""
    d, L = m["hidden_size"], m["num_hidden_layers"]
    H, K, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    eps, theta, V = m["rms_norm_eps"], m["rope_theta"], m["vocab_size"]
    scale = m["lora_alpha"] / m["lora_rank"]
    q8 = _fp8 if weight_precision == "fp8" else (lambda w: w)
    dev = base[("base", "embed")].device
    with _no_tf32():
        hs = [base[("base", "embed")][s.to(dev).long()].float() for s in seqs]
        for i in range(L):
            def w(*k, i=i):
                return base[("base", "layers") + k][i].float()
            wq, wk, wv, wo = (q8(w("attn", n)) for n in ("wq", "wk", "wv", "wo"))
            wg, wi, w2 = (q8(w("mlp", n)) for n in ("wg", "wi", "wo"))
            ln1, ln2 = w("ln1"), w("ln2")
            for j, x in enumerate(hs):
                S = x.shape[0]
                ad = adapters[j]

                def lo(t, h, ad=ad):
                    a, b = ad[t]
                    return (h @ a[i].float()) @ b[i].float() * scale

                h = _rmsnorm(ln1, x, eps)
                q = (h @ wq + lo("wq", h)).reshape(S, H, hd)
                k = (h @ wk).reshape(S, K, hd)
                v = (h @ wv + lo("wv", h)).reshape(S, K, hd)
                q, k = _rope(q, theta), _rope(k, theta)
                q = q.reshape(S, K, H // K, hd)
                s = torch.einsum("qkgh,tkh->kgqt", q, k) / math.sqrt(hd)
                causal = torch.ones(S, S, dtype=torch.bool,
                                    device=dev).tril()
                p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
                o = torch.einsum("kgqt,tkh->qkgh", p, v).reshape(S, H * hd)
                om = o * masks[j].to(dev)
                x = x + om @ wo + lo("wo", om)
                h = _rmsnorm(ln2, x, eps)
                x = x + (F.silu(h @ wg) * (h @ wi)) @ w2
                hs[j] = x
        fn = base[("base", "final_norm")].float()
        head = q8(base[("base", "lm_head")].float())[:, :V]
        return [_rmsnorm(fn, x[pos.to(dev)], eps) @ head
                for x, pos in zip(hs, positions)]
