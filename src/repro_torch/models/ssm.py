"""Mamba-2 (SSD, state-space duality) blocks and LM (arXiv:2405.21060).

The port of ``repro/models/ssm.py``. A prefill or forward runs the chunked
SSD form: intra-chunk (quadratic within a chunk, the dual attention form)
plus the inter-chunk state recurrence. Decode is the O(1) recurrent state
update. ``impl="pallas"`` (``cfg.attn_impl == "pallas"``) sends the chunked
scan to ``kernels/ssd`` (the CUDA kernel on a card tensor, its plain version
on a CPU tensor); "xla" runs the plain version.

Parameters keep the reference's tree with layers stacked ``[L, ...]``; a
Python loop over layers takes the place of ``lax.scan``. Caches are written
in place: a decode step writes the new conv and SSM states into the given
tensors and returns the same tree.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import runtime
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF

# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None,
                impl: str = "xla") -> tuple:
    """Chunked SSD scan.

    x [b, s, h, p] per-head inputs; dt [b, s, h] softplus-ed step sizes;
    A_log [h] log of -A (per-head scalar decay); Bm, Cm [b, s, n] (a single
    group, broadcast over h) -> (y [b, s, h, p], final_state [b, h, p, n]).
    """
    if impl == "pallas":
        return ssd_ops.ssd(x.contiguous(), dt.contiguous(), A_log,
                           Bm.contiguous(), Cm.contiguous(), chunk,
                           initial_state)
    return ssd_ref.ssd_ref(x, dt, A_log, Bm, Cm, chunk, initial_state)


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A_log: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                    ) -> tuple:
    """O(1) recurrent update. state [b, h, p, n]; x [b, h, p]; dt [b, h];
    Bm, Cm [b, n] -> (y [b, h, p] in x's dtype, new_state fp32)."""
    f32 = torch.float32
    decay = torch.exp(-torch.exp(A_log.to(f32)) * dt.to(f32))  # [b, h]
    upd = (dt.to(f32)[..., None] * x.to(f32))[..., None] \
        * Bm.to(f32)[:, None, None, :]
    new_state = state.to(f32) * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.to(f32))
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba-2 mixer (in_proj -> conv -> SSD -> gate -> out_proj)
# ---------------------------------------------------------------------------


def mixer_dims(cfg: ModelConfig) -> dict:
    d_inner = cfg.d_inner or 2 * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim,
                n=cfg.ssm_state, p=cfg.ssm_head_dim)


def init_mamba_mixer(generator: torch.Generator | None, cfg: ModelConfig,
                     device: torch.device | str, dtype: torch.dtype,
                     layers: int, out_proj: bool = True) -> dict:
    """The mixer's weights, stacked [layers, ...]: in_proj [d, 2 d_inner +
    2 n + h], the depthwise conv w [k, conv_dim] and b, A_log, D, dt_bias
    (fp32), the gate's rmsnorm and out_proj [d_inner, d] (left out for
    hymba's headless mixer)."""
    dm = mixer_dims(cfg)
    d, k, n = cfg.d_model, cfg.conv_kernel, layers
    d_in_proj = 2 * dm["d_inner"] + 2 * dm["n"] + dm["n_heads"]
    a_log = torch.log(torch.linspace(1.0, 16.0, dm["n_heads"],
                                     device=device))
    p = {
        "in_proj": L.normal(generator, (n, d, d_in_proj), 1 / math.sqrt(d),
                            device, dtype),
        "conv": {"w": L.normal(generator, (n, k, dm["conv_dim"]),
                               1 / math.sqrt(k), device, dtype),
                 "b": torch.zeros((n, dm["conv_dim"]), dtype=dtype,
                                  device=device)},
        "A_log": a_log.expand(n, -1).contiguous(),
        "D": torch.ones((n, dm["n_heads"]), device=device),
        "dt_bias": torch.zeros((n, dm["n_heads"]), device=device),
        "norm": torch.zeros((n, dm["d_inner"]), dtype=dtype, device=device),
    }
    if out_proj:
        p["out_proj"] = L.normal(generator, (n, dm["d_inner"], d),
                                 1 / math.sqrt(dm["d_inner"]), device, dtype)
    return p


def _causal_depthwise_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                           conv_state: torch.Tensor | None = None) -> tuple:
    """x [B, S, C]; w [k, C] depthwise causal -> (silu(conv + b), the last
    k - 1 inputs as the new conv state)."""
    k, S = w.shape[0], x.shape[1]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S + k - 1, C]
    y = xp[:, 0:S] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(y + b), new_state


def mamba_mixer(p: dict, cfg: ModelConfig, x: torch.Tensor,
                ssm_cache: dict | None = None,
                return_fused_input: bool = False,
                lp: dict | None = None) -> tuple:
    """x [B, S, d] -> (y [B, S, d], cache).

    ``ssm_cache`` = {"conv": [B, k-1, conv_dim], "state": [B, h, p, n]} for
    decode (S = 1): the new states are written into it in place and it is
    returned. Without it the chunked scan runs and the returned cache holds
    the new conv state and the final SSM state. ``return_fused_input``
    returns the hidden before out_proj (hymba's fusion input).
    """
    dm = mixer_dims(cfg)
    B_, S, _ = x.shape
    di, n, h = dm["d_inner"], dm["n"], dm["n_heads"]
    zxbcdt = x @ p["in_proj"] + TF.lora_delta(lp, "in_proj", x, cfg)
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_state = None if ssm_cache is None else ssm_cache["conv"]
    conv_out, new_conv = _causal_depthwise_conv(p["conv"]["w"],
                                                p["conv"]["b"], conv_in,
                                                conv_state)
    xin, Bm, Cm = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B, S, h], fp32
    xh = xin.reshape(B_, S, h, dm["p"])

    if ssm_cache is None:
        y, final_state = ssd_chunked(
            xh, dt, p["A_log"], Bm, Cm, min(cfg.ssd_chunk, S),
            impl="pallas" if cfg.attn_impl == "pallas" else "xla")
        cache = {"conv": new_conv, "state": final_state}
    else:
        yh, final_state = ssd_decode_step(ssm_cache["state"], xh[:, 0],
                                          dt[:, 0], p["A_log"], Bm[:, 0],
                                          Cm[:, 0])
        y = yh[:, None]
        ssm_cache["conv"].copy_(new_conv)
        ssm_cache["state"].copy_(final_state)
        cache = ssm_cache
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, di)
    y = L.rmsnorm(p["norm"], y) * F.silu(z)
    if return_fused_input:
        return y, cache
    return y @ p["out_proj"] + TF.lora_delta(lp, "out_proj", y, cfg), cache


# ---------------------------------------------------------------------------
# Mamba-2 LM
# ---------------------------------------------------------------------------


def lora_shapes(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    """LoRA on the mixer's in/out projections (the paper's technique on an
    SSM arch: channel groups of in_proj are the block analogue)."""
    dm = mixer_dims(cfg)
    d_in_proj = 2 * dm["d_inner"] + 2 * dm["n"] + dm["n_heads"]
    return {"in_proj": (cfg.d_model, d_in_proj),
            "out_proj": (dm["d_inner"], cfg.d_model)}


def init_mamba_lora(generator: torch.Generator | None, cfg: ModelConfig,
                    device: torch.device | str | None = None) -> dict:
    return TF.init_lora(generator, cfg, device, lora_shapes(cfg))


def init_mamba_lm(generator: torch.Generator | None, cfg: ModelConfig,
                  device: torch.device | str | None = None,
                  with_lora: bool = True) -> dict:
    """Random weights of the reference's shapes and scales, drawn on the
    generator's device (see ``transformer.init_lm``)."""
    dev = runtime.resolve_device(device)
    dt, n = cfg.p_dtype(), cfg.n_layers
    params = {"base": {
        "embed": L.embed_init(generator, TF.padded_vocab(cfg), cfg.d_model,
                              dev, dt),
        "layers": {"mixer": init_mamba_mixer(generator, cfg, dev, dt, n),
                   "ln": torch.zeros((n, cfg.d_model), dtype=dt,
                                     device=dev)},
        "final_norm": L.init_rmsnorm(cfg.d_model, dev, dt),
    }}
    if with_lora:
        params["lora"] = {"layers": init_mamba_lora(generator, cfg, dev)}
    return params


def embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor
          ) -> torch.Tensor:
    return F.embedding(tokens, params["base"]["embed"]).to(
        cfg.runtime_dtype())


def _block(p: dict, lp: dict | None, cfg: ModelConfig, x: torch.Tensor
           ) -> torch.Tensor:
    """One pre-norm residual layer of the full-sequence forward."""
    y, _ = mamba_mixer(p["mixer"], cfg, L.rmsnorm(p["ln"], x), lp=lp)
    return x + y


def mamba_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  skip_unembed: bool = False) -> tuple:
    """-> (logits | final hidden, None, aux loss 0.0). Under a backward each
    layer runs checkpointed whenever ``cfg.remat != "none"``, saving nothing
    (``TF.layer_remat``), as the reference's ``jax.checkpoint``."""
    x = embed(params, cfg, tokens)
    base = params["base"]["layers"]
    lora = params.get("lora", {}).get("layers")
    run = TF.layer_remat(cfg, params, x, dots=False)
    for layer in range(cfg.n_layers):
        x = run(_block, TF._at(base, layer), TF._at(lora, layer), cfg, x)
    x = L.rmsnorm(params["base"]["final_norm"], x)
    if skip_unembed:
        return x, None, 0.0
    return TF.unembed(params, cfg, x), None, 0.0


def init_mamba_caches(cfg: ModelConfig, batch: int, max_len: int = 0,
                      dtype: torch.dtype | None = None,
                      device: torch.device | str | None = None) -> dict:
    """Positionless recurrent state, stacked [L, B, ...]: the conv's last
    k - 1 inputs and the SSM state (fp32)."""
    dev = runtime.resolve_device(device)
    dm = mixer_dims(cfg)
    dtype = dtype or cfg.runtime_dtype()
    n = cfg.n_layers
    return {
        "conv": torch.zeros((n, batch, cfg.conv_kernel - 1, dm["conv_dim"]),
                            dtype=dtype, device=dev),
        "state": torch.zeros((n, batch, dm["n_heads"], dm["p"], dm["n"]),
                             device=dev),
    }


def mamba_decode_step(params: dict, cfg: ModelConfig, caches: dict,
                      token: torch.Tensor, pos: Any) -> tuple:
    """One-token decode; the caches are written in place and returned.
    ``pos`` is not read: the state carries the position."""
    x = embed(params, cfg, token)
    base = params["base"]["layers"]
    lora = params.get("lora", {}).get("layers")
    for layer in range(cfg.n_layers):
        p, lp = TF._at(base, layer), TF._at(lora, layer)
        y, _ = mamba_mixer(p["mixer"], cfg, L.rmsnorm(p["ln"], x),
                           ssm_cache=TF._at(caches, layer), lp=lp)
        x = x + y
    x = L.rmsnorm(params["base"]["final_norm"], x)
    return TF.unembed(params, cfg, x), caches
