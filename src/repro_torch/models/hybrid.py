"""Hymba-style hybrid blocks: attention heads and Mamba (SSD) heads in
parallel on the same normalized input (arXiv:2411.13676).

The port of ``repro/models/hybrid.py``. The two outputs are concatenated and
fused by one output projection ``wo``, whose input axis is the ordered
concatenation of the two head families: the paper's modality-aligned column
blocks (Eq. 1), block 0 = attention features, block 1 = SSD features. The
engine's per-client fusion masks and the gathered ``wo`` act on that axis.
The SSD branch carries no LoRA. The attention is the plain chunked
attention, as in the reference (per-row positions in the engine). Meta
tokens are out of scope, as in the reference.

Caches are written in place and returned: ring KV caches ``T = min(window,
max_len)`` beside the conv and SSM states.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import runtime
from repro_torch.models import layers as L
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as TF


def hybrid_dims(cfg: ModelConfig) -> dict:
    dm = SM.mixer_dims(cfg)
    attn_out = cfg.n_heads * cfg.head_dim
    return dm | {"attn_out": attn_out, "fused": attn_out + dm["d_inner"]}


def init_mamba_headless(generator: torch.Generator | None, cfg: ModelConfig,
                        device: torch.device | str, dtype: torch.dtype,
                        layers: int) -> dict:
    """Mamba mixer without its own out_proj (fusion happens in wo)."""
    return SM.init_mamba_mixer(generator, cfg, device, dtype, layers,
                               out_proj=False)


def init_hybrid_layer(generator: torch.Generator | None, cfg: ModelConfig,
                      device: torch.device | str, dtype: torch.dtype,
                      layers: int) -> dict:
    """Every layer's weights, stacked [layers, ...]."""
    dm = hybrid_dims(cfg)
    d, h, k, hd, n = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, layers)
    std = 1 / math.sqrt(d)
    return {
        "attn": {"wq": L.normal(generator, (n, d, h * hd), std, device,
                                dtype),
                 "wk": L.normal(generator, (n, d, k * hd), std, device,
                                dtype),
                 "wv": L.normal(generator, (n, d, k * hd), std, device,
                                dtype)},
        "mamba": init_mamba_headless(generator, cfg, device, dtype, n),
        # fusion projection: input = [attn_out ; ssm_out] (RELIEF block axis)
        "wo": L.normal(generator, (n, dm["fused"], d),
                       1 / math.sqrt(dm["fused"]), device, dtype),
        "mlp": L.init_glu_mlp(generator, d, cfg.d_ff, device, dtype, n),
        "ln1": torch.zeros((n, d), dtype=dtype, device=device),
        "ln2": torch.zeros((n, d), dtype=dtype, device=device),
    }


def _attn_heads(p: dict, lp: dict | None, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: dict | None, window: int,
                ctx: dict | None = None) -> tuple:
    B, Sq, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = TF._proj(p["wq"], lp, "wq", x, cfg, ctx).reshape(B, Sq, H, hd)
    k = TF._proj(p["wk"], lp, "wk", x, cfg, ctx).reshape(B, Sq, K, hd)
    v = TF._proj(p["wv"], lp, "wv", x, cfg, ctx).reshape(B, Sq, K, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        kk, vv, kv_pos = k, v, positions
    else:
        slots = positions % cache["k"].shape[1]
        TF._cache_scatter(cache["k"], slots, k.to(cache["k"].dtype))
        TF._cache_scatter(cache["v"], slots, v.to(cache["v"].dtype))
        TF._pos_scatter(cache["pos"], slots, positions)
        kk, vv, kv_pos = cache["k"], cache["v"], cache["pos"]

    qg = q.reshape(B, Sq, K, H // K, hd)
    o = L._chunked_attention(qg, kk, vv, positions, kv_pos, window,
                             cfg.attn_softcap, cfg.q_chunk)
    return o.reshape(B, Sq, H * hd), cache


def hybrid_layer(p: dict, lp: dict | None, cfg: ModelConfig,
                 x: torch.Tensor, positions: torch.Tensor,
                 caches: dict | None, window: int,
                 ctx: dict | None = None) -> tuple:
    """caches = {"attn": ring KV cache, "ssm": {"conv", "state"}} or None;
    written in place."""
    h = L.rmsnorm(p["ln1"], x)
    attn_cache = None if caches is None else caches["attn"]
    ssm_cache = None if caches is None else caches["ssm"]
    attn_out, _ = _attn_heads(p["attn"], lp, cfg, h, positions, attn_cache,
                              window, ctx)
    ssm_out, _ = SM.mamba_mixer(p["mamba"], cfg, h, ssm_cache=ssm_cache,
                                return_fused_input=True)
    fused = torch.cat([attn_out, ssm_out], dim=-1)
    x = x + TF._proj(p["wo"], lp, "wo", fused, cfg, ctx)
    x = x + L.glu_mlp(p["mlp"], L.rmsnorm(p["ln2"], x), cfg.activation)
    return x, caches


# ---------------------------------------------------------------------------
# LM wrapper
# ---------------------------------------------------------------------------


def lora_shapes(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    """LoRA targets -> (in, out); ``wo_fusion`` adapts the fusion ``wo``,
    whose input is the fused [attn_out ; d_inner] axis."""
    dm = hybrid_dims(cfg)
    d = cfg.d_model
    shapes = {"wq": (d, cfg.n_heads * cfg.head_dim),
              "wv": (d, cfg.n_kv_heads * cfg.head_dim),
              "wo": (dm["fused"], d)}
    return {n: s for n, s in shapes.items()
            if n in cfg.lora_targets
            or (n == "wo" and "wo_fusion" in cfg.lora_targets)}


def init_hybrid_lora(generator: torch.Generator | None, cfg: ModelConfig,
                     device: torch.device | str | None = None) -> dict:
    return TF.init_lora(generator, cfg, device, lora_shapes(cfg))


def init_hybrid_lm(generator: torch.Generator | None, cfg: ModelConfig,
                   device: torch.device | str | None = None,
                   with_lora: bool = True) -> dict:
    """Random weights of the reference's shapes and scales, drawn on the
    generator's device (see ``transformer.init_lm``)."""
    dev = runtime.resolve_device(device)
    dt = cfg.p_dtype()
    params = {"base": {
        "embed": L.embed_init(generator, TF.padded_vocab(cfg), cfg.d_model,
                              dev, dt),
        "layers": init_hybrid_layer(generator, cfg, dev, dt, cfg.n_layers),
        "final_norm": L.init_rmsnorm(cfg.d_model, dev, dt),
    }}
    if with_lora:
        params["lora"] = {"layers": init_hybrid_lora(generator, cfg, dev)}
    return params


def _window(cfg: ModelConfig) -> int:
    return (cfg.sliding_window if cfg.sliding_window is not None
            else L.GLOBAL_WINDOW)


def _layers(params: dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor, caches: Any, ctx: dict | None
            ) -> torch.Tensor:
    base = params["base"]["layers"]
    lora = params.get("lora", {}).get("layers")
    run = TF.layer_remat(cfg, params, x, caches, dots=False)
    for layer in range(cfg.n_layers):
        x, _ = run(hybrid_layer, TF._at(base, layer), TF._at(lora, layer),
                   cfg, x, positions, TF._at(caches, layer), _window(cfg),
                   ctx)
    return L.rmsnorm(params["base"]["final_norm"], x)


def hybrid_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   skip_unembed: bool = False) -> tuple:
    """-> (logits | final hidden, None, aux loss 0.0). Under a backward each
    layer runs checkpointed whenever ``cfg.remat != "none"``, saving nothing
    (``TF.layer_remat``), as the reference's ``jax.checkpoint``."""
    x = SM.embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = _layers(params, cfg, x, positions, None, None)
    if skip_unembed:
        return x, None, 0.0
    return TF.unembed(params, cfg, x), None, 0.0


def init_hybrid_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype: torch.dtype | None = None,
                       per_row_pos: bool = False,
                       device: torch.device | str | None = None) -> dict:
    """Ring KV caches [L, B, T, K, hd] with T = min(window, max_len) and
    positions -1 (empty; [L, B, T] with ``per_row_pos``), beside the SSM
    caches of ``ssm.init_mamba_caches``."""
    dev = runtime.resolve_device(device)
    dtype = dtype or cfg.runtime_dtype()
    T = int(min(_window(cfg), max_len))
    n, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {
        "attn": {"k": torch.zeros((n, batch, T, K, hd), dtype=dtype,
                                  device=dev),
                 "v": torch.zeros((n, batch, T, K, hd), dtype=dtype,
                                  device=dev),
                 "pos": torch.full((n, batch, T) if per_row_pos else (n, T),
                                   -1, dtype=torch.int32, device=dev)},
        "ssm": SM.init_mamba_caches(cfg, batch, dtype=dtype, device=dev),
    }


def hybrid_decode_step(params: dict, cfg: ModelConfig, caches: dict,
                       token: torch.Tensor, pos: Any,
                       adapter_idx: torch.Tensor | None = None,
                       fusion_mask: torch.Tensor | None = None,
                       lora_impl: str = "xla") -> tuple:
    """One-token decode; the caches are written in place and returned.
    ``pos`` a scalar or [B] (per-row depths); ``adapter_idx`` [B] picks each
    row's adapter from [A, ...]-stacked LoRA leaves; ``fusion_mask``
    [B, attn_out + d_inner] zeroes absent blocks of the fusion input."""
    x = SM.embed(params, cfg, token)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    ctx = None
    if adapter_idx is not None or fusion_mask is not None:
        ctx = {"adapter_idx": adapter_idx, "fusion_mask": fusion_mask,
               "lora_impl": lora_impl}
    x = _layers(params, cfg, x, positions, caches, ctx)
    return TF.unembed(params, cfg, x), caches
