"""Decoder-only transformer LM (dense / MoE / VLM / audio variants).

One config-driven implementation of ``repro/models/transformer.py``: GQA
(or MQA, MHA) attention with RoPE, an optional sliding window, gemma-2's
alternating local/global pattern, softcaps, post-norms and query scale, a
GLU MLP or mixtral's sparse MoE MLP (``models/moe.py``, whose load-balancing
aux loss ``lm_forward`` sums over the layers), llava's patch embeddings
prepended to the token stream, musicgen's parallel codebook streams
(summed embeddings, [.., n_codebooks, vocab] logits), and the serving hooks
(LoRA, the gathered multi-adapter decode, RELIEF fusion masks, ring KV
caches with an optional int8 store).

Parameters keep the reference's tree (``{"base": ..., "lora": ...}``) with
layers stacked ``[L, ...]``; a Python loop over layers takes the place of
``jax.lax.scan``. The reference's ``act_hint`` sharding hints,
``scan_layers`` and ``seq_shard`` have no meaning on one card and are not
ported (the config fields stay). ``cfg.remat`` is honoured where a backward
will run (``layer_remat``): each layer runs under a non-reentrant
``torch.utils.checkpoint``, "dots" saving the outputs of the projections
(``aten.mm``/``addmm``, the reference's
``checkpoint_dots_with_no_batch_dims``) and recomputing the rest, "full"
saving nothing; serving is unchanged. KV caches are updated in place: a
forward or decode step with caches writes the new entries into the given
tensors and returns the same tree. A caller that reuses a fresh cache must
clone it.
"""
from __future__ import annotations

import functools
import math
from collections.abc import Callable
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mdlora import ops as md_ops
from repro_torch.kernels.mdlora import ref as md_ref
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.tree import leaves, tree_map

GLOBAL_WINDOW = L.GLOBAL_WINDOW


def pattern(cfg: ModelConfig) -> tuple[int, tuple[int, ...]]:
    """-> (n_sub, per-sublayer window sizes in tokens)."""
    if cfg.layer_pattern == "alternating":
        return 2, (cfg.sliding_window, GLOBAL_WINDOW)
    if cfg.layer_pattern == "local":
        return 1, (cfg.sliding_window,)
    return 1, (GLOBAL_WINDOW,)


def attn_dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def lora_shapes(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    """LoRA targets -> (in, out) of the projection they adapt."""
    d, hhd = cfg.d_model, cfg.n_heads * cfg.head_dim
    khd = cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (d, hhd), "wk": (d, khd), "wv": (d, khd), "wo": (hhd, d)}
    return {n: s for n, s in shapes.items()
            if n in cfg.lora_targets
            or (n == "wo" and "wo_fusion" in cfg.lora_targets)}


def lora_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.float32 if cfg.lora_dtype == "float32" else cfg.p_dtype()


def init_lora(generator: torch.Generator | None, cfg: ModelConfig,
              device: torch.device | str | None = None,
              shapes: dict[str, tuple[int, int]] | None = None) -> dict:
    """LoRA adapters of every layer, stacked [L, ...]: y += (x @ a) @ b *
    (alpha / rank); a [in, r] ~ N(0, 1/in), b [r, out] = 0. ``shapes``
    (target -> (in, out)) defaults to the attention projections of
    ``lora_shapes``; ``wo``'s a ([n_heads*head_dim, r]) is the fusion
    projection whose input concatenates the head groups -- the RELIEF block
    axis."""
    dev = runtime.resolve_device(device)
    dt, r, n = lora_dtype(cfg), cfg.lora_rank, cfg.n_layers
    shapes = lora_shapes(cfg) if shapes is None else shapes
    return {name: {"a": L.normal(generator, (n, din, r), 1 / math.sqrt(din),
                                 dev, dt),
                   "b": torch.zeros((n, r, dout), dtype=dt, device=dev)}
            for name, (din, dout) in shapes.items()}


def padded_vocab(cfg: ModelConfig) -> int:
    """Embedding tables are padded to a multiple of 128; logits are sliced
    back to the true vocab."""
    v = cfg.vocab * max(cfg.n_codebooks, 1)
    return -(-v // 128) * 128


def init_lm(generator: torch.Generator | None, cfg: ModelConfig,
            device: torch.device | str | None = None,
            with_lora: bool = True) -> dict:
    """Random weights of the reference's shapes and scales. Draws happen on
    the generator's device and move to ``device``: a CUDA generator draws a
    full-width model on the card in seconds; a CPU generator gives the same
    weights on every device."""
    dev = runtime.resolve_device(device)
    dt, d, n = cfg.p_dtype(), cfg.d_model, cfg.n_layers
    layers: dict[str, Any] = {
        "attn": L.init_attention(generator, attn_dims(cfg), dev, dt, n),
        "ln1": torch.zeros((n, d), dtype=dt, device=dev),
        "ln2": torch.zeros((n, d), dtype=dt, device=dev),
    }
    if cfg.family == "moe":
        layers["mlp"] = MOE.init_moe_mlp(generator, d, cfg.d_ff,
                                         cfg.n_experts, dev, dt, n)
    else:
        layers["mlp"] = L.init_glu_mlp(generator, d, cfg.d_ff, dev, dt, n)
    if cfg.post_norms:  # gemma-2 post-attention / post-ffw norms
        layers["ln1b"] = torch.zeros((n, d), dtype=dt, device=dev)
        layers["ln2b"] = torch.zeros((n, d), dtype=dt, device=dev)
    base: dict[str, Any] = {
        "embed": L.embed_init(generator, padded_vocab(cfg), d, dev, dt),
        "layers": layers,
        "final_norm": L.init_rmsnorm(d, dev, dt),
    }
    if not cfg.tie_embeddings:
        base["lm_head"] = L.normal(generator, (d, padded_vocab(cfg)),
                                   1 / math.sqrt(d), dev, dt)
    params = {"base": base}
    if with_lora:
        params["lora"] = {"layers": init_lora(generator, cfg, dev)}
    return params


# ---------------------------------------------------------------------------
# LoRA application
# ---------------------------------------------------------------------------


def lora_delta(lora_p: dict | None, name: str, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor | float:
    if lora_p is None or name not in lora_p:
        return 0.0
    a, b = lora_p[name]["a"], lora_p[name]["b"]
    scale = cfg.lora_alpha / cfg.lora_rank
    return (((x.to(a.dtype) @ a) @ b) * scale).to(x.dtype)


def _proj(base_w: torch.Tensor, lora_p: dict | None, name: str,
          x: torch.Tensor, cfg: ModelConfig, ctx: dict | None = None
          ) -> torch.Tensor:
    """Projection with LoRA. ``ctx`` carries the serving extensions:

    * ``adapter_idx`` [B] -- multi-tenant decode: ``lora_p`` leaves are
      stacked [A, din, r] and each row applies its own adapter through the
      gathered ``mdlora_matmul_multi`` (one call, no per-request weight
      copies). Requires S == 1 (decode).
    * ``fusion_mask`` [B, din] -- RELIEF modality row mask over the fusion
      (``wo``) projection input; zeroes absent-modality blocks.
    * ``lora_impl`` -- "pallas": the op in ``kernels/mdlora`` (the CUDA
      kernel on a card tensor); "xla": its plain version.
    """
    if ctx is not None and ctx.get("adapter_idx") is not None:
        mask = ctx.get("fusion_mask") if name == "wo" else None
        if lora_p is not None and name in lora_p:
            fn = (md_ops.mdlora_matmul_multi
                  if ctx.get("lora_impl", "xla") == "pallas"
                  else md_ref.mdlora_matmul_multi_ref)
            y = fn(x[:, 0], base_w, lora_p[name]["a"], lora_p[name]["b"],
                   ctx["adapter_idx"], mask, cfg.lora_alpha / cfg.lora_rank)
            return y[:, None].to(x.dtype)
        if mask is not None:
            x = x * mask[:, None, :].to(x.dtype)
        return x @ base_w
    if name == "wo" and ctx is not None and ctx.get("fusion_mask") is not None:
        x = x * ctx["fusion_mask"][:, None, :].to(x.dtype)
    if lora_p is None or name not in lora_p:
        return x @ base_w
    return x @ base_w + lora_delta(lora_p, name, x, cfg)


# ---------------------------------------------------------------------------
# transformer block (attention + MLP, with LoRA hooks)
# ---------------------------------------------------------------------------


def _cache_scatter(buf: torch.Tensor, slots: torch.Tensor,
                   val: torch.Tensor) -> None:
    """Write new entries into a ring buffer [B, T, ...] in place.

    slots [S] (shared positions) broadcasts over the batch; slots [B, S]
    (per-row positions, continuous batching) writes each row at its own
    slot."""
    if slots.dim() == 2:
        bidx = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[bidx, slots] = val
    else:
        buf[:, slots] = val


def _pos_scatter(pos_buf: torch.Tensor, slots: torch.Tensor,
                 positions: torch.Tensor) -> None:
    """Update the cache position leaf in place: [T] shared or [B, T]
    per-row. A per-row leaf written with shared 1-D positions (one request's
    prefill into a per-row cache) broadcasts over the batch."""
    if slots.dim() == 2:
        bidx = torch.arange(pos_buf.shape[0], device=pos_buf.device)[:, None]
        pos_buf[bidx, slots] = positions
    elif pos_buf.dim() == 2:
        pos_buf[:, slots] = positions
    else:
        pos_buf[slots] = positions


def _quantize(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and per-(token, head) scales of a [B, S, K, hd] tensor."""
    t32 = t.float()
    scale = t32.abs().amax(-1) / 127.0 + 1e-8
    return torch.round(t32 / scale[..., None]).to(torch.int8), scale


def _attention_lora(p: dict, lp: dict | None, cfg: ModelConfig,
                    x: torch.Tensor, positions: torch.Tensor,
                    kv_cache: dict | None, window: int,
                    ctx: dict | None = None) -> tuple:
    dims = attn_dims(cfg)
    B, S, _ = x.shape
    H, K, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = _proj(p["wq"], lp, "wq", x, cfg, ctx).reshape(B, S, H, hd)
    k = _proj(p["wk"], lp, "wk", x, cfg, ctx).reshape(B, S, K, hd)
    v = _proj(p["wv"], lp, "wv", x, cfg, ctx).reshape(B, S, K, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if cfg.query_scale is not None:
        q = q * (cfg.query_scale * math.sqrt(hd))

    if kv_cache is None:
        kk, vv, kv_pos = k, v, positions
    else:
        slots = positions % kv_cache["k"].shape[1]
        if "k_scale" in kv_cache:  # int8 KV cache, per-(token, head) scales
            (k8, ks), (v8, vs) = _quantize(k), _quantize(v)
            _cache_scatter(kv_cache["k"], slots, k8)
            _cache_scatter(kv_cache["v"], slots, v8)
            _cache_scatter(kv_cache["k_scale"], slots, ks)
            _cache_scatter(kv_cache["v_scale"], slots, vs)
            # dequantize at use (transient, per layer)
            dt = cfg.runtime_dtype()
            kk = (kv_cache["k"].float() * kv_cache["k_scale"][..., None]
                  ).to(dt)
            vv = (kv_cache["v"].float() * kv_cache["v_scale"][..., None]
                  ).to(dt)
        else:
            _cache_scatter(kv_cache["k"], slots, k.to(kv_cache["k"].dtype))
            _cache_scatter(kv_cache["v"], slots, v.to(kv_cache["v"].dtype))
            kk, vv = kv_cache["k"], kv_cache["v"]
        _pos_scatter(kv_cache["pos"], slots, positions)
        kv_pos = kv_cache["pos"]

    qg = q.reshape(B, S, K, H // K, hd)
    if cfg.attn_impl == "pallas" and positions.dim() == 1 and kv_pos.dim() == 1:
        o = fa_ops.flash_attention(qg, kk, vv, positions, kv_pos, window,
                                   cfg.attn_softcap)
    else:
        # plain path; the reference repeats KV to full heads for its TP
        # sharding, the grouped layout computes the same scores
        o = L._chunked_attention(qg, kk, vv, positions, kv_pos, window,
                                 cfg.attn_softcap, cfg.q_chunk)
    o = o.reshape(B, S, H * hd)
    return _proj(p["wo"], lp, "wo", o, cfg, ctx), kv_cache


def _sublayer(p: dict, lp: dict | None, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, cache: dict | None, window: int,
              ctx: dict | None = None) -> tuple:
    h = L.rmsnorm(p["ln1"], x)
    attn_out, new_cache = _attention_lora(p["attn"], lp, cfg, h, positions,
                                          cache, window, ctx)
    if cfg.post_norms:
        attn_out = L.rmsnorm(p["ln1b"], attn_out)
    x = x + attn_out
    h = L.rmsnorm(p["ln2"], x)
    if cfg.family == "moe":
        mlp_out, aux = MOE.moe_mlp(p["mlp"], h, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   activation=cfg.activation,
                                   impl=cfg.moe_impl)
    else:
        mlp_out, aux = L.glu_mlp(p["mlp"], h, cfg.activation), 0.0
    if cfg.post_norms:
        mlp_out = L.rmsnorm(p["ln2b"], mlp_out)
    return x + mlp_out, new_cache, aux


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 patches: torch.Tensor | None = None) -> torch.Tensor:
    """tokens [B, S] (audio: [B, S, n_codebooks], the codebooks' embedding
    streams summed); ``patches`` [B, n_patches, d_model] (llava's stub
    frontend) come first -> [B, (n_patches +) S, d_model]."""
    emb = params["base"]["embed"]
    if cfg.n_codebooks:  # codebook i's ids index rows i*vocab + id
        offs = torch.arange(cfg.n_codebooks, dtype=tokens.dtype,
                            device=tokens.device) * cfg.vocab
        x = F.embedding(tokens + offs, emb).sum(2)
    else:
        x = F.embedding(tokens, emb)
    x = x.to(cfg.runtime_dtype())
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def unembed(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    base = params["base"]
    if cfg.tie_embeddings:
        logits = h @ base["embed"].T.to(h.dtype)
    else:
        logits = h @ base["lm_head"]
    v = cfg.vocab * max(cfg.n_codebooks, 1)
    if logits.shape[-1] != v:  # drop vocab-padding columns
        logits = logits[..., :v]
    logits = L.softcap(logits, cfg.final_softcap)
    if cfg.n_codebooks:
        logits = logits.reshape(*logits.shape[:-1], cfg.n_codebooks,
                                cfg.vocab)
    return logits


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _at(tree: Any, i: int) -> Any:
    return None if tree is None else tree_map(lambda a: a[i], tree)


def _layer_cache(caches: Any, layer: int, n_sub: int) -> dict | None:
    """Views of one layer's cache leaves ([L, ...] or per-sublayer)."""
    if caches is None:
        return None
    if isinstance(caches, dict) and "__per_sub__" in caches:
        return _at(caches["__per_sub__"][layer % n_sub], layer // n_sub)
    return _at(caches, layer)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy of remat "dots": keep the 2-D products
    (the projections, LoRA's included: ``x @ w`` on [B, S, d] runs as one
    ``aten.mm``) and recompute everything else, the batched attention and
    expert products among it -- JAX's ``checkpoint_dots_with_no_batch_dims``.
    """
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _call(fn: Callable, *args: Any) -> Any:
    return fn(*args)


def layer_remat(cfg: ModelConfig, params: dict, x: torch.Tensor,
                caches: Any = None, dots: bool = True) -> Callable:
    """How each layer runs, ``run(layer_fn, *args)``: a plain call, or under
    a per-layer non-reentrant checkpoint when ``cfg.remat`` is "dots" or
    "full" and a backward will run (grad mode on and ``x`` or a parameter
    needs a gradient). "dots" keeps the projections' outputs
    (``_save_dots``) when ``dots``; the recurrent families pass ``dots=False``
    (the reference checkpoints their layers saving nothing). Layers with
    caches never run checkpointed: their in-place cache writes would run
    again in the recompute, so that raises."""
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled() or not (
            x.requires_grad or any(t.requires_grad for t in leaves(params))):
        return _call
    if caches is not None:
        raise ValueError("remat needs a forward without caches: the "
                         "in-place cache writes cannot run checkpointed")
    kw = {"use_reentrant": False}
    if cfg.remat == "dots" and dots:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda fn, *args: checkpoint(fn, *args, **kw)


def _layers(params: dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor, caches: Any, ctx: dict | None
            ) -> tuple:
    """-> (final-norm hidden, the MoE aux loss summed over the layers; 0.0
    for the other families)."""
    n_sub, windows = pattern(cfg)
    base = params["base"]["layers"]
    lora = params.get("lora", {}).get("layers")
    run = layer_remat(cfg, params, x, caches)
    aux = 0.0
    for layer in range(cfg.n_layers):
        x, _, a = run(_sublayer, _at(base, layer), _at(lora, layer), cfg, x,
                      positions, _layer_cache(caches, layer, n_sub),
                      windows[layer % n_sub], ctx)
        aux = aux + a
    return L.rmsnorm(params["base"]["final_norm"], x), aux


def lm_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               patches: torch.Tensor | None = None,
               positions: torch.Tensor | None = None,
               caches: Any = None, skip_unembed: bool = False,
               fusion_mask: torch.Tensor | None = None) -> tuple:
    """-> (logits | final hidden, caches | None, MoE aux loss).

    tokens [B, S] (audio [B, S, n_codebooks]); ``patches`` [B, n_patches,
    d_model] are prepended, and ``positions`` (default arange) cover
    n_patches + S. ``caches`` are written in place and returned.
    ``fusion_mask`` [B, n_heads*head_dim] zeroes absent-modality blocks of
    the fusion (``wo``) projection input, so a masked prefill and decode
    see the same features.
    """
    x = embed_tokens(params, cfg, tokens, patches)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    ctx = None if fusion_mask is None else {"fusion_mask": fusion_mask}
    x, aux = _layers(params, cfg, x, positions, caches, ctx)
    if skip_unembed:
        return x, caches, aux
    return unembed(params, cfg, x), caches, aux


# ---------------------------------------------------------------------------
# KV caches / decode
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, sub: int, max_len: int) -> int:
    _, windows = pattern(cfg)
    return int(min(windows[sub], max_len))


def init_kv_caches(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype | None = None,
                   per_row_pos: bool = False,
                   device: torch.device | str | None = None) -> Any:
    """Per-layer ring-buffer caches, stacked [L, B, T, K, hd], T =
    min(window, max_len), positions -1 (empty).

    When an alternating pattern gives the sublayers different ring sizes the
    caches are ``{"__per_sub__": [sublayer 0, sublayer 1]}``, each stacked
    [L / 2, ...]. ``per_row_pos`` gives the position leaf a batch axis
    ([.., B, T]) so each row can sit at its own depth -- the serving
    engine's layout. ``cfg.kv_quant`` stores int8 codes and fp32 scales.
    """
    dev = runtime.resolve_device(device)
    dtype = dtype or cfg.runtime_dtype()
    n_sub, _ = pattern(cfg)
    K, hd = cfg.n_kv_heads, cfg.head_dim

    def one(n: int, T: int) -> dict:
        kv_dt = torch.int8 if cfg.kv_quant else dtype
        c = {"k": torch.zeros((n, batch, T, K, hd), dtype=kv_dt, device=dev),
             "v": torch.zeros((n, batch, T, K, hd), dtype=kv_dt, device=dev),
             "pos": torch.full((n, batch, T) if per_row_pos else (n, T), -1,
                               dtype=torch.int32, device=dev)}
        if cfg.kv_quant:
            c["k_scale"] = torch.zeros((n, batch, T, K), device=dev)
            c["v_scale"] = torch.zeros((n, batch, T, K), device=dev)
        return c

    rings = [cache_len(cfg, s, max_len) for s in range(n_sub)]
    if len(set(rings)) == 1:  # one ring size: a plain [L, ...] stack
        return one(cfg.n_layers, rings[0])
    return {"__per_sub__": [one(cfg.n_layers // n_sub, T) for T in rings]}


def lm_decode_step(params: dict, cfg: ModelConfig, caches: Any,
                   token: torch.Tensor, pos: Any,
                   adapter_idx: torch.Tensor | None = None,
                   fusion_mask: torch.Tensor | None = None,
                   lora_impl: str = "xla") -> tuple:
    """One-token decode; the caches are written in place and returned.

    token [B, 1] (audio [B, 1, n_codebooks]); pos a scalar (every row at the same depth) or [B] int32
    (per-row depths, continuous batching: caches built with
    ``per_row_pos=True``). ``adapter_idx`` [B] selects each row's adapter
    from [A, ...]-stacked LoRA leaves (gathered multi-tenant decode);
    ``fusion_mask`` [B, n_heads*head_dim] zeroes absent-modality fusion
    blocks per row.
    """
    x = embed_tokens(params, cfg, token)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    ctx = None
    if adapter_idx is not None or fusion_mask is not None:
        ctx = {"adapter_idx": adapter_idx, "fusion_mask": fusion_mask,
               "lora_impl": lora_impl}
    x, _ = _layers(params, cfg, x, positions, caches, ctx)
    return unembed(params, cfg, x), caches
