"""Family-dispatching model API -- the entry point training and serving
use.

  init_model(generator, cfg, device)     -> params {"base": ..., "lora": ...}
  forward(params, cfg, batch)            -> (logits, aux_loss)
  loss_fn(params, cfg, batch)            -> scalar loss
  init_caches(cfg, batch, max_len, ...)  -> decode caches
  decode_step(params, cfg, caches, token, pos) -> (logits, caches)
  prefill_with_cache(params, cfg, caches, tokens) -> (last logits, caches)
  lora_shapes(cfg), init_lora(generator, cfg, device) -> the LoRA targets

The transformer families (dense, moe, vlm, audio) dispatch to
``models/transformer.py``, ``ssm`` to ``models/ssm.py`` (mamba2) and
``hybrid`` to ``models/hybrid.py`` (hymba). Caches are written in place and
returned.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as TF
from repro_torch.tree import leaves

_TF_FAMILIES = ("dense", "moe", "vlm", "audio")
_RECURRENT = ("ssm", "hybrid")


def _family(cfg: ModelConfig) -> str:
    if cfg.family in _TF_FAMILIES or cfg.family in _RECURRENT:
        return cfg.family
    raise ValueError(f"unknown family {cfg.family}")


def init_model(generator: torch.Generator | None, cfg: ModelConfig,
               device: torch.device | str | None = None,
               with_lora: bool = True) -> dict:
    init = {"ssm": SM.init_mamba_lm, "hybrid": HY.init_hybrid_lm}.get(
        _family(cfg), TF.init_lm)
    return init(generator, cfg, device, with_lora)


def forward_hidden(params: dict, cfg: ModelConfig, batch: dict) -> tuple:
    """Forward up to the final norm (pre-unembed); prefill unembeds only
    the last position. For ssm and hybrid with ``cfg.attn_impl ==
    "pallas"`` this is the call that runs the SSD kernel."""
    family = _family(cfg)
    if family == "ssm":
        return SM.mamba_forward(params, cfg, batch["tokens"],
                                skip_unembed=True)
    if family == "hybrid":
        return HY.hybrid_forward(params, cfg, batch["tokens"],
                                 skip_unembed=True)
    return TF.lm_forward(params, cfg, batch["tokens"],
                         patches=batch.get("patches"), skip_unembed=True)


def forward(params: dict, cfg: ModelConfig, batch: dict) -> tuple:
    h, _, aux = forward_hidden(params, cfg, batch)
    return TF.unembed(params, cfg, h), aux


def chunked_ce(params: dict, cfg: ModelConfig, h: torch.Tensor,
               labels: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """CE over the vocab one sequence chunk at a time: the [B, S, V] logits
    transient shrinks to [B, S / n_chunks, V]. The mean of the chunks'
    mean CEs, summed in chunk order from 0 as the reference's scan sums
    them. labels [B, S] (audio [B, S, n_codebooks])."""
    S = h.shape[1]
    if S % n_chunks:
        raise ValueError(f"sequence {S} not divisible by {n_chunks} chunks")
    c = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    # split, not slices: the gradient is one concatenation rather than a
    # zero-padded [B, S, d] per chunk (which DTensor would also replicate)
    for hc, lc in zip(h.split(c, dim=1), labels.split(c, dim=1)):
        logits = TF.unembed(params, cfg, hc)
        total = total + L.cross_entropy_logits(logits, lc)
    return total / n_chunks


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token CE + ``aux_weight`` x the MoE load-balancing aux
    loss. ``batch``: tokens, labels ([B, S]; audio [B, S, n_codebooks]) and,
    for vlm, ``patches`` [B, n_patches, d_model], whose positions carry no
    loss (the CE runs over the text positions after them). The attention
    families with ``cfg.loss_chunks > 1`` take the CE by ``chunked_ce``."""
    labels = batch["labels"]
    patches = batch.get("patches")
    n_patch = 0 if patches is None else patches.shape[1]
    if cfg.loss_chunks > 1 and _family(cfg) in _TF_FAMILIES:
        h, _, aux = forward_hidden(params, cfg, batch)
        return chunked_ce(params, cfg, h[:, n_patch:], labels,
                          cfg.loss_chunks) + aux_weight * aux
    logits, aux = forward(params, cfg, batch)
    return L.cross_entropy_logits(logits[:, n_patch:], labels) \
        + aux_weight * aux


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                per_row_pos: bool = False,
                device: torch.device | str | None = None) -> Any:
    """``per_row_pos`` gives every batch row its own cache position leaf so
    rows can sit at different sequence depths (continuous batching); the
    ssm family's state is positionless."""
    family = _family(cfg)
    if family == "ssm":
        return SM.init_mamba_caches(cfg, batch, max_len, device=device)
    if family == "hybrid":
        return HY.init_hybrid_caches(cfg, batch, max_len,
                                     per_row_pos=per_row_pos, device=device)
    return TF.init_kv_caches(cfg, batch, max_len, per_row_pos=per_row_pos,
                             device=device)


def decode_step(params: dict, cfg: ModelConfig, caches: Any,
                token: torch.Tensor, pos: Any,
                adapter_idx: torch.Tensor | None = None,
                fusion_mask: torch.Tensor | None = None,
                lora_impl: str = "xla") -> tuple:
    """One decode step. ``pos`` is a scalar (all rows at the same depth) or
    [B] (per-row depths; needs ``init_caches(per_row_pos=True)``).
    ``adapter_idx`` [B] selects per-row adapters from [A, ...]-stacked LoRA
    leaves; ``fusion_mask`` [B, fusion_dim] zeroes absent-modality blocks of
    the fusion projection input."""
    family = _family(cfg)
    if family == "ssm":
        if adapter_idx is not None or fusion_mask is not None:
            raise ValueError("ssm family has no fusion projection; "
                             "multi-adapter decode is not supported")
        return SM.mamba_decode_step(params, cfg, caches, token, pos)
    step = HY.hybrid_decode_step if family == "hybrid" else TF.lm_decode_step
    return step(params, cfg, caches, token, pos, adapter_idx=adapter_idx,
                fusion_mask=fusion_mask, lora_impl=lora_impl)


def fusion_block_dims(cfg: ModelConfig) -> tuple[int, ...]:
    """Modality-aligned column blocks of the fusion (``wo``) input axis.

    hybrid: (attention features, SSD features), the RELIEF Eq. 1 layout.
    Attention families: one block per KV group (the concatenated-head axis
    is K-major after the [B, S, K, G, hd] reshape), i.e. head-group
    granularity.
    """
    family = _family(cfg)
    if family == "hybrid":
        dm = HY.hybrid_dims(cfg)
        return (dm["attn_out"], dm["d_inner"])
    if family == "ssm":
        raise ValueError("ssm has no fusion projection")
    g = cfg.n_heads // cfg.n_kv_heads
    return (g * cfg.head_dim,) * cfg.n_kv_heads


def lora_shapes(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    """The family's LoRA targets -> (in, out) of the projection each
    adapts; every LoRA tree is {target: {"a": [L, in, r], "b": [L, r,
    out]}}."""
    return {"ssm": SM.lora_shapes, "hybrid": HY.lora_shapes}.get(
        _family(cfg), TF.lora_shapes)(cfg)


def init_lora(generator: torch.Generator | None, cfg: ModelConfig,
              device: torch.device | str | None = None) -> dict:
    """A fresh adapter: ``params["lora"]["layers"]`` of the family."""
    return TF.init_lora(generator, cfg, device, lora_shapes(cfg))


def _min_ring(caches: Any) -> int:
    if isinstance(caches, dict) and "__per_sub__" in caches:
        return min(c["k"].shape[2] for c in caches["__per_sub__"])
    return caches["k"].shape[2]


def prefill_with_cache(params: dict, cfg: ModelConfig, caches: Any,
                       tokens: torch.Tensor,
                       patches: torch.Tensor | None = None,
                       fusion_mask: torch.Tensor | None = None) -> tuple:
    """Prefill ``tokens`` [B, S] (audio [B, S, n_codebooks]) into fresh
    ``caches`` (written in place); -> (last-position logits [B, 1, V]
    (audio [B, 1, n_codebooks, V]), caches).

    Attention families run one chunked forward over the whole prompt when
    every cache ring holds it; ``patches`` [B, n_patches, d_model] (vlm)
    come first, so the prompt's positions and the ring check count
    n_patches + S. (The reference counts S only and fails on patches,
    ROADMAP.md section 3.) A prompt longer than a sliding-window ring would
    overwrite slots mid-forward, so it takes the exact per-token loop, which
    takes no patches: it raises when given them. The recurrent families
    (ssm, hybrid) advance their state token by token, as the reference
    does: the cache path is the recurrence there. The fusion mask applies
    to the attention families and hybrid.
    """
    family = _family(cfg)
    S = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    if family in _TF_FAMILIES and S <= _min_ring(caches):
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        h, caches, _ = TF.lm_forward(params, cfg, tokens, patches=patches,
                                     positions=positions, caches=caches,
                                     skip_unembed=True,
                                     fusion_mask=fusion_mask)
        return TF.unembed(params, cfg, h[:, -1:]), caches
    if patches is not None:
        raise ValueError(
            f"the per-token prefill takes no patches ({family} family, "
            f"{S} positions with the patches): the one-forward prefill "
            "needs every cache ring to hold the whole prompt")
    if family == "ssm":
        fusion_mask = None
    logits = None
    for t in range(S):
        logits, caches = decode_step(params, cfg, caches, tokens[:, t:t + 1],
                                     t, fusion_mask=fusion_mask)
    return logits, caches


def param_count(params: Any) -> int:
    return sum(x.numel() for x in leaves(params))
