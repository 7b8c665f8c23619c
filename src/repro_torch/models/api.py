"""Family-dispatching model API -- the entry point serving uses.

  init_model(generator, cfg, device)     -> params {"base": ..., "lora": ...}
  forward(params, cfg, batch)            -> (logits, aux_loss)
  init_caches(cfg, batch, max_len, ...)  -> decode caches
  decode_step(params, cfg, caches, token, pos) -> (logits, caches)
  prefill_with_cache(params, cfg, caches, tokens) -> (last logits, caches)

The transformer families dispatch to ``models/transformer.py`` (the dense
family is ported; MoE, VLM and audio raise there). The ssm and hybrid
families raise ``NotImplementedError`` (ROADMAP.md, port queue). Caches are
written in place and returned.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF
from repro_torch.tree import leaves

_TF_FAMILIES = ("dense", "moe", "vlm", "audio")
_QUEUED = {"ssm": "kernel 6 (ssd_pallas) with models/ssm.py",
           "hybrid": "hybrid.py (hymba) through the engine"}


def _family(cfg: ModelConfig) -> None:
    """Raise unless the family's model is ported."""
    if cfg.family in _TF_FAMILIES:
        return
    if cfg.family in _QUEUED:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP.md, port "
            f"queue: {_QUEUED[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family}")


def init_model(generator: torch.Generator | None, cfg: ModelConfig,
               device: torch.device | str | None = None,
               with_lora: bool = True) -> dict:
    _family(cfg)
    return TF.init_lm(generator, cfg, device, with_lora)


def forward(params: dict, cfg: ModelConfig, batch: dict) -> tuple:
    _family(cfg)
    logits, _, aux = TF.lm_forward(params, cfg, batch["tokens"],
                                   patches=batch.get("patches"))
    return logits, aux


def forward_hidden(params: dict, cfg: ModelConfig, batch: dict) -> tuple:
    """Forward up to the final norm (pre-unembed); prefill unembeds only
    the last position."""
    _family(cfg)
    return TF.lm_forward(params, cfg, batch["tokens"],
                         patches=batch.get("patches"), skip_unembed=True)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                per_row_pos: bool = False,
                device: torch.device | str | None = None) -> Any:
    """``per_row_pos`` gives every batch row its own cache position leaf so
    rows can sit at different sequence depths (continuous batching)."""
    _family(cfg)
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
    _family(cfg)
    return TF.lm_decode_step(params, cfg, caches, token, pos,
                             adapter_idx=adapter_idx,
                             fusion_mask=fusion_mask, lora_impl=lora_impl)


def fusion_block_dims(cfg: ModelConfig) -> tuple[int, ...]:
    """Modality-aligned column blocks of the fusion (``wo``) input axis:
    one block per KV group (the concatenated-head axis is K-major after the
    [B, S, K, G, hd] reshape), i.e. head-group granularity."""
    _family(cfg)
    g = cfg.n_heads // cfg.n_kv_heads
    return (g * cfg.head_dim,) * cfg.n_kv_heads


def _min_ring(caches: Any) -> int:
    if isinstance(caches, dict) and "__per_sub__" in caches:
        return min(c["k"].shape[2] for c in caches["__per_sub__"])
    return caches["k"].shape[2]


def prefill_with_cache(params: dict, cfg: ModelConfig, caches: Any,
                       tokens: torch.Tensor,
                       patches: torch.Tensor | None = None,
                       fusion_mask: torch.Tensor | None = None) -> tuple:
    """Prefill ``tokens`` [B, S] into fresh ``caches`` (written in place);
    -> (last-position logits [B, 1, V], caches).

    One chunked forward over the whole prompt when every cache ring holds
    it; a prompt longer than a sliding-window ring would overwrite slots
    mid-forward, so it takes the exact per-token loop.
    """
    _family(cfg)
    S = tokens.shape[1]
    if S <= _min_ring(caches):
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        h, caches, _ = TF.lm_forward(params, cfg, tokens, patches=patches,
                                     positions=positions, caches=caches,
                                     skip_unembed=True,
                                     fusion_mask=fusion_mask)
        return TF.unembed(params, cfg, h[:, -1:]), caches
    logits = None
    for t in range(S):
        logits, caches = decode_step(params, cfg, caches, tokens[:, t:t + 1],
                                     t, fusion_mask=fusion_mask)
    return logits, caches


def param_count(params: Any) -> int:
    return sum(x.numel() for x in leaves(params))
