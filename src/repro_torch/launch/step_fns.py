"""Step functions executed by train.py and serve.py, and the shape-only
trees a dry-run reads.

  train_step    LoRA fine-tuning (the paper's setting; frozen base) or
                full-parameter training: Adam, global-norm clip; returns
                (params, opt_state, metrics)
  prefill_step  full forward, returns last-position logits
  serve_step    one-token decode against the KV/SSM caches, greedy sample

``abstract_params``, ``abstract_opt_state`` and ``abstract_caches`` build
the same trees on the ``meta`` device: every shape and dtype, no memory.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.optim import adam_init, adam_update
from repro_torch.tree import leaves, tree_map


def split_trainable(params: dict, mode: str) -> tuple[Any, Any]:
    """-> (the trainable tree, the rest): "lora" trains ``params["lora"]``
    and freezes the base; "full" trains everything."""
    if mode == "lora":
        return params["lora"], {"base": params["base"]}
    return params, {}


def merge_trainable(trainable: Any, rest: Any, mode: str) -> dict:
    if mode == "lora":
        return {"base": rest["base"], "lora": trainable}
    return trainable


def make_train_step(cfg: ModelConfig, lr: float | torch.Tensor = 1e-3,
                    train_mode: str = "lora", clip: float = 1.0):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``, the reference's step: the loss and its
    gradient over the trainable leaves only (``torch.autograd.grad``; a
    frozen base builds no weight gradients), the global norm of the
    gradients in fp32, the gradients scaled by ``min(1, clip / max(gnorm,
    1e-12))`` cast to each gradient's dtype, then Adam. The frozen leaves of
    the returned tree are the tensors passed in. A trainable leaf that the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives it.
    ``opt_state`` is ``adam_init`` of the trainable tree."""
    def train_step(params: dict, opt_state: dict, batch: dict) -> tuple:
        trainable, rest = split_trainable(params, train_mode)
        tr = tree_map(lambda t: t.detach().requires_grad_(), trainable)
        with torch.enable_grad():
            loss = api.loss_fn(merge_trainable(tr, rest, train_mode), cfg,
                               batch)
            flat = leaves(tr)
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(torch.zeros_like(t) if g is None else g
                  for t, g in zip(flat, got))
        grads = tree_map(lambda _: next(it), tr)
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g in leaves(grads)))
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        new_tr, new_opt = adam_update(trainable, grads, opt_state, lr)
        return (merge_trainable(new_tr, rest, train_mode), new_opt,
                {"loss": loss.detach(), "grad_norm": gnorm})

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        # unembed only the final position: full-sequence logits at a 100k+
        # vocab would dominate the prefill's memory and bytes
        h, _, _ = api.forward_hidden(params, cfg, batch)
        return api.TF.unembed(params, cfg, h[:, -1:])[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params: dict, caches: Any, token: torch.Tensor,
                   pos: Any) -> tuple:
        logits, caches = api.decode_step(params, cfg, caches, token, pos)
        return logits[:, -1:].argmax(-1).to(torch.int32), caches

    return serve_step


def abstract_params(cfg: ModelConfig, with_lora: bool = True) -> dict:
    """The parameter tree on ``meta``: shapes and dtypes, no allocation."""
    return api.init_model(None, cfg, "meta", with_lora)


def abstract_opt_state(trainable_abstract: Any) -> dict:
    return adam_init(trainable_abstract)


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    return api.init_caches(cfg, batch, max_len, device="meta")
