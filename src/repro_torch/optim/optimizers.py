"""Functional optimizers over nested dicts of tensors (not ``torch.optim``):
Adam/AdamW, SGD with momentum, and the learning-rate schedules of
``repro/optim/optimizers.py``.

Moments are fp32 whatever the parameter dtype, and Adam's step is the
reference's ``lr * (m/bc1) / (sqrt(v/bc2) + eps)`` with the bias corrections
taken in fp32 as JAX takes them (``repro/optim/optimizers.py:29-53``). A
parameter whose gradient is exactly zero from the first step on (a gated-out
group) keeps a step of exactly 0.

``lr`` is a float or a 0-d tensor (a schedule's value), used as given. The
trees may carry a leading client axis: every operation is elementwise, so K
stacked clients step in one call.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def _zeros32(tree: Any) -> Any:
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), tree)


def _unzip(tree: Any, out: Any, n: int) -> tuple:
    """A tree of n-tuples (``out``, shaped as ``tree``) -> n trees."""
    return tuple(tree_map(lambda _, o, i=i: o[i], tree, out)
                 for i in range(n))


def adam_init(params: Any) -> dict:
    return {"m": _zeros32(params), "v": _zeros32(params), "t": 0}


def adam_update(params: Any, grads: Any, state: dict,
                lr: float | torch.Tensor, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> tuple[Any, dict]:
    t = state["t"] + 1
    tf = np.float32(t)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** tf)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** tf)

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32.square()
        step = lr * (m_new / bc1) / ((v_new / bc2).sqrt() + eps)
        if weight_decay:
            step = step + lr * weight_decay * p.float()
        return (p.float() - step).to(p.dtype), m_new, v_new

    new_p, m, v = _unzip(params, tree_map(upd, params, grads, state["m"],
                                          state["v"]), 3)
    return new_p, {"m": m, "v": v, "t": t}


def sgd_init(params: Any) -> dict:
    return {"mom": _zeros32(params)}


def sgd_update(params: Any, grads: Any, state: dict,
               lr: float | torch.Tensor, momentum: float = 0.9
               ) -> tuple[Any, dict]:
    def upd(p, g, m):
        m_new = momentum * m + g.float()
        return (p.float() - lr * m_new).to(p.dtype), m_new

    new_p, mom = _unzip(params, tree_map(upd, params, grads, state["mom"]),
                        2)
    return new_p, {"mom": mom}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], dict]
    update: Callable[..., tuple[Any, dict]]


def make_optimizer(name: str, **kw) -> Optimizer:
    """"adam" or "sgd" -> (init, update(params, grads, state, lr)), with
    ``kw`` (b1, weight_decay, momentum, ...) bound into the update."""
    if name == "adam":
        return Optimizer(adam_init,
                         lambda p, g, s, lr: adam_update(p, g, s, lr, **kw))
    if name == "sgd":
        return Optimizer(sgd_init,
                         lambda p, g, s, lr: sgd_update(p, g, s, lr, **kw))
    raise ValueError(name)


def _f32(step: Any) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1
                    ) -> Callable[[Any], torch.Tensor]:
    """step -> 0-d fp32 lr, from base_lr down to min_frac * base_lr over
    ``total_steps`` (held there after)."""
    def fn(step):
        frac = (_f32(step) / max(total_steps, 1)).clamp(0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + torch.cos(math.pi * frac)))
    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.05
                         ) -> Callable[[Any], torch.Tensor]:
    """A linear ramp from 0 over ``warmup`` steps, then the cosine decay
    over the rest."""
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def fn(step):
        s = _f32(step)
        w = (s / max(warmup, 1)).clamp(0.0, 1.0)
        return torch.where(s < warmup, base_lr * w, cos(s - warmup))
    return fn
