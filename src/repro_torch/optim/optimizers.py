"""Functional Adam over nested dicts of tensors (not ``torch.optim.Adam``).

Moments are fp32 whatever the parameter dtype, and the step is the
reference's ``lr * (m/bc1) / (sqrt(v/bc2) + eps)`` with the bias corrections
taken in fp32 as JAX takes them (``repro/optim/optimizers.py:29-53``). A
parameter whose gradient is exactly zero from the first step on (a gated-out
group) keeps a step of exactly 0.

The trees may carry a leading client axis: every operation is elementwise,
so K stacked clients step in one call.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def adam_init(params: Any) -> dict:
    zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "t": 0}


def adam_update(params: Any, grads: Any, state: dict, lr: float,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple[Any, dict]:
    t = state["t"] + 1
    tf = np.float32(t)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** tf)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** tf)

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32.square()
        step = lr * (m_new / bc1) / ((v_new / bc2).sqrt() + eps)
        return (p.float() - step).to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(  # noqa: E731
        lambda _, o: o[i], params, out)
    return pick(0), {"m": pick(1), "v": pick(2), "t": t}
