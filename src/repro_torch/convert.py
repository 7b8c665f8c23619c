"""Carry parameters between the JAX reference and the port, through numpy.

Same keys, same layouts, no transposes: a conv weight stays ``[W, I, O]`` and
``models.layers.conv1d`` permutes it inside the call, so leaf paths and
shapes are one to one with the reference tree.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def _tensor(x: Any, device: torch.device | str) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX gives it
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(x, device=device)


def params_from_numpy(tree: Any, device: torch.device | str) -> Any:
    """Nested dict of numpy arrays (e.g. ``jax.tree.map(np.asarray, p)``)
    -> the same nested dict of tensors on ``device``. bf16 leaves keep their
    bits."""
    return tree_map(lambda x: _tensor(x, device), tree)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of ``params_from_numpy``."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
