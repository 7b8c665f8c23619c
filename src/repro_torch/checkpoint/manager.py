"""Checkpoints of parameter trees and server state, in the reference's
on-disk layout, so either package restores what the other saved.

  * every save is written to ``<path>.tmp.<pid>.<us>/`` and then renamed to
    ``<dir>/step_<n:08d>/``, so a crash mid-save never corrupts the latest
    checkpoint;
  * ``arrays.npz`` holds one ``leaf_<i>`` entry per leaf in the tree's
    sorted-key order, and ``manifest.json`` the leaves' paths (printed as
    ``jax.tree_util.keystr`` prints them), numpy dtype names, shapes and the
    caller's metadata (round index, divergence EMA, strategy name);
  * bfloat16 (which ``np.savez`` cannot hold) is stored as its raw 16-bit
    words and restored from the manifest's dtype;
  * ``keep``-newest retention, ``latest_step()`` / ``restore_latest()``
    resume.

Leaves on the card are copied to the host for the save; a restore puts each
leaf on the device and in the dtype of the matching ``like`` leaf.

One deliberate difference from the reference: ``steps()`` takes only
directories named ``step_<digits>`` in full, so a temp directory left by a
crash between its manifest and its rename is ignored. The reference parses
every ``step_*`` name that holds a manifest and raises ``ValueError`` on
such a leftover.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_path, tree_map

_NPZ_SAFE = {"float64", "float32", "float16", "int64", "int32", "int16",
             "int8", "uint64", "uint32", "uint16", "uint8", "bool"}
_STEP = re.compile(r"step_(\d+)")


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf on the host as np.savez can store it (a dtype it cannot hold,
    such as bfloat16, as unsigned raw words of its size), and its dtype's
    numpy name."""
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if name in _NPZ_SAFE:
        return t.numpy(), name
    size = t.element_size()
    return t.view(getattr(torch, f"int{8 * size}")).numpy().view(
        f"u{size}"), name


def _from_npz(raw: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a tensor of the manifest's ``dtype``."""
    if dtype in _NPZ_SAFE:
        return torch.from_numpy(np.array(raw))
    return torch.from_numpy(np.array(raw).view(
        f"i{raw.dtype.itemsize}")).view(getattr(torch, dtype))


def save_tree(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Atomic save of one tree + metadata into directory ``path``."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{int(time.time() * 1e6)}"
    os.makedirs(tmp, exist_ok=True)
    items = leaves_with_path(tree)
    host = [_to_numpy(leaf) for _, leaf in items]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
    manifest = {
        "paths": [p for p, _ in items],
        "dtypes": [name for _, name in host],
        "shapes": [list(a.shape) for a, _ in host],
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def restore_tree(path: str, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like``: each leaf on the device and
    in the dtype of the matching ``like`` leaf."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        stored = [_from_npz(data[f"leaf_{i}"], dt)
                  for i, dt in enumerate(manifest["dtypes"])]
    n_like = len(leaves(like))
    if n_like != len(stored):
        raise ValueError(
            f"checkpoint has {len(stored)} leaves, target expects "
            f"{n_like} — structure mismatch")
    it = iter(stored)
    return (tree_map(lambda ref: next(it).to(device=ref.device,
                                             dtype=ref.dtype), like),
            manifest["metadata"])


class CheckpointManager:
    """Step-indexed checkpoints with retention and resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list[int]:
        """The complete checkpoints' steps, ascending."""
        out = []
        for d in os.listdir(self.dir):
            m = _STEP.fullmatch(d)
            if m and os.path.exists(os.path.join(self.dir, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree: Any, metadata: dict | None = None) -> str:
        meta = dict(metadata or {})
        meta["step"] = step
        p = self._step_dir(step)
        save_tree(p, tree, meta)
        for old in self.steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return p

    def restore(self, step: int, like: Any) -> tuple[Any, dict]:
        return restore_tree(self._step_dir(step), like)

    def restore_latest(self, like: Any) -> tuple[Any, dict] | None:
        s = self.latest_step()
        if s is None:
            return None
        return self.restore(s, like)
