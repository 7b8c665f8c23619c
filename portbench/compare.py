"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out from the same inputs."""
from __future__ import annotations

import numpy as np
import torch

# a leaf whose reference change is under this share of the median leaf's
# moved by round-off alone (a gradient nought to rounding) and is left out
NOUGHT = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def leaf_gaps(prog: dict, ref: dict, base: dict) -> list[float]:
    """Each leaf's gap between the norms of the program's and the
    reference's change from ``base``, over the larger of the reference's
    norm of that leaf and of the median leaf. Leaves the reference leaves
    (nearly) unmoved are left out by ``NOUGHT``."""
    rn = {k: _norm(ref[k].cpu() - base[k].cpu()) for k in ref}
    pn = {k: _norm(prog[k].cpu() - base[k].cpu()) for k in ref}
    med = float(np.median(list(rn.values())))
    return [abs(pn[k] - rn[k]) / max(rn[k], med) for k in ref
            if rn[k] >= NOUGHT * med and med > 0]


def client_gaps(prog: dict, ref: dict) -> np.ndarray:
    """Each client's worst leaf, as ``leaf_gaps`` measures it, between two
    client-stacked trees of updates ([N, ...] leaves), for the clients the
    reference moves (a client trains only its allocated groups, and one
    whose groups hold only fusion blocks while the shared B is still zero
    gets a zero gradient: it is left out) -> [clients moved]. A client's
    median leaf is taken over the leaves the reference moves for it."""
    rn = torch.stack([ref[k].double().flatten(1).norm(dim=1) for k in ref])
    pn = torch.stack([prog[k].to(rn.device).double().flatten(1).norm(dim=1)
                      for k in ref])  # [leaves, N]
    med = torch.where(rn > 0, rn, torch.nan).nanmedian(dim=0).values  # [N]
    keep = (rn > 0) & (rn >= NOUGHT * med)
    gap = torch.where(keep, (pn - rn).abs() / torch.maximum(rn, med), 0.0)
    return gap.max(dim=0).values[keep.any(dim=0)].cpu().numpy()


def vec_gap(prog, ref) -> float:
    """Worst entry's |p - r| over the larger of |r| and the median |r|."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    med = float(np.median(np.abs(r)))
    den = np.maximum(np.abs(r), med)
    ok = den > 0
    return float(np.max(np.abs(p - r)[ok] / den[ok])) if ok.any() else 0.0


def rel_gap(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)
