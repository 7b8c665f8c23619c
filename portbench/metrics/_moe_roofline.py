"""The least time of the dropless expert layer's grouped products on an
NVIDIA H100 SXM (``_roofline``'s data-sheet peaks): for one call, the
SwiGLU products wg, wi and wo over ``assignments`` rows grouped by expert."""
from __future__ import annotations

import _roofline as R


def experts_bytes(d: int, f: int, assignments: int, load: list[int],
                  es: int = 2) -> float:
    """The weights of every expert that got a row, read once, and each
    product's activations in and out: x [A, d] into wg and wi, their
    outputs [A, f] out, h [A, f] into wo and y [A, d] out."""
    used = sum(1 for n in load if n > 0)
    return es * (3 * used * d * f + 2 * assignments * (d + f)
                 + assignments * (f + d))


def experts_flops(d: int, f: int, assignments: int) -> float:
    """6 x rows x d x f: three products of 2 x d x f per row."""
    return 6.0 * assignments * d * f


def experts_bound_s(d: int, f: int, assignments: int, load: list[int],
                    es: int = 2) -> float:
    """The larger of the bytes over HBM and the operations over the bf16
    peak."""
    return R.bound_s(experts_bytes(d, f, assignments, load, es),
                     experts_flops(d, f, assignments), R.BF16_FLOPS_PER_S)
