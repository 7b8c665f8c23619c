"""Wrappers for the fused cohort aggregation + divergence kernels.

Dispatch is by the tensor's device, with no fallback: a CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor launches the CUDA kernel in
``csrc/cohort_agg.cu`` or raises. ``LAUNCHES`` counts calls that launched a
kernel, per op (never the plain version), so a run can show its flushes
went through the kernel.

Both ops, ``cohort_agg_divergence`` (fp32 deltas) and
``cohort_agg_divergence_quant`` (int8 codes), are one launch of the same
kernel, planned by ``plan_agg`` (a function of the shape and the SM count
only, so results are bitwise repeatable on one card).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.cohort_agg import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "cohort_agg.cu"
LAUNCHES = {"cohort_agg_divergence": 0, "cohort_agg_divergence_quant": 0}
# the kernel's geometry (checked against the source's when it loads):
# threads per block, resident blocks per SM; at most MAX_LANES client lanes
# and at least MIN_LANE_CLIENTS clients per lane and split
AGG_THREADS, AGG_BLOCKS_PER_SM = 256, 4
MAX_LANES, MIN_LANE_CLIENTS = 8, 4

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = runtime.load_library(SOURCE)
    lib.cohort_agg_f32.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                                   _P, _P, _P, _P, _P, _P]
    lib.cohort_agg_f32.restype = _I
    lib.cohort_agg_i8.argtypes = [_P, _P, _P, _P, _P, ctypes.c_float, _I, _I,
                                  _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                  _P]
    lib.cohort_agg_i8.restype = _I
    lib.cohort_agg_geometry.argtypes = [ctypes.POINTER(_I)]
    lib.cohort_agg_geometry.restype = None
    geometry = (_I * 2)()
    lib.cohort_agg_geometry(geometry)
    want = (AGG_THREADS, AGG_BLOCKS_PER_SM)
    if tuple(geometry) != want:
        raise RuntimeError(f"{SOURCE.name} has geometry "
                           f"{tuple(geometry)}, the planner {want}")
    return lib


class AggPlan(NamedTuple):
    vec: int     # elements per span: 4 (one float4 / char4 load) when
    #              r % 4 == 0, else 1
    rows: int    # whole rows per element tile
    lanes: int   # client lanes per block (AGG_THREADS / lanes span threads)
    splits: int  # client splits S, each a contiguous range of clients

    def tiles(self, D: int) -> int:
        return -(-D // self.rows)

    def blocks(self, D: int) -> int:
        return self.tiles(D) * self.splits


def plan_agg(N: int, D: int, r: int, sms: int) -> AggPlan:
    """The kernel's plan for either uplink, from the shape and the SM count
    only.

    Span threads: the least power of two (at least a warp) that covers one
    row's spans, at most the block; the rest of the block is client lanes,
    no more than N needs. A tile is as many whole rows as the span threads
    cover (one row, walked in passes, when it is wider). Splits fill the
    card's resident slots (AGG_BLOCKS_PER_SM per SM) in one wave, each
    lane keeping at least MIN_LANE_CLIENTS clients per split.
    """
    vec = 4 if r % 4 == 0 else 1
    sr = r // vec
    lanes = min(MAX_LANES, 1 << max(0, math.ceil(math.log2(N))))
    while lanes > 1 and AGG_THREADS // lanes < sr:
        lanes //= 2
    ts = AGG_THREADS // lanes
    rows = max(1, min(D, ts // sr))
    tiles = -(-D // rows)
    splits = max(1, min(-(-N // (lanes * MIN_LANE_CLIENTS)),
                        AGG_BLOCKS_PER_SM * sms // tiles))
    return AggPlan(vec, rows, lanes, splits)


_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """The kernel's tile counters on ``dev``: int32, zero between calls
    (a tile's last block zeroes its own), shared by the calls of a stream,
    which run in order; grown when a call has more tiles."""
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < n:
        c = _COUNTERS[dev] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=dev)
    return c


def _check(x: torch.Tensor, x_dtype: torch.dtype, W: torch.Tensor,
           C: torch.Tensor) -> tuple[int, int, int]:
    if x.dim() != 3:
        raise ValueError(f"deltas must be [N, D, r], got {tuple(x.shape)}")
    N, D, r = x.shape
    if min(N, D, r) < 1 or max(N, D, r) >= 2**31:
        raise ValueError(f"unsupported deltas shape {tuple(x.shape)}")
    runtime.check_cuda_tensor("deltas", x, x_dtype, (N, D, r), x.device)
    runtime.check_cuda_tensor("W", W, torch.float32, (N, D), x.device)
    runtime.check_cuda_tensor("C", C, torch.float32, (N, D), x.device)
    return N, D, r


def _outputs(N: int, D: int, r: int, dev: torch.device,
             plan: AggPlan | None = None):
    """The plan of a call on ``dev`` (``plan_agg``'s unless given), its
    workspace and tile counters (None with one split) and the four
    outputs."""
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = plan_agg(N, D, r, sms)
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(plan.splits * 2 * (D * r + D), dtype=torch.float32,
                         device=dev)
        counters = _counters(dev, plan.tiles(D))
    agg = torch.empty((D, r), dtype=torch.float32, device=dev)
    mean = torch.empty((D, r), dtype=torch.float32, device=dev)
    sq = torch.empty((D,), dtype=torch.float32, device=dev)
    cnt = torch.empty((D,), dtype=torch.float32, device=dev)
    return plan, ws, counters, agg, sq, mean, cnt


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def cohort_agg_divergence(deltas, W, C, plan: AggPlan | None = None):
    """deltas [N, D, r] f32, W [N, D] (Eq. 3/4 weights), C [N, D] (Eq. 5
    cohort) -> (agg [D,r], sqsum [D], mean [D,r], cnt [D]). ``plan``
    overrides ``plan_agg``'s (another plan adds in another order); the
    plain version ignores it."""
    if _device_kind(deltas) == "cpu":
        return ref.cohort_agg_divergence_ref(deltas, W, C)
    N, D, r = _check(deltas, torch.float32, W, C)
    dev = deltas.device
    plan, ws, counters, agg, sq, mean, cnt = _outputs(N, D, r, dev, plan)
    if plan.vec == 4 and deltas.data_ptr() % 16:
        raise ValueError("deltas must be 16-byte aligned for its float4 "
                         "loads")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().cohort_agg_f32(
            deltas.data_ptr(), W.data_ptr(), C.data_ptr(), N, D, r, plan.vec,
            plan.rows, plan.lanes, plan.splits, _ptr(ws), _ptr(counters),
            agg.data_ptr(), sq.data_ptr(), mean.data_ptr(), cnt.data_ptr(),
            stream)
    _raise_on(err, "cohort_agg_divergence")
    LAUNCHES["cohort_agg_divergence"] += 1
    return agg, sq, mean, cnt


def cohort_agg_divergence_quant(q, scales, W, C, staleness,
                                exponent: float = 0.0,
                                plan: AggPlan | None = None):
    """Fused quantized-ingest aggregation: one pass over the int8 uplink.

    q [N, D, r] int8 client chunks, scales [N] per-(client, leaf) dequant
    scales, W/C [N, D], staleness [N] server versions since pull. Equals
    ``cohort_agg_divergence(q * scales, W / (1+staleness)**exponent, C)``
    without materializing the fp32 [N, D, r] stack. ``plan`` as for
    ``cohort_agg_divergence``.
    """
    if _device_kind(q) == "cpu":
        return ref.cohort_agg_divergence_quant_ref(q, scales, W, C,
                                                   staleness, exponent)
    N, D, r = _check(q, torch.int8, W, C)
    runtime.check_cuda_tensor("scales", scales, torch.float32, (N,),
                              q.device)
    runtime.check_cuda_tensor("staleness", staleness, torch.float32, (N,),
                              q.device)
    dev = q.device
    plan, ws, counters, agg, sq, mean, cnt = _outputs(N, D, r, dev, plan)
    if plan.vec == 4 and q.data_ptr() % 4:
        raise ValueError("q must be 4-byte aligned for its char4 loads")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().cohort_agg_i8(
            q.data_ptr(), scales.data_ptr(), W.data_ptr(), C.data_ptr(),
            staleness.data_ptr(), float(exponent), N, D, r, plan.vec,
            plan.rows, plan.lanes, plan.splits, _ptr(ws), _ptr(counters),
            agg.data_ptr(), sq.data_ptr(), mean.data_ptr(), cnt.data_ptr(),
            stream)
    _raise_on(err, "cohort_agg_divergence_quant")
    LAUNCHES["cohort_agg_divergence_quant"] += 1
    return agg, sq, mean, cnt
