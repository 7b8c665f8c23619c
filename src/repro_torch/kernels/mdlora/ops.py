"""Wrappers for the fused block-LoRA projections, and the modality row masks
they take:

* ``mdlora_matmul``       one adapter for every row (the Backbone 2 fusion
  layer), kernel ``csrc/mdlora.cu``; its gradient is ``autograd.py``;
* ``mdlora_matmul_multi`` one adapter per row, gathered (serving), kernel
  ``csrc/mdlora_multi.cu``: fp32 in two launches, bf16 in one, whose D
  split comes from ``plan_multi`` (a function of D, F and the SM count).

Dispatch is by the tensor's device, with no fallback: a CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor launches the CUDA kernel or
raises. A CUDA call raises when grad mode is on and an input requires a
gradient (``runtime.refuse_backward``): the kernels have no
backward; ``mdlora_matmul`` trains through ``autograd.py``'s
Function, whose forward runs with grad mode off.
``LAUNCHES`` counts calls that launched a kernel (never the plain
version).
"""
from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence
from pathlib import Path

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.mdlora import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mdlora_multi.cu"
FUSED_SOURCE = SOURCE.with_name("mdlora.cu")
LAUNCHES = {"mdlora_matmul": 0, "mdlora_matmul_multi": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
# the bf16 kernel's geometry (checked against the source's when it loads):
# columns per F tile, d per ring stage, d per bottleneck split, resident
# blocks per SM
TILE_F, STAGE_K, U_LEN, BLOCKS_PER_SM = 64, 64, 128, 2
MIN_STAGES = 4  # per split, where D allows: fewer partials to add


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _row_blocks(block_dims: tuple[int, ...], device: str) -> torch.Tensor:
    """[D] block index of each row, built once per (blocks, device), so a
    mask costs one gather and no copy to the card."""
    reps = torch.as_tensor(block_dims)
    return torch.repeat_interleave(torch.arange(len(block_dims)),
                                   reps).to(device)


def block_row_masks(block_dims: Sequence[int], modality_masks
                    ) -> torch.Tensor:
    """[..., M] availability (e.g. [B, M] per request) -> [..., D] fp32 row
    masks over the fusion input, block m repeated ``block_dims[m]`` times."""
    mm = torch.as_tensor(modality_masks, dtype=torch.float32)
    return mm[..., _row_blocks(tuple(block_dims), str(mm.device))]


def block_row_mask(block_dims: Sequence[int], modality_mask) -> torch.Tensor:
    """[M] modality availability -> [D] fp32 row mask."""
    return block_row_masks(block_dims, modality_mask)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = runtime.load_library(SOURCE)
    lib.mdlora_multi_plan.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.mdlora_multi_plan.restype = None
    lib.mdlora_multi_bf16_geometry.argtypes = [ctypes.POINTER(_I)]
    lib.mdlora_multi_bf16_geometry.restype = None
    lib.mdlora_multi.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_float, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                 _P, _P]
    lib.mdlora_multi.restype = _I
    geometry = (_I * 4)()
    lib.mdlora_multi_bf16_geometry(geometry)
    want = (TILE_F, STAGE_K, U_LEN, BLOCKS_PER_SM)
    if tuple(geometry) != want:
        raise RuntimeError(f"{SOURCE.name} has geometry {tuple(geometry)}, "
                           f"the planner {want}")
    return lib


@functools.cache
def _fused_lib() -> ctypes.CDLL:
    lib = runtime.load_library(FUSED_SOURCE)
    lib.mdlora_max_rank.argtypes = []
    lib.mdlora_max_rank.restype = _I
    L = ctypes.c_longlong
    lib.mdlora_fused.argtypes = [_P, _P, _P, _P, _P, ctypes.c_float, _I, _I,
                                 _I, _I, _I, _I, L, L, L, L, L, _I,
                                 ctypes.POINTER(_I), _P, _P]
    lib.mdlora_fused.restype = _I
    return lib


def mdlora_matmul(x, w0, a, b, row_mask, scale: float = 2.0,
                  plan: int | None = None):
    """y = (x*m)@W0 + ((x*m)@a)@b*scale, one adapter for every row.

    x [T, D]; w0 [D, F]; a [D, r]; b [r, F]; row_mask [D] fp32 (None = all
    ones). Any operand may carry one leading batch axis K (x [K, T, D], w0
    [K, D, F], a [K, D, r], b [K, r, F], row_mask [K, D]); an operand
    without it is shared by every slice (the kernel reads it with stride 0).
    -> [T, F], or [K, T, F] when some operand is batched, in x's dtype.
    ``plan`` is the kernel's count of persistent blocks (None: as many as
    are resident at once, ``fused_blocks``); every count gives the same
    bits. The plain version ignores it.
    """
    if x.device.type == "cpu":
        return ref.mdlora_matmul_ref(x, w0, a, b, row_mask, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    runtime.refuse_backward("mdlora_matmul", x, w0, a, b, row_mask, hint=(
        ", or train through kernels/mdlora/autograd.py's fused_block_lora "
        "(its backward)"))
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be fp32 or bf16, got {x.dtype}")
    ops = (("x", x, 2), ("w0", w0, 2), ("a", a, 2), ("b", b, 2))
    if row_mask is not None:
        ops += (("row_mask", row_mask, 1),)
    Ks = set()
    for name, t, nd in ops:
        if t.dim() not in (nd, nd + 1):
            raise ValueError(f"{name} must have {nd} dims, or {nd + 1} with "
                             f"a batch axis; got shape {tuple(t.shape)}")
        if t.dim() == nd + 1:
            Ks.add(t.shape[0])
    if len(Ks) > 1:
        raise ValueError(f"batch axes disagree: {sorted(Ks)}")
    K = Ks.pop() if Ks else None
    T, D = x.shape[-2:]
    F, r = w0.shape[-1], a.shape[-1]
    if min(T, D, F, r, K or 1) < 1 or r > _fused_lib().mdlora_max_rank():
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w0 "
                         f"{tuple(w0.shape)}, a {tuple(a.shape)}")
    dev = x.device
    lead = lambda t, nd: (K,) if t.dim() == nd + 1 else ()  # noqa: E731
    for name, t, shape, dt in (
            ("x", x, (T, D), x.dtype), ("w0", w0, (D, F), x.dtype),
            ("a", a, (D, r), x.dtype), ("b", b, (r, F), x.dtype)) + (
            () if row_mask is None else
            (("row_mask", row_mask, (D,), torch.float32),)):
        runtime.check_cuda_tensor(name, t, dt, lead(t, len(shape)) + shape,
                                  dev)
    stride = lambda t, nd: (t[0].numel() if t is not None  # noqa: E731
                            and t.dim() == nd + 1 else 0)
    out = torch.empty((T, F) if K is None else (K, T, F), dtype=x.dtype,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fused_lib().mdlora_fused(
            x.data_ptr(), w0.data_ptr(), a.data_ptr(), b.data_ptr(),
            None if row_mask is None else row_mask.data_ptr(), float(scale),
            K or 1, T, D, F, r, _DTYPES[x.dtype], stride(x, 2),
            stride(w0, 2), stride(a, 2), stride(b, 2), stride(row_mask, 1),
            plan or 0, ctypes.byref(_USED), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mdlora_matmul: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES["mdlora_matmul"] += 1
    return out


_USED = ctypes.c_int(0)  # the persistent blocks of the last fused launch


def fused_blocks() -> int:
    """The count of persistent blocks the last ``mdlora_matmul`` launch
    took (its plan)."""
    return _USED.value


@functools.cache
def _plan(D: int, F: int, r: int, sms: int) -> tuple[int, int]:
    """fp32 -> (D splits of the base product, D splits of the bottleneck): a
    function of the shape and the card, never of the batch, so a row's
    result does not depend on the rows beside it."""
    out = (ctypes.c_int * 2)()
    _lib().mdlora_multi_plan(D, F, r, sms, out)
    return out[0], out[1]


def plan_multi(D: int, F: int, sms: int) -> tuple[int, int, int, int]:
    """bf16 -> (L, sd, su, ug): the bottleneck's split count su = ceil(D /
    U_LEN) and rows per bottleneck block ug; the base product's D split
    length L (a multiple of STAGE_K, at least MIN_STAGES stages where D
    allows) and count sd = ceil(D / L), chosen so that the su + ceil(F /
    TILE_F) x sd blocks of 16 rows fit the card at once (BLOCKS_PER_SM per
    SM) where such splits allow it; ug = 4 when four times the bottleneck
    blocks still fit (shorter staging for small projections), else 16. It
    never reads the batch, so a row's result does not depend on the rows
    beside it."""
    n_ft, su = -(-F // TILE_F), -(-D // U_LEN)
    slots = BLOCKS_PER_SM * sms
    want = max(1, (slots - su) // n_ft)
    L = -(-D // want)
    L = max(-(-L // STAGE_K) * STAGE_K, min(MIN_STAGES * STAGE_K,
                                             -(-D // STAGE_K) * STAGE_K))
    sd = -(-D // L)
    return L, sd, su, 4 if 4 * su + n_ft * sd <= slots else 16


_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """The bf16 kernel's counters on ``dev`` (one per F tile, then the
    bottleneck's, the block tickets and the finished tiles): int32,
    zero between calls (the last block of a tile zeroes its own), shared by
    the calls of a stream, which run in order; grown when a wider F needs
    more."""
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < n:
        c = _COUNTERS[dev] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=dev)
    return c


def mdlora_matmul_multi(x, w0, a, b, adapter_idx, row_mask=None,
                        scale: float = 2.0, plan: tuple | None = None):
    """Gathered multi-adapter projection: one fused call serves a batch of
    requests that each carry their own modality-block adapter.

    x [B, D] (one token per request); w0 [D, F] shared base; a [A, D, r] /
    b [A, r, F] stacked adapter store; adapter_idx [B] row -> slot;
    row_mask [B, D] per-request modality row masks (None = all present).
    -> [B, F] in x's dtype. ``plan`` overrides the split plan, which by
    default is ``plan_multi`` (bf16: (L, sd, su, ug)) or ``_plan`` (fp32:
    (sd, su)); another plan adds the partial sums in another order. The
    plain version ignores it.
    """
    if x.device.type == "cpu":
        return ref.mdlora_matmul_multi_ref(x, w0, a, b, adapter_idx,
                                           row_mask, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    runtime.refuse_backward("mdlora_matmul_multi", x, w0, a, b, row_mask,
                            hint=", or train with lora_impl='xla' (the "
                            "plain projection)")
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be [B, D] fp32/bf16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    B, D = x.shape
    A, _, r = a.shape
    F = w0.shape[1]
    if min(B, D, F, A, r) < 1 or r > 256:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, w0 {tuple(w0.shape)}")
    dev = x.device
    runtime.check_cuda_tensor("w0", w0, x.dtype, (D, F), dev)
    runtime.check_cuda_tensor("a", a, torch.float32, (A, D, r), dev)
    runtime.check_cuda_tensor("b", b, torch.float32, (A, r, F), dev)
    runtime.check_cuda_tensor("adapter_idx", adapter_idx, torch.int32, (B,),
                              dev)
    runtime.check_cuda_tensor("x", x, x.dtype, (B, D), dev)
    if row_mask is not None:
        runtime.check_cuda_tensor("row_mask", row_mask, torch.float32,
                                  (B, D), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if x.dtype == torch.bfloat16:
        L, sd, su, ug = plan or plan_multi(D, F, sms)
        counters = _counters(dev, -(-F // TILE_F) + 3).data_ptr()
    else:
        (sd, su), L, ug, counters = plan or _plan(D, F, r, sms), 0, 0, None
    ws = torch.empty(sd * B * F + su * B * r, dtype=torch.float32,
                     device=dev)
    out = torch.empty((B, F), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mdlora_multi(
            x.data_ptr(), w0.data_ptr(), a.data_ptr(), b.data_ptr(),
            adapter_idx.data_ptr(),
            None if row_mask is None else row_mask.data_ptr(), float(scale),
            B, D, F, A, r, _DTYPES[x.dtype], L, sd, su, ug, ws.data_ptr(),
            counters, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mdlora_matmul_multi: CUDA launch failed with "
                           f"error {err}")
    LAUNCHES["mdlora_matmul_multi"] += 1
    return out
