"""Wrappers for the gathered multi-adapter block-LoRA projection, and the
modality row masks it takes.

Dispatch is by the tensor's device, with no fallback: a CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor launches the CUDA kernel in
``csrc/mdlora_multi.cu`` or raises. ``LAUNCHES`` counts calls that launched
the kernel (never the plain version). The single-adapter kernel
(``mdlora_matmul_pallas``) is not ported; its plain version stays in
``ref.py`` as the tests' oracle.
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
LAUNCHES = {"mdlora_matmul_multi": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["mdlora_matmul_multi"] = 0


def block_row_mask(block_dims: Sequence[int], modality_mask) -> torch.Tensor:
    """[M] modality availability -> [D] fp32 row mask over the fusion
    input, block m repeated ``block_dims[m]`` times."""
    mm = torch.as_tensor(modality_mask, dtype=torch.float32)
    reps = torch.as_tensor(list(block_dims), device=mm.device)
    return torch.repeat_interleave(mm, reps)


def block_row_masks(block_dims: Sequence[int], modality_masks
                    ) -> torch.Tensor:
    """[B, M] per-request availability -> [B, D] row masks."""
    mm = torch.as_tensor(modality_masks, dtype=torch.float32)
    reps = torch.as_tensor(list(block_dims), device=mm.device)
    return torch.repeat_interleave(mm, reps, dim=-1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = runtime.load_library(SOURCE)
    lib.mdlora_multi_plan.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.mdlora_multi_plan.restype = None
    lib.mdlora_multi.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_float, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.mdlora_multi.restype = _I
    return lib


@functools.cache
def _plan(D: int, F: int, r: int, sms: int) -> tuple[int, int]:
    """-> (D splits of the base product, D splits of the bottleneck): a
    function of the shape and the card, never of the batch, so a row's
    result does not depend on the rows beside it."""
    out = (ctypes.c_int * 2)()
    _lib().mdlora_multi_plan(D, F, r, sms, out)
    return out[0], out[1]


def mdlora_matmul_multi(x, w0, a, b, adapter_idx, row_mask=None,
                        scale: float = 2.0):
    """Gathered multi-adapter projection: one fused call serves a batch of
    requests that each carry their own modality-block adapter.

    x [B, D] (one token per request); w0 [D, F] shared base; a [A, D, r] /
    b [A, r, F] stacked adapter store; adapter_idx [B] row -> slot;
    row_mask [B, D] per-request modality row masks (None = all present).
    -> [B, F] in x's dtype.
    """
    if x.device.type == "cpu":
        return ref.mdlora_matmul_multi_ref(x, w0, a, b, adapter_idx,
                                           row_mask, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
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
    sd, su = _plan(D, F, r, torch.cuda.get_device_properties(dev)
                   .multi_processor_count)
    ws = torch.empty(sd * B * F + su * B * r, dtype=torch.float32,
                     device=dev)
    out = torch.empty((B, F), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mdlora_multi(
            x.data_ptr(), w0.data_ptr(), a.data_ptr(), b.data_ptr(),
            adapter_idx.data_ptr(),
            None if row_mask is None else row_mask.data_ptr(), float(scale),
            B, D, F, A, r, _DTYPES[x.dtype], sd, su, ws.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mdlora_matmul_multi: CUDA launch failed with "
                           f"error {err}")
    LAUNCHES["mdlora_matmul_multi"] += 1
    return out
