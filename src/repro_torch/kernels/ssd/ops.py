"""Wrapper for the SSD chunked-scan kernel.

Dispatch is by the tensor's device, with no fallback: a CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor launches the CUDA kernel in
``csrc/ssd.cu`` or raises. bf16 at chunk <= 128 and n <= 128 (the serving
shapes) is one launch of the tensor-core chunk walk; fp32, and bf16 past
those sizes, the two launches of the fp32 scan (scores, then scan).
A CUDA call raises when grad mode is on and an input requires a
gradient (``runtime.refuse_backward``): the kernel has no backward.
``LAUNCHES`` counts calls that launched a kernel, never the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ssd import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
LAUNCHES = {"ssd": 0}
reset_launches = functools.partial(runtime.reset_counts, LAUNCHES)
MAX_DIM = 256  # chunk, p and n each; shared memory may bind first
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = runtime.load_library(SOURCE)
    lib.ssd_plan.argtypes = [_I, _I, _I, _I,
                             ctypes.POINTER(ctypes.c_longlong)]
    lib.ssd_plan.restype = None
    lib.ssd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _P]
    lib.ssd.restype = _I
    return lib


@functools.cache
def _plan(chunk: int, p: int, n: int, dtype: int
          ) -> tuple[bool, int, int, bool]:
    """-> (whether the call runs the one-launch chunk walk, the largest
    shared memory in bytes its launches ask for, the card's per-block limit,
    whether it needs the scores workspace)."""
    out = (ctypes.c_longlong * 4)()
    _lib().ssd_plan(chunk, p, n, dtype, out)
    return bool(out[0]), out[1], out[2], bool(out[3])


def chunk_walk(chunk: int, p: int, n: int, dtype: torch.dtype) -> bool:
    """Whether a CUDA call at these sizes runs the one-launch tensor-core
    chunk walk (else the two-launch fp32 scan); the source decides."""
    return _plan(chunk, p, n, _DTYPES[dtype])[0]


def ssd(x, dt, A_log, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan. x [b, s, h, p] fp32/bf16; dt [b, s, h] fp32;
    A_log [h] fp32; Bm, Cm [b, s, n] in x's dtype; ``initial_state``
    [b, h, p, n] fp32 or None (zeros).
    -> (y [b, s, h, p] in x's dtype, final_state [b, h, p, n] fp32)."""
    if x.device.type == "cpu":
        return ref.ssd_ref(x, dt, A_log, Bm, Cm, chunk, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    runtime.refuse_backward("ssd", x, dt, A_log, Bm, Cm, initial_state,
                            hint=", or train with attn_impl='xla' (the "
                            "plain scan)")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be [b, s, h, p] fp32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if min(b, s, h, p, n, chunk) < 1 or s % chunk != 0:
        raise ValueError(f"seq {s} not divisible by ssd chunk {chunk} (or "
                         f"an empty dimension in x {tuple(x.shape)})")
    if max(chunk, p, n) > MAX_DIM:
        raise ValueError(f"chunk {chunk}, p {p} and n {n} must each be at "
                         f"most {MAX_DIM}")
    dev = x.device
    runtime.check_cuda_tensor("x", x, x.dtype, (b, s, h, p), dev)
    runtime.check_cuda_tensor("dt", dt, torch.float32, (b, s, h), dev)
    runtime.check_cuda_tensor("A_log", A_log, torch.float32, (h,), dev)
    runtime.check_cuda_tensor("Bm", Bm, x.dtype, (b, s, n), dev)
    runtime.check_cuda_tensor("Cm", Cm, x.dtype, (b, s, n), dev)
    if initial_state is not None:
        runtime.check_cuda_tensor("initial_state", initial_state,
                                  torch.float32, (b, h, p, n), dev)
    with torch.cuda.device(dev):
        _, smem, limit, scores = _plan(chunk, p, n, _DTYPES[x.dtype])
    if smem > limit:
        raise ValueError(f"chunk {chunk}, p {p}, n {n} need {smem} bytes of "
                         f"shared memory per block; the card has {limit}")
    work = torch.empty(b * (s // chunk) * chunk * chunk if scores else 1,
                       dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    final_state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().ssd(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
                         Bm.data_ptr(), Cm.data_ptr(),
                         None if initial_state is None
                         else initial_state.data_ptr(), work.data_ptr(),
                         y.data_ptr(), final_state.data_ptr(), b, s, h, p, n,
                         chunk, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd: CUDA launch failed with error {err}")
    LAUNCHES["ssd"] += 1
    return y, final_state
