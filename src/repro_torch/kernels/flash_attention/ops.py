"""Wrapper for the flash-attention kernel.

Dispatch is by the tensor's device, with no fallback: a CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor launches the CUDA kernel in
``csrc/flash_attention.cu`` or raises. ``LAUNCHES`` counts kernel launches
(never the plain version).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LAUNCHES = {"flash_attention": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = runtime.load_library(SOURCE)
    lib.flash_attention.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, ctypes.c_longlong,
                                    ctypes.c_float, _I, _P]
    lib.flash_attention.restype = _I
    return lib


def flash_attention(q, k, v, q_pos, kv_pos, window=None, softcap=None):
    """q [B, S, K, G, hd]; k, v [B, T, K, hd]; q_pos [S], kv_pos [T] int32
    -> [B, S, K, G, hd] in q's dtype. ``window`` None = global."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_pos, kv_pos, window,
                                       softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 5 or q.dtype not in _DTYPES:
        raise ValueError(f"q must be [B, S, K, G, hd] fp32/bf16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    if not 16 <= hd <= 256 or min(B, S, K, G, T) < 1:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, T={T}")
    dev = q.device
    runtime.check_cuda_tensor("q", q, q.dtype, (B, S, K, G, hd), dev)
    runtime.check_cuda_tensor("k", k, q.dtype, (B, T, K, hd), dev)
    runtime.check_cuda_tensor("v", v, q.dtype, (B, T, K, hd), dev)
    runtime.check_cuda_tensor("q_pos", q_pos, torch.int32, (S,), dev)
    runtime.check_cuda_tensor("kv_pos", kv_pos, torch.int32, (T,), dev)
    window = ref.GLOBAL_WINDOW if window is None else int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, S, K, G, hd, T,
            _DTYPES[q.dtype], window,
            0.0 if softcap is None else float(softcap),
            0 if softcap is None else 1, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
