"""Wrapper for the flash-attention kernels.

Dispatch is by the tensor's device, with no fallback: a CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor launches the CUDA kernels in
``csrc/flash_attention.cu`` or raises. On the card the C entry dispatches by
dtype and shape, explicitly:

- fp32: the first kernel, fp32 arithmetic on the CUDA cores (its 2e-5
  parity needs fp32; the serving path runs bf16);
- bf16, S*G > ``DECODE_ROWS`` (prefill): a sort of the slots by position,
  then the tensor-core kernel (mma.sync, cp.async ring);
- bf16, S*G <= ``DECODE_ROWS`` (decode): split-KV over ``plan_splits``
  chunks of T, then a combine launch; the wrapper allocates the scratch.

A CUDA call raises when grad mode is on and an input requires a
gradient (``runtime.refuse_backward``): the kernel has no backward.
``LAUNCHES["flash_attention"]`` counts calls of the op on the card (one per
attention call, however many CUDA launches the call makes), never the plain
version; ``PATH_LAUNCHES`` splits the same calls by path.
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
PATH_LAUNCHES = {"fp32": 0, "prefill": 0, "decode": 0}
reset_launches = functools.partial(runtime.reset_counts, LAUNCHES,
                                   PATH_LAUNCHES)
DECODE_ROWS = 16  # bf16 calls with S*G at or below this take split-KV
PREFILL_ROWS = 64  # the fewest folded rows a bf16 prefill block owns
MAX_SPLITS = 32
MIN_SPLIT_TILES = 3  # 64-key tiles per chunk, at least
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def plan_splits(q_shape, T: int) -> int:
    """Chunks of T for a bf16 call of q's shape [B, S, K, G, hd]: 0 for the
    prefill path (S*G > ``DECODE_ROWS``), else the split-KV count: chunks of
    ``MIN_SPLIT_TILES`` 64-key tiles, or more once there would be more than
    ``MAX_SPLITS`` chunks.
    Reads S*G and T only: never B, K or the card, so a row's bits do not
    depend on its batch neighbours."""
    _, S, _, G, _ = q_shape
    if S * G > DECODE_ROWS:
        return 0
    n_tiles = -(-T // ref.KV_TILE)
    per = max(MIN_SPLIT_TILES, -(-n_tiles // MAX_SPLITS))
    return -(-n_tiles // per)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = runtime.load_library(SOURCE)
    lib.flash_attention.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, ctypes.c_longlong,
                                    ctypes.c_float, _I, _I, _P, _P]
    lib.flash_attention.restype = _I
    lib.flash_attention_smem_bytes.argtypes = [_I, _I]
    lib.flash_attention_smem_bytes.restype = _I
    return lib


def smem_bytes(hd: int, path: str) -> int:
    """Dynamic shared memory of a bf16 launch at head_dim ``hd``, for
    ``path`` "prefill" or "decode" (builds the library if needed)."""
    return _lib().flash_attention_smem_bytes(hd, int(path == "decode"))


def flash_attention(q, k, v, q_pos, kv_pos, window=None, softcap=None):
    """q [B, S, K, G, hd]; k, v [B, T, K, hd]; q_pos [S], kv_pos [T] int32
    -> [B, S, K, G, hd] in q's dtype. ``window`` None = global."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_pos, kv_pos, window,
                                       softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    runtime.refuse_backward("flash_attention", q, k, v, hint=(
        ", or train with attn_impl='xla' (the plain attention)"))
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
    if q.dtype == torch.float32:
        path, splits, scratch = "fp32", 0, None
    elif (splits := plan_splits(q.shape, T)) == 0:
        path = "prefill"  # each row tile's key range, the sorted slots
        tiles = -(-S * G // PREFILL_ROWS)
        scratch = torch.empty(4 * tiles + 2 * T, dtype=torch.int32,
                              device=dev)
    else:  # each chunk's partial (acc, m, l) per row
        path = "decode"
        scratch = torch.empty(B * K * splits * S * G * (hd + 2),
                              dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, S, K, G, hd, T,
            _DTYPES[q.dtype], window,
            0.0 if softcap is None else float(softcap),
            0 if softcap is None else 1, splits,
            None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    PATH_LAUNCHES[path] += 1
    return out
