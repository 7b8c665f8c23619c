"""Device resolution and the nvcc build shared by the kernel wrappers.

``resolve_device(None)`` is the CUDA card, and raises when there is none:
the port never falls back to the CPU on its own. Callers that want the plain
PyTorch versions (the CPU tests) pass ``device="cpu"``.

CUDA kernels are plain ``extern "C"`` functions in ``csrc/*.cu``, compiled by
``nvcc`` for ``sm_90a`` at first use into ``_build/`` beside this file (listed
in ``.gitignore``) and loaded with ``ctypes``. The library name carries a hash
of the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. ``build`` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch versions")
    return dev


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


@dataclasses.dataclass(frozen=True)
class Build:
    source: Path
    library: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register/smem lines), "" when cached


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: list[Path]) -> dict[Path, Build]:
    """Compile every source whose library is missing, one nvcc each, all
    started together; raise with nvcc's log if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[Path, Build] = {}
    running = []
    for src in sources:
        lib = library_path(src)
        if lib.is_file():
            out[src] = Build(src, lib, 0.0, "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc, time.perf_counter()))
    failures = []
    for src, lib, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        out[src] = Build(src, lib, time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


@functools.cache
def load_library(source: Path) -> ctypes.CDLL:
    """Build ``source`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build([source])[source].library))


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple[int, ...], device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` -- what a raw-pointer kernel launch assumes. A fake tensor
    (the dry-run's) or a DTensor has no memory of its own to point at."""
    if type(t).__name__ in ("FakeTensor", "DTensor"):
        raise TypeError(f"{name} is a {type(t).__name__}: a kernel reads "
                        "raw device pointers; fake and distributed tensors "
                        "take the plain path on the CPU")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_backward(op: str, *tensors: torch.Tensor | None,
                    hint: str = "") -> None:
    """Raise when autograd would record ``op``'s kernel launch: grad mode is
    on and an input requires a gradient. A kernel writes its output through
    a raw pointer, so that output has no ``grad_fn`` and no gradient would
    flow back through the op: a silently wrong gradient. (The reference's
    Pallas kernels have no VJP either.) The plain versions, which CPU
    tensors take, stay differentiable."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{op}: the CUDA kernel has no backward, and an input requires "
            "a gradient; run it under torch.no_grad()" + hint)
