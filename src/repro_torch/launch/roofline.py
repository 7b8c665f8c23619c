"""Roofline terms of a traced step, with H100 constants.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

The constants are NVIDIA's data-sheet values for the H100 SXM5 80GB, not
measurements. FLOPs, bytes and collectives are counted while the step runs
eagerly on fake tensors (``StepCounter``, ``launch/dryrun.py``); there is
no compiled HLO to read. Per device means per local shard: a DTensor op is
counted on the local tensors it desugars into. FLOPs are the matrix
products, convolutions and attention of ``torch.utils.flop_counter``'s
formula registry; bytes are UNFUSED, the inputs plus outputs of every local
op that makes a new tensor (views move none), so they bound a fused
program's traffic from above. Collectives keep the reference's rules
(``repro/launch/roofline.py``): the result size of each all-gather,
all-reduce (counted twice: reduce and broadcast phases), reduce-scatter,
all-to-all and collective-permute. Every op counts each time it runs (an
eager trace repeats a layer's collectives per layer), so ``bytes_scanned``
is 0.
"""
from __future__ import annotations

import dataclasses
import math
import re
import sys

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12  # HBM3 bytes/s (data sheet)
LINK_BW = 450e9  # NVLink 4 bytes/s, each way (data sheet: 900 GB/s both)
HBM_BYTES = 80e9  # device memory, bytes (data sheet: 80 GB)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# the c10d ops each collective dispatches as (functional and in-place)
_C10D = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_C10D_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d",
                    "_dtensor")
# DTensor's own modules
_DTENSOR_MODULES = ("torch.distributed.tensor",
                    "torch.distributed._local_tensor")
# ops that allocate without writing: no bytes moved
_ALLOC_ONLY = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided"}


@dataclasses.dataclass
class CollectiveStats:
    bytes_entry: int
    bytes_scanned: int  # inside loop bodies, per trip: 0 for an eager trace
    counts: dict

    def total(self, scan_steps: int) -> int:
        return self.bytes_entry + self.bytes_scanned * max(scan_steps, 1)


def collective_of(func) -> str | None:
    """The reference's collective name of a c10d op, or None."""
    if func.namespace not in _C10D_NAMESPACES:
        return None
    return _C10D.get(func._overloadpacket.__name__)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _new_outputs(func, out) -> list:
    """The outputs of ``func`` that are new tensors or written in place
    (not views of an input)."""
    outs = out if isinstance(out, (tuple, list)) else [out]
    rets = func._schema.returns
    if len(rets) == 1:  # one return, or one list of them (chunk, split)
        rets = rets * len(outs)
    keep = []
    for i, o in enumerate(outs):
        alias = rets[i].alias_info if i < len(rets) else None
        if alias is None or alias.is_write:
            keep.append(o)
    return keep


class StepCounter(TorchDispatchMode):
    """Counts, per device, what a step does while the mode is active:
    ``flops`` (the formula registry of ``torch.utils.flop_counter``, on
    local shapes), ``bytes`` (unfused: inputs + outputs of every op that
    makes a new tensor) and ``collectives`` (``CollectiveStats``).

    DTensor ops are let through (``NotImplemented``), so the mode sees the
    local ops and the collectives they desugar into. The ops DTensor runs
    to propagate shapes (under a fake mode of its own) are not counted.
    With ``fake_mode`` the counted ops run inside it, so a factory call
    (``torch.arange``, ``torch.zeros``) makes a fake tensor too.
    """

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats(0, 0, {})
        self._entry = None

    def __enter__(self):
        self._entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if active_fake_mode() is not self._entry:  # shape propagation
            return func(*args, **kwargs)
        if self.fake_mode is None:
            out = func(*args, **kwargs)
        elif self._fakes(args, kwargs):
            with self.fake_mode:
                out = func(*args, **kwargs)
        else:  # DTensor's bookkeeping on real tensors: not the step's work
            return func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    @staticmethod
    def _fakes(args, kwargs) -> bool:
        """Whether an op runs under the fake mode: one on fake tensors does;
        one on real tensors does not (DTensor's own bookkeeping, such as a
        strided shard's offsets, reads values); a factory call does unless
        DTensor made it, found by the nearest caller frame of this package
        or of DTensor's modules."""
        from torch._subclasses.fake_tensor import FakeTensor

        tensors = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        if tensors:
            return any(isinstance(t, FakeTensor) for t in tensors)
        frame = sys._getframe(2)
        while frame is not None:
            mod = frame.f_globals.get("__name__", "")
            if frame.f_code.co_name == "__torch_dispatch__":
                pass  # a dispatch mode between the caller and this one
            elif mod.startswith(_DTENSOR_MODULES):
                return False
            elif mod.startswith("repro_torch"):
                return True
            frame = frame.f_back
        return True

    def _count(self, func, args, kwargs, out) -> None:
        if func.namespace == "prim":
            return
        coll = collective_of(func)
        if coll is not None:
            b = _tensor_bytes(out)
            if coll == "all-reduce":
                b *= 2  # reduce + broadcast phases on a ring
            c = self.collectives
            c.counts[coll] = c.counts.get(coll, 0) + 1
            c.bytes_entry += b
            return
        fn = self._registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        if func._overloadpacket.__name__ in _ALLOC_ONLY:
            return
        new = _new_outputs(func, out)
        if new:  # a pure view moves nothing
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(new)


def count_collectives(fake_mode=None) -> StepCounter:
    """A ``StepCounter`` for ``with count_collectives() as c:``; its
    ``c.collectives`` is the ``CollectiveStats`` of the block."""
    return StepCounter(fake_mode)


def roofline_terms(flops: float, bytes_accessed: float,
                   coll: CollectiveStats, scan_steps: int = 1) -> dict:
    """The three terms from a step's counted per-device FLOPs, unfused
    bytes and collectives (the reference took ``cost_analysis()`` and the
    HLO text); keys as the reference's."""
    flops, bytes_accessed = float(flops), float(bytes_accessed)
    cbytes = float(coll.total(scan_steps))
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    t_collective = cbytes / LINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return {
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": cbytes,
        "collective_counts": dict(coll.counts),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
    }


def mdlora_block_plan(shapes, impl: str = "pallas",
                      interpret: bool | None = None) -> list[dict]:
    """Block plan + roofline terms for the mdlora kernels, the reference's
    keys and formulas.

    shapes: iterable of dicts {"T", "D", "F", "r"} and optionally
    {"multi": bool, "n_adapters": int}. (bt, bf, bd) is the autotuner's
    untimed cell (``select_mdlora_blocks``; ``interpret`` None is True: the
    port has no Pallas tiles to time, its CUDA plans are swept by the
    timed branch), and the compute/memory terms use the H100 constants.
    """
    from repro_torch.kernels.cohort_agg.autotune import select_mdlora_blocks

    interpret = True if interpret is None else interpret
    out = []
    for s in shapes:
        T, D, F, r = int(s["T"]), int(s["D"]), int(s["F"]), int(s["r"])
        multi = bool(s.get("multi", False))
        A = int(s.get("n_adapters", 1))
        bt, bf, bd = select_mdlora_blocks((T, D, F, r), impl=impl,
                                          interpret=interpret, multi=multi,
                                          n_adapters=A)
        flops = 2.0 * T * D * (F + r) + 2.0 * T * r * F
        # streamed bytes: x + w0 once per F-tile sweep, adapter tiles per
        # row (multi) or once (single), output once; fp32
        adapter_rows = T if multi else 1
        bytes_accessed = 4.0 * (T * D + D * F * (1 if T <= bt else T // bt)
                                + adapter_rows * (D * r + r * F) + T * F)
        t_c, t_m = flops / PEAK_FLOPS, bytes_accessed / HBM_BW
        out.append({
            "T": T, "D": D, "F": F, "r": r, "multi": multi,
            "n_adapters": A, "bt": bt, "bf": bf, "bd": bd,
            "flops": flops, "bytes": bytes_accessed,
            "intensity": flops / max(bytes_accessed, 1.0),
            "t_compute_s": t_c, "t_memory_s": t_m,
            "dominant": "compute" if t_c >= t_m else "memory",
        })
    return out


_EXPERT = re.compile(r"\['(wi|wg|wo)'\]")


def model_flops(cfg, shape, train_mode: str = "lora") -> dict:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), with the
    LoRA-adjusted ideal (~4*N*D: frozen weights skip dW) as
    ``model_flops``; parameters counted on ``meta``."""
    from repro_torch.launch import step_fns
    from repro_torch.tree import leaves, leaves_with_path

    base = step_fns.abstract_params(cfg)["base"]
    n_total = sum(math.prod(x.shape) for x in leaves(base))
    if cfg.n_experts:
        # active = non-expert params + top_k/n_experts of expert params
        expert = sum(math.prod(x.shape) for p, x in leaves_with_path(base)
                     if _EXPERT.search(p) and x.dim() == 4)
        n_active = n_total - expert + expert * cfg.top_k / cfg.n_experts
    else:
        n_active = n_total
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = {"train": 6.0 if train_mode == "full" else 4.0,
              "prefill": 2.0, "decode": 2.0}[shape.kind]
    return {
        "n_params": n_total, "n_active": n_active, "tokens": tokens,
        "model_flops": factor * n_active * tokens,
        "model_flops_6nd": 6.0 * n_active * tokens,
    }
