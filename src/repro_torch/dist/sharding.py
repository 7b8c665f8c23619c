"""Sharding specs for the production meshes (``launch/mesh.py``), as DTensor
placements.

Three strategies, picked per (arch, step kind) by ``pick_strategy``:

  fsdp        params sharded over the data axes (ZeRO-3-style; moments
              follow their params via ``opt_state_specs`` = ZeRO-1)
  tp          params sharded over the ``model`` axis (Megatron-style);
              the serving default: decode batches are too small to feed
              the data axis
  replicated  small models: replicate params, shard only the batch

A spec is a tuple of placements, one per mesh dim in the mesh's order:
``Shard(i)`` where the mesh dim shards tensor dim ``i``, ``Replicate()``
elsewhere. A tensor dim sharded over ("pod", "data") is ``Shard(i)`` on
both mesh dims, pod first: DTensor's pod-major layout, the same as JAX's.
Specs are built from ``mesh.mesh_dim_names`` and ``mesh.shape`` only, so
they can be computed against any object that has those two (a fake mesh
with no process group); ``to_named`` binds them to a ``DeviceMesh`` and
``distribute`` applies them. A dim is only ever sharded where the axis
product divides it, so every spec is even by construction.

``act_hint`` is the activation-sharding hook the model code calls with
logical axis labels ("batch" / "model" / "model_pad" / None); it returns
its input until ``set_activation_mesh`` installs a mesh (single-device
runs never pay for it).
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.tree import tree_map

Spec = tuple  # one placement per mesh dim

# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[axis_names(mesh).index(axis)])


def _axis_product(mesh, axes: tuple[str, ...]) -> int:
    return int(math.prod(_axis_size(mesh, a) for a in axes))


def data_axes(mesh) -> tuple[str, ...]:
    """The client/batch mesh axes, outermost first (pod before data)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def replicated(mesh) -> Spec:
    return tuple(Replicate() for _ in axis_names(mesh))


def placements(mesh, dims: dict[int, tuple[str, ...]]) -> Spec:
    """{tensor dim: mesh axes sharding it} -> one placement per mesh dim."""
    out = list(replicated(mesh))
    for dim, axes in dims.items():
        for a in axes:
            out[axis_names(mesh).index(a)] = Shard(dim)
    return tuple(out)


# ---------------------------------------------------------------------------
# activation hints
# ---------------------------------------------------------------------------

_ACT: dict = {"mesh": None, "batch_axes": (), "tp": True}


def set_activation_mesh(mesh, tp: bool = True,
                        batch_axes: tuple[str, ...] | None = None) -> None:
    """Install (or clear, with ``mesh=None``) the activation mesh used by
    ``act_hint``. ``batch_axes`` defaults to the data axes of the mesh."""
    _ACT["mesh"] = mesh
    _ACT["tp"] = tp
    if mesh is None:
        _ACT["batch_axes"] = ()
    else:
        _ACT["batch_axes"] = (tuple(batch_axes) if batch_axes is not None
                              else data_axes(mesh))


def _resolve_label(label, mesh) -> tuple[str, ...]:
    if label is None:
        return ()
    if label == "batch":
        return tuple(_ACT["batch_axes"])
    if label in ("model", "model_pad"):
        return ("model",) if (_ACT["tp"] and "model" in axis_names(mesh)
                              ) else ()
    if label in axis_names(mesh):
        return (label,)
    return ()


def hint_spec(shape, labels, mesh) -> Spec | None:
    """The placements ``act_hint`` resolves for a tensor of ``shape``, or
    None when no label shards a dim (the hint is then no constraint)."""
    dims = {}
    for i, (dim, label) in enumerate(zip(shape, labels)):
        axes = _resolve_label(label, mesh)
        if axes and dim % _axis_product(mesh, axes) == 0:
            dims[i] = axes
    return placements(mesh, dims) if dims else None


def act_hint(x, *labels):
    """Constrain an activation's sharding by logical axis labels.

    Labels map per dim: "batch" -> the installed batch axes, "model" /
    "model_pad" -> the model axis when TP is active, None -> unsharded.
    Axes that do not evenly divide their dim are dropped. No mesh installed,
    or ``x`` not a DTensor -> ``x`` itself; else ``x`` redistributed to the
    resolved placements (the collective DTensor needs, if any).
    """
    mesh = _ACT["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = hint_spec(x.shape, labels, mesh)
    if spec is None or tuple(x.placements) == spec:
        return x
    return x.redistribute(x.device_mesh, spec)


def reduce_partial(x):
    """A DTensor's pending (partial) sums reduced now, to ``Replicate`` on
    those mesh dims; anything else as it is. DTensor's lookup in a
    vocab-sharded embedding table leaves a masked partial sum whose mask
    can be applied once only: a checkpointed layer that takes it as input
    would reduce it again in its recompute."""
    if _ACT["mesh"] is None or not isinstance(x, DTensor):
        return x
    spec = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if spec == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, spec)


def replicate_dim(x, dim: int, unless_divides: int | None = None):
    """A DTensor whose ``dim`` is sharded comes back replicated on the
    mesh dims that shard it, unless their product divides
    ``unless_divides``; anything else as it is."""
    if _ACT["mesh"] is None or not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    on_dim = [isinstance(p, Shard) and p.dim % x.dim() == dim
              for p in x.placements]
    ways = math.prod(int(size) for size, hit in zip(x.device_mesh.shape,
                                                    on_dim) if hit)
    if ways == 1 or (unless_divides is not None
                     and unless_divides % ways == 0):
        return x
    spec = tuple(Replicate() if hit else p
                 for p, hit in zip(x.placements, on_dim))
    return x.redistribute(x.device_mesh, spec)


def whole_heads(x, n_heads: int, dim: int = -1):
    """``x`` for a reshape that splits ``dim`` into [n_heads, ..]: a
    DTensor sharded there over more devices than n_heads divides is
    replicated on those mesh dims first, so no head is split across
    devices (the reference's GSPMD pads the head axis instead)."""
    return replicate_dim(x, dim, unless_divides=n_heads)


def gather_weight(w):
    """FSDP's all-gather at use: a DTensor parameter sharded over the data
    axes comes back replicated there for its product; a shard over the
    model axis (tensor parallelism) stays. Anything else as it is. The
    unembedding takes it: on its own, DTensor's propagation would gather
    the batch of activations instead (less to move for the forward) and
    hold a batch-replicated gradient of the final hidden state."""
    mesh = _ACT["mesh"]
    if mesh is None or not isinstance(w, DTensor):
        return w
    names = axis_names(mesh)
    spec = tuple(Replicate() if names[i] in ("pod", "data") else p
                 for i, p in enumerate(w.placements))
    if spec == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, spec)


# ---------------------------------------------------------------------------
# strategy selection
# ---------------------------------------------------------------------------


def _approx_param_count(cfg) -> float:
    """Coarse parameter-count estimate from the config dims alone."""
    d, L = cfg.d_model, cfg.n_layers
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    attn = 0.0
    if cfg.n_heads:
        hd = cfg.head_dim or d // cfg.n_heads
        attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    ff = 3.0 * d * cfg.d_ff * max(cfg.n_experts, 1)
    ssm = 3.0 * d * cfg.d_inner if cfg.d_inner else 0.0
    return emb + L * (attn + ff + ssm)


def pick_strategy(cfg, kind: str) -> str:
    """-> "fsdp" | "tp" | "replicated" for one (arch, step-kind) cell."""
    if kind != "train":  # prefill / decode / serve: small batch, TP it
        return "tp"
    if cfg.family == "moe":
        # expert parallelism folds into TP: the stacked expert FF dims are
        # the only axes large enough to keep 16-way model sharding busy
        return "tp"
    if _approx_param_count(cfg) < 3e9:
        return "replicated"
    return "fsdp"


# ---------------------------------------------------------------------------
# spec construction
# ---------------------------------------------------------------------------


def _shard_largest_dim(shape, axes: tuple[str, ...], mesh) -> Spec:
    """Spec sharding the largest evenly-divisible dim over ``axes``
    (ties -> the trailing dim, matching row-major layout locality)."""
    if not axes:
        return replicated(mesh)
    size = _axis_product(mesh, axes)
    best = -1
    for i, d in enumerate(shape):
        if d % size == 0 and d >= size and (best < 0 or d >= shape[best]):
            best = i
    if best < 0:
        return replicated(mesh)
    return placements(mesh, {best: axes})


def param_specs(cfg, params: Any, mesh, train: bool = False,
                strategy: str | None = None) -> Any:
    """Spec tree mirroring ``params`` (tensors on any device, ``meta``
    included). Every sharded dim divides its axis product."""
    strategy = strategy or pick_strategy(cfg, "train" if train else "serve")
    if strategy == "replicated":
        return tree_map(lambda x: replicated(mesh), params)
    axes = data_axes(mesh) if strategy == "fsdp" else ("model",)
    if not set(axes) <= set(axis_names(mesh)):
        return tree_map(lambda x: replicated(mesh), params)
    return tree_map(lambda x: _shard_largest_dim(tuple(x.shape), axes, mesh),
                    params)


def opt_state_specs(pspec_tr: Any, opt: Any, mesh) -> Any:
    """Adam/SGD state specs: moment trees follow their params (ZeRO-1 via
    fsdp param specs), step counters replicate."""
    return {k: (pspec_tr if k in ("m", "v", "mom")
                else tree_map(lambda x: replicated(mesh), v))
            for k, v in opt.items()}


def batch_specs(batch: Any, mesh, cfg, strategy: str | None = None) -> Any:
    """Shard the leading (global-batch) dim over the data axes; fsdp and
    replicated training also fold the model axis into the batch so every
    device carries examples. A leading dim that the axes do not divide
    falls back to the data axes alone, then to replication."""
    axes = data_axes(mesh)
    if strategy in ("fsdp", "replicated") and "model" in axis_names(mesh):
        axes = axes + ("model",)

    def spec(x):
        shape = tuple(getattr(x, "shape", ()))
        for cand in (axes, data_axes(mesh)):
            if (cand and len(shape) >= 1
                    and shape[0] % _axis_product(mesh, cand) == 0
                    and shape[0] >= _axis_product(mesh, cand)):
                return placements(mesh, {0: cand})
        return replicated(mesh)

    return tree_map(spec, batch)


def cache_specs(cfg, caches: Any, mesh) -> Any:
    """KV/SSM decode caches: shard the batch dim over the data axes."""
    return batch_specs(caches, mesh, cfg)


def to_named(mesh, tree: Any) -> Any:
    """Bind a spec tree to a ``DeviceMesh``: each leaf becomes
    ``(mesh, placements)``, what ``distribute_tensor`` takes."""
    return tree_map(lambda s: (mesh, tuple(s)), tree)


def _local_shape(shape, mesh, spec: Spec) -> tuple[int, ...]:
    out = list(shape)
    for size, p in zip(mesh.shape, spec):
        if isinstance(p, Shard):
            out[p.dim] //= int(size)
    return tuple(out)


def distribute(mesh, tensors: Any, specs: Any, *,
               local: bool = False) -> Any:
    """Apply a spec tree: every tensor becomes a DTensor on ``mesh`` with
    its placements (``distribute_tensor``). With ``local=True`` each leaf
    is taken as a stand-in of its global shape (``meta`` or fake) and only
    this rank's shard is made, of the same dtype and device kind, and
    wrapped with ``DTensor.from_local``: no scatter, no global copy."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        spec = tuple(spec)
        if not local:
            return distribute_tensor(t, mesh, spec)
        shard = torch.empty(_local_shape(t.shape, mesh, spec),
                            dtype=t.dtype, device=t.device)
        stride = torch.empty(t.shape, device="meta").stride()
        return DTensor.from_local(shard, mesh, spec, run_check=False,
                                  shape=t.shape, stride=stride)

    return tree_map(one, tensors, specs)
