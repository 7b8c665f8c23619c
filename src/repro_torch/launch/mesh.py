"""Production and host meshes.

Functions, not module constants: importing this module opens no process
group.

Mesh shapes (the reference's, for 256 or 512 devices):
  single-pod : (16, 16)    axes (data, model)        = 256 devices
  multi-pod  : (2, 16, 16) axes (pod, data, model)   = 512 devices

``data`` doubles as the FL client axis; ``pod`` is the cross-pod data/client
axis, so hierarchical aggregation reduces within a pod first. On H100 hosts
of 8 cards joined by NVLink, a 16-wide ``model`` axis spans two 8-card
NVLink domains: its collectives cross the hosts' network between them.

``make_production_mesh`` builds the mesh over the "fake" process group
(one rank that stands in for all of them, no communication), which it
opens when no group is open: the dry-run traces a production step on it
without a card. ``make_host_mesh`` builds the mesh over the cards really
present.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_fake_process_group(world_size: int) -> None:
    """Open the "fake" process group of ``world_size`` ranks as rank 0,
    unless a group is already open (whose size must then match)."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is open; "
                f"this mesh needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def close_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]
                   ) -> DeviceMesh:
    """A CPU ``DeviceMesh`` of ``shape`` over the fake process group."""
    n = 1
    for s in shape:
        n *= int(s)
    init_fake_process_group(n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_host_mesh(model_parallel: int = 1) -> DeviceMesh:
    """(cards // model_parallel, model_parallel) mesh over the CUDA cards
    present, axes (data, model): a 1 x 1 mesh on one H100. Raises when
    ``model_parallel`` does not divide the cards present (more than there
    are, in particular), as the reference's ``jax.make_mesh`` does. A mesh
    of more than one card needs a process group of that many ranks, one
    process per card, opened by the caller."""
    n = torch.cuda.device_count()
    if model_parallel < 1 or n < model_parallel or n % model_parallel:
        raise ValueError(
            f"model_parallel {model_parallel} needs a multiple of "
            f"{model_parallel} CUDA cards; {n} present")
    if n > 1 and not (dist.is_initialized() and dist.get_world_size() == n):
        raise RuntimeError(
            f"a mesh over {n} cards needs a process group of {n} ranks "
            "(torch.distributed.init_process_group, one process per card)")
    if not dist.is_initialized():  # one card: an in-process store
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh("cuda", (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))
