"""Device meshes (the port of ``repro.launch.mesh``).

    make_production_mesh(multi_pod=False) -> DeviceMesh (16, 16) ("data", "model")
                                             or (2, 16, 16) ("pod", "data", "model")
    make_local_mesh(data=None, model=1)   -> DeviceMesh over the ranks that exist
    fake_world(n)                         -> context: a process group of n ranks
                                             on the "fake" backend
    gloo_world(rank, n, store_path)       -> context: rank of a CPU gloo world

A mesh is a named :class:`~torch.distributed.device_mesh.DeviceMesh` over
an initialized process group, so a function, never a module constant.
:func:`fake_world` is the counterpart of the reference's
``--xla_force_host_platform_device_count``: one process stands for rank 0
of ``n`` ranks, collectives move nothing, and with tensors on the ``meta``
device a step of a full-size model on a 256-rank mesh dispatches on any
host without allocating (the dry run, :mod:`repro_torch.launch.dryrun`).

The reference's ``set_mesh_compat`` (a trace-time mesh context) has no
counterpart: the port passes the mesh explicitly, and to the model's
activation constraints through ``cfg.act_spec``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "named_mesh",
           "mesh_axes", "batch_axes", "fake_world", "gloo_world"]


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks on the ``"fake"`` backend for the
    duration of the block (this process is rank 0).  Raises if a process
    group is already initialized: a fake world never shares a process
    with a real one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; a fake "
                           "world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def gloo_world(rank: int, world_size: int, store_path: str):
    """This process as ``rank`` of a CPU world of ``world_size`` gloo
    ranks that meet through a ``FileStore`` at ``store_path`` (no port to
    pick or collide on), for the duration of the block.  A world that
    fails to form raises."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def named_mesh(device_type: str, shape: tuple[int, ...],
               axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the current
    world (on a fake world: without binding a device)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialize one (or enter "
                           "fake_world) before building a mesh")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    if dist.get_backend() == "fake":
        # no device to bind: the mesh only names the device type, so a
        # fake world of "cuda" ranks needs no GPU
        return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                          mesh_dim_names=axes)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over the current world (256 or 512 ranks) of
    ``device_type`` ranks.  On a fake world a ``"cuda"`` mesh needs no GPU
    and makes DTensor plan the collectives it runs on cards (a ``"cpu"``
    mesh trades the all-to-all for an all-gather, as gloo has none)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return named_mesh(device_type, shape, axes)


def make_local_mesh(data: int | None = None, model: int = 1,
                    device: str | torch.device | None = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks of the current world on
    ``device``'s type (default ``"cuda"``, which raises without a GPU);
    ``data`` defaults to the world size over ``model``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialize one before "
                           "building a local mesh")
    data = data or dist.get_world_size() // model
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)  # this rank's card, before the mesh
    return named_mesh(dev.type, (data, model), ("data", "model"))


def mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch: ('pod', 'data') when pods exist."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
