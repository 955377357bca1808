"""Mesh construction (the reference's `repro/launch/mesh.py`).

Functions, not module-level constants: importing this module starts no
process group. `make_production_mesh` builds the dry run's unbound meshes
(spec arithmetic, no processes); `make_host_mesh` binds a (data, model)
mesh to the `torch.distributed` world this process belongs to, one
process per device. The backend and the store are explicit: nothing
chooses one for the caller, and a world that cannot be built raises.
`make_device_mesh` is the other kind: a mesh of this one process's
devices (no world), over which a batched sweep splits its designs.
"""
from __future__ import annotations

import datetime
import inspect
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..dist.sharding import Mesh, axis_subsets, group_members


def make_device_mesh(devices: Optional[Sequence] = None, *,
                     shape: Optional[Sequence[int]] = None,
                     axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A mesh of this process's devices, row-major over `axis_names` (the
    reference's `jax.make_mesh((len(jax.devices()),), ("data",))`).

    devices: each one named (`cuda:i`, or `cpu`); by default every card
    this process sees. A CUDA device must carry its index, a card this
    process does not see raises, and the devices are of one type. A list
    of `cpu` entries stands in for a host of several devices (the CPU has
    one; each entry is a block of the sweep run on it). shape: the
    mesh's sizes, by default (len(devices),)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; name the mesh's devices "
                "(e.g. devices=['cpu'] * 4 runs the plain versions)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a device mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a device mesh mixes device types: "
                         f"{[str(d) for d in devs]}")
    for d in devs:
        if d.type == "cuda":
            if d.index is None:
                raise ValueError("name each card of a device mesh by its "
                                 "index (cuda:i), not 'cuda'")
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if d.index >= n:
                raise RuntimeError(f"{d} does not exist: this process sees "
                                   f"{n} CUDA device(s)")
        elif d.type != "cpu":
            raise ValueError(f"a device mesh takes cpu or cuda devices, "
                             f"not {d}")
    shape = (len(devs),) if shape is None else tuple(int(s) for s in shape)
    if math.prod(shape) != len(devs):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} devices, "
                         f"{len(devs)} given")
    return Mesh(shape, tuple(axis_names), devices=tuple(devs))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def init_world(*, backend: str, init_method: str, rank: int,
               world_size: int, timeout_s: float = 60.0,
               device=None) -> None:
    """`torch.distributed.init_process_group` with every argument given:
    `init_method` a `file://` store or `tcp://host:port`, and a timeout
    after which a collective that waits on a lost peer raises. `device`:
    this process's card in a world of one card per process; it becomes
    the current device before the group forms, and an NCCL group is
    bound to it (`device_id`, where the installed torch takes one)."""
    kw = {}
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                raise ValueError("name the process's card by its index "
                                 "(cuda:i)")
            torch.cuda.set_device(device)
            if backend == "nccl" and "device_id" in inspect.signature(
                    dist.init_process_group).parameters:
                kw["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def bind_mesh(shape, axis_names) -> Mesh:
    """A mesh of `shape` over the initialised world (its size must be the
    world's), with one process group for every set of axes. Every process
    of the world calls this, in the same order as its other groups."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed world: call init_world "
                           "(or init_process_group) first")
    n = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"mesh {tuple(shape)} needs {size} processes, the "
                         f"world has {n}")
    rank = dist.get_rank()
    groups = {}
    for axes in axis_subsets(tuple(axis_names)):
        for members in group_members(tuple(shape), tuple(axis_names), axes):
            g = dist.new_group(members)
            if rank in members:
                groups[axes] = g
    return Mesh(tuple(shape), tuple(axis_names), rank=rank,
                backend=dist.get_backend(), groups=groups)


def make_host_mesh(tp: int = 1, *, backend: Optional[str] = None,
                   init_method: Optional[str] = None,
                   rank: Optional[int] = None,
                   world_size: Optional[int] = None,
                   timeout_s: float = 60.0, device=None) -> Mesh:
    """A (data, model) mesh over this host's world: n processes, tp
    clamped to n as the reference clamps it to its devices. If the world
    is not initialised yet, `backend`, `init_method`, `rank` and
    `world_size` initialise it (all four are required then; `device` as
    `init_world` takes it)."""
    if not dist.is_initialized():
        if None in (backend, init_method, rank, world_size):
            raise ValueError("no torch.distributed world: give backend, "
                             "init_method, rank and world_size")
        init_world(backend=backend, init_method=init_method, rank=rank,
                   world_size=world_size, timeout_s=timeout_s,
                   device=device)
    elif backend is not None and backend != dist.get_backend():
        raise ValueError(f"the world's backend is {dist.get_backend()}, "
                         f"not {backend}")
    n = dist.get_world_size()
    tp = min(tp, n)
    if n % tp:
        raise ValueError(f"{n} processes do not split into tp={tp}")
    return bind_mesh((n // tp, tp), ("data", "model"))
