"""Mesh context: one object naming the mesh axes and the logical->physical
axis rules used by every model, launcher and test (the reference's
`repro/dist/sharding.py`, on `torch.distributed`).

Axis conventions (launch/mesh.py):
  single pod : (data, model)
  multi-pod  : (pod, data, model)   -- "pod" is an outer data-parallel axis

Logical parameter axes (models/params.ParamDef.logical):
  "fsdp"   -> the FSDP weight-shard axis ("data")
  "tp"     -> the tensor-parallel axis ("model")
  "batch"  -> all data-parallel axes (("pod", "data") when multi-pod)
  "kv_len" -> cache length sharded over the model axis (decode caches)

A `Mesh` is the port's own: axis names and sizes, and, once bound to a
`torch.distributed` world, one process group per set of axes and this
process's coordinates. Processes are laid out row-major over the axes
(the last axis varies fastest), as `jax.make_mesh` lays out devices, so a
dimension sharded over ("pod", "data") is cut into pod x data contiguous
blocks, the pod index major. An unbound mesh has no processes and serves
spec arithmetic alone (the 16 x 16 and 2 x 16 x 16 production meshes).

A mesh may instead name devices of this one process (`devices`, row-major
over the axes; `launch/mesh.py::make_device_mesh`): the reference's
`jax.make_mesh((len(jax.devices()),), ("data",))`, over which a batched
design sweep splits its designs, one block a device.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple, Union

AxisEntry = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), an axis name, or a tuple
    of axis names (sharded over their product, the first one major)."""

    def __new__(cls, *entries: AxisEntry):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def entry_axes(entry: AxisEntry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Mesh:
    """Axis names and sizes; bound to a process world, also its groups.

    shape: {axis name: size} in axis order (the reference reads
    `mesh.shape[name]`). `rank` is this process's rank in the world and
    `backend` the world's backend, both None for an unbound mesh.
    `devices`: for a mesh of this process's devices, one `torch.device`
    per mesh position in row-major order (None otherwise)."""

    def __init__(self, sizes: Tuple[int, ...], axis_names: Tuple[str, ...],
                 *, rank: Optional[int] = None, backend: Optional[str] = None,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None,
                 devices: Optional[Tuple[object, ...]] = None):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.rank = rank
        self.backend = backend
        self._groups = groups or {}
        self.devices = None if devices is None else tuple(devices)
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def bound(self) -> bool:
        return self.rank is not None

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: index} of `rank` (this process by default), row-major."""
        r = self.rank if rank is None else rank
        if r is None:
            raise RuntimeError("an unbound mesh has no process coordinates")
        out = {}
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def ordered(self, axes) -> Tuple[str, ...]:
        """`axes` (a name, a tuple or None) as a tuple, checked to be mesh
        axes in mesh order (a sharded dimension's block order)."""
        axes = entry_axes(axes)
        pos = [self.axis_names.index(a) for a in axes]
        if pos != sorted(pos) or len(set(pos)) != len(pos):
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.axis_names}")
        return axes

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.ordered(axes))

    def axes_index(self, axes) -> int:
        """This process's block index over `axes` (the first one major)."""
        c = self.coords()
        i = 0
        for a in self.ordered(axes):
            i = i * self.shape[a] + c[a]
        return i

    def group(self, axes):
        """The process group of this process over `axes` (its members
        ordered by their block index over those axes)."""
        axes = self.ordered(axes)
        if not self.bound:
            raise RuntimeError("an unbound mesh has no process groups")
        return self._groups[axes]

    def __repr__(self) -> str:
        if self.devices is not None:
            return (f"Mesh({self.shape}, devices "
                    f"{[str(d) for d in self.devices]})")
        kind = (f"bound rank {self.rank}, {self.backend}" if self.bound
                else "unbound")
        return f"Mesh({self.shape}, {kind})"


def axis_subsets(axis_names: Tuple[str, ...]):
    """Every non-empty set of axes, each in mesh order: the groups a bound
    mesh creates (all processes create them in this order)."""
    for n in range(1, len(axis_names) + 1):
        yield from itertools.combinations(axis_names, n)


def group_members(sizes: Tuple[int, ...], axis_names: Tuple[str, ...],
                  axes: Tuple[str, ...]):
    """Each group over `axes` as its list of world ranks, ordered by the
    block index over `axes`; one list per coordinate of the other axes."""
    shape = dict(zip(axis_names, sizes))
    others = [a for a in axis_names if a not in axes]
    out = []
    for fixed in itertools.product(*(range(shape[a]) for a in others)):
        c = dict(zip(others, fixed))
        ranks = []
        for moving in itertools.product(*(range(shape[a]) for a in axes)):
            c.update(zip(axes, moving))
            r = 0
            for a in axis_names:
                r = r * shape[a] + c[a]
            ranks.append(r)
        out.append(ranks)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: a mesh and a spec (the reference's jax NamedSharding)."""
    mesh: Mesh
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class MeshCtx:
    """Everything the model stack needs to know about the device mesh."""
    mesh: Mesh
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp_axis: Optional[str] = "data"
    tp_axis: Optional[str] = "model"
    # the port's own: the global batch of the step being run (the steps
    # set it; a sharded MoE layer's token count depends on it), None for
    # spec arithmetic
    batch: Optional[int] = None

    def with_batch(self, batch: int) -> "MeshCtx":
        return dataclasses.replace(self, batch=int(batch))

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.mesh.axis_names

    @property
    def dp(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def tp(self) -> int:
        return self.mesh.shape[self.tp_axis] if self.tp_axis else 1

    def sharding(self, spec: PartitionSpec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    # ---- the port's own: this process's place on the mesh ---------------
    @property
    def tp_rank(self) -> int:
        return self.mesh.coords()[self.tp_axis] if self.tp_axis else 0

    def batch_entry(self, batch: int) -> AxisEntry:
        """The spec entry of a leading batch dimension of size `batch`:
        the dp axes when they divide it, else replicated (the reference's
        `batch_shardings` and batch-1 cache rule)."""
        if batch % self.dp:
            return None
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]


def make_mesh_ctx(mesh: Mesh) -> MeshCtx:
    """Build a MeshCtx from a mesh created by launch/mesh.py (or any mesh
    using the data/model[/pod] naming convention)."""
    names = tuple(mesh.axis_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    return MeshCtx(
        mesh=mesh,
        dp_axes=dp_axes or (names[0],),
        fsdp_axis="data" if "data" in names else None,
        tp_axis="model" if "model" in names else None,
    )


def logical_to_spec(ctx: MeshCtx, *logical: Optional[str]
                    ) -> Tuple[AxisEntry, ...]:
    """Map logical axis names to physical mesh axes (one entry per dim).

    Unknown names map to None (replicated) so new logical axes degrade
    gracefully instead of crashing the launchers.
    """
    rules = {
        "fsdp": ctx.fsdp_axis,
        "tp": ctx.tp_axis,
        "batch": ctx.dp_axes if len(ctx.dp_axes) > 1 else
                 (ctx.dp_axes[0] if ctx.dp_axes else None),
        "kv_len": ctx.tp_axis,
    }
    return tuple(rules.get(a) if a is not None else None for a in logical)
