"""Collectives over named mesh axes, differentiable where the forward
uses them (the reference gets these from XLA's SPMD partitioner and from
`jax.lax` inside its `shard_map` bodies).

Every function takes the tensor, the mesh and the axes: a name or a tuple
of names in mesh order. A dimension gathered or scattered over a tuple of
axes is cut into blocks in the order of their block index (the first
axis major), the layout of a spec entry (`dist/sharding.py`).

Gradients follow one rule: the loss of a sharded step is the sum of the
processes' own losses, and each collective's backward is its adjoint
under that sum. So all-gather's backward is a reduce-scatter, the other
way round, a sum all-reduce's backward is a sum all-reduce, and
all-to-all's backward is the all-to-all back. A value every process of
an axis holds in copy (replicated compute) carries, in the backward, a
share of its gradient on each process; the shares add up wherever they
meet a collective or, for a parameter, in the step's gradient all-reduce
over the axes the parameter is not sharded on (`models/zoo.py`).

Backends: NCCL and gloo both take CUDA and CPU tensors here. An
all-to-all runs as `all_to_all_single` on every backend (gloo has no
list-form all-to-all). A collective that fails raises.

A dry mesh (`Mesh(sizes, names, rank=0, backend="dry")`, the dry run's
`launch/dryrun.py`) stands for one process of a mesh that does not
exist: it has no groups, and each collective returns an empty meta tensor
of its result's shape, counted as the real one would be. It takes meta
tensors only; a tensor anywhere else raises.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from .sharding import Mesh

# the backend name of a mesh with no processes behind it (the dry run's)
DRY = "dry"


def ring_traffic(name: str, g: int) -> float:
    """Bytes one process sends per byte of a collective's input, by the
    ring algorithm over a group of g (the reference's `_ring_factor` in
    `launch/hlocost.py`, which scales the shape XLA prints: the gathered
    shape for an all-gather, the scattered shard for a reduce-scatter;
    here the base is the input, the shard and the whole respectively)."""
    if g <= 1:
        return 0.0
    if name == "all_gather":
        return float(g - 1)
    if name == "all_reduce":
        return 2.0 * (g - 1) / g
    if name in ("reduce_scatter", "all_to_all"):
        return (g - 1) / g
    raise ValueError(f"unknown collective {name!r}")


@dataclasses.dataclass
class CollectiveStats:
    """Per-process counts of one mesh's collectives: calls, seconds spent
    inside them and bytes sent in. On a gloo mesh the device is
    synchronized before and after a collective on a CUDA tensor (gloo
    makes the host wait for the tensor anyway), so `seconds` holds the
    collectives alone, not the device work queued before them; on NCCL
    it is the host's time to enqueue them, unless `sync` is set: then the
    device is synchronized around every collective on a CUDA tensor on
    any backend, and `seconds` is the collectives' own time there too.
    `kinds` splits the calls and bytes by collective and adds each one's
    ring traffic (`ring_traffic`: the bytes this process sends)."""
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0
    kinds: dict = dataclasses.field(default_factory=dict)
    sync: bool = False

    def reset(self) -> None:
        self.calls, self.seconds, self.bytes = 0, 0.0, 0
        self.kinds = {}

    def count(self, name: str, nbytes: int, g: int) -> None:
        k = self.kinds.setdefault(name, dict(calls=0, bytes=0, traffic=0.0))
        k["calls"] += 1
        k["bytes"] += nbytes
        k["traffic"] += nbytes * ring_traffic(name, g)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def stats(mesh: Mesh) -> CollectiveStats:
    s = getattr(mesh, "_stats", None)
    if s is None:
        s = mesh._stats = CollectiveStats()
    return s


def _run(mesh: Mesh, name: str, axes, x: torch.Tensor, fn, shape):
    """fn(x), or on a dry mesh an empty meta tensor of the result's
    `shape`. Counts the call."""
    st = stats(mesh)
    nbytes = x.numel() * x.element_size()
    if mesh.backend == DRY:
        if x.device.type != "meta":
            raise ValueError(f"a dry mesh takes meta tensors only, not one "
                             f"on {x.device}")
        y = torch.empty(shape, dtype=x.dtype, device="meta")
    else:
        sync = (mesh.backend == "gloo" or st.sync) and x.is_cuda
        if sync:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        y = fn(x)
        if sync:
            torch.cuda.synchronize(x.device)
        st.seconds += time.perf_counter() - t0
    st.calls += 1
    st.bytes += nbytes
    st.count(name, nbytes, mesh.axes_size(axes))
    return y


def _raw_all_gather(mesh, axes, x, dim):
    n = mesh.axes_size(axes)
    if n == 1:
        return x

    def fn(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=mesh.group(axes))
        return torch.cat(parts, dim)
    shape = list(x.shape)
    shape[dim] *= n
    return _run(mesh, "all_gather", axes, x, fn, shape)


def _raw_reduce_scatter(mesh, axes, x, dim):
    n = mesh.axes_size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} processes")

    def fn(t):
        ins = [c.contiguous() for c in t.chunk(n, dim)]
        out = torch.empty_like(ins[0])
        dist.reduce_scatter(out, ins, group=mesh.group(axes))
        return out
    shape = list(x.shape)
    shape[dim] //= n
    return _run(mesh, "reduce_scatter", axes, x, fn, shape)


def _raw_all_reduce(mesh, axes, x, op):
    if mesh.axes_size(axes) == 1:
        return x

    def fn(t):
        t = t.contiguous().clone()
        dist.all_reduce(t, op=op, group=mesh.group(axes))
        return t
    return _run(mesh, "all_reduce", axes, x, fn, x.shape)


def _raw_all_to_all(mesh, axes, x, split_dim, cat_dim):
    n = mesh.axes_size(axes)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} processes")

    def fn(t):
        # all_to_all_single sends block j of dim 0 to process j
        ins = t.movedim(split_dim, 0).contiguous()
        out = torch.empty_like(ins)
        dist.all_to_all_single(out, ins, group=mesh.group(axes))
        return torch.cat([b.movedim(0, split_dim) for b in out.chunk(n, 0)],
                         cat_dim)
    shape = list(x.shape)
    shape[split_dim] //= n
    shape[cat_dim] *= n
    return _run(mesh, "all_to_all", axes, x, fn, shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _raw_all_gather(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _raw_reduce_scatter(mesh, axes, g, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _raw_reduce_scatter(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _raw_all_gather(mesh, axes, g, dim), None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _raw_all_reduce(mesh, axes, x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _raw_all_reduce(mesh, axes, g, dist.ReduceOp.SUM), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, cat_dim):
        ctx.args = (mesh, axes, split_dim, cat_dim)
        return _raw_all_to_all(mesh, axes, x, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, cat_dim = ctx.args
        return (_raw_all_to_all(mesh, axes, g, cat_dim, split_dim),
                None, None, None, None)


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of all processes over `axes`, concatenated along `dim`
    in block order. Backward: reduce-scatter."""
    axes = mesh.ordered(axes)
    if mesh.axes_size(axes) == 1:
        return x
    return _AllGather.apply(x, mesh, axes, dim % x.ndim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int
                   ) -> torch.Tensor:
    """The sum over `axes`, of which this process keeps its block along
    `dim`. Backward: all-gather."""
    axes = mesh.ordered(axes)
    if mesh.axes_size(axes) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axes, dim % x.ndim)


def all_reduce(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum over `axes`. Backward: the sum of the gradients."""
    axes = mesh.ordered(axes)
    if mesh.axes_size(axes) == 1:
        return x
    return _AllReduceSum.apply(x, mesh, axes)


def all_reduce_max(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The elementwise maximum over `axes`, detached (no gradient flows
    through a maximum taken for scaling)."""
    axes = mesh.ordered(axes)
    return _raw_all_reduce(mesh, axes, x.detach(), dist.ReduceOp.MAX)


def all_to_all(x: torch.Tensor, mesh: Mesh, axes, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """Block j of `x` along `split_dim` goes to the process of block index
    j over `axes`; the blocks received are concatenated along `cat_dim`
    in block order. Backward: the all-to-all back."""
    axes = mesh.ordered(axes)
    if mesh.axes_size(axes) == 1:
        return x
    return _AllToAll.apply(x, mesh, axes, split_dim % x.ndim,
                           cat_dim % x.ndim)


def local_block(x: torch.Tensor, mesh: Mesh, axes, dim: int
                ) -> torch.Tensor:
    """This process's block of `x` along `dim` over `axes` (no traffic)."""
    axes = mesh.ordered(axes)
    n = mesh.axes_size(axes)
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} processes")
    b = size // n
    return x.narrow(dim, mesh.axes_index(axes) * b, b)
