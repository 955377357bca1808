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

Backends: NCCL takes CUDA tensors, gloo CPU tensors. On a mesh built with
gloo, a CUDA tensor goes to the host for every collective gloo does not
take on CUDA tensors (`GLOO_CUDA_NATIVE`) and back; this is decided by the
mesh's backend, never as a retry, and the bytes are counted
(`CollectiveStats.staged_bytes`). A collective that fails raises.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from .sharding import Mesh

# the collectives gloo runs on CUDA tensors itself (probed on an H100 with
# torch 2.11: all-to-all raises "Backend gloo does not support alltoall");
# every other one is staged through the host
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "all_gather", "reduce_scatter"})


@dataclasses.dataclass
class CollectiveStats:
    """Per-process counts of one mesh's collectives: calls, seconds spent
    inside them, bytes sent in, and bytes staged through the host. On a
    gloo mesh the device is synchronized before and after a collective on
    a CUDA tensor (gloo makes the host wait for the tensor anyway), so
    `seconds` holds the collectives alone, not the device work queued
    before them; on NCCL it is the host's time to enqueue them."""
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0
    staged_bytes: int = 0

    def reset(self) -> None:
        self.calls, self.seconds, self.bytes, self.staged_bytes = 0, 0.0, 0, 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def stats(mesh: Mesh) -> CollectiveStats:
    s = getattr(mesh, "_stats", None)
    if s is None:
        s = mesh._stats = CollectiveStats()
    return s


def _run(mesh: Mesh, name: str, x: torch.Tensor, fn):
    """fn(x) on the host when the mesh's backend does not take `x` where
    it lies; counts the call."""
    st = stats(mesh)
    sync = mesh.backend == "gloo" and x.is_cuda
    if sync:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    nbytes = x.numel() * x.element_size()
    staged = sync and name not in GLOO_CUDA_NATIVE
    if staged:
        y = fn(x.cpu())
        st.staged_bytes += nbytes + y.numel() * y.element_size()
        y = y.to(x.device)
    else:
        y = fn(x)
    if sync:
        torch.cuda.synchronize(x.device)
    st.calls += 1
    st.bytes += nbytes
    st.seconds += time.perf_counter() - t0
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
    return _run(mesh, "all_gather", x, fn)


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
    return _run(mesh, "reduce_scatter", x, fn)


def _raw_all_reduce(mesh, axes, x, op):
    if mesh.axes_size(axes) == 1:
        return x

    def fn(t):
        t = t.contiguous().clone()
        dist.all_reduce(t, op=op, group=mesh.group(axes))
        return t
    return _run(mesh, "all_reduce", x, fn)


def _raw_all_to_all(mesh, axes, x, split_dim, cat_dim):
    n = mesh.axes_size(axes)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} processes")

    def fn(t):
        ins = [c.contiguous() for c in t.chunk(n, split_dim)]
        outs = [torch.empty_like(c) for c in ins]
        dist.all_to_all(outs, ins, group=mesh.group(axes))
        return torch.cat(outs, cat_dim)
    return _run(mesh, "all_to_all", x, fn)


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
