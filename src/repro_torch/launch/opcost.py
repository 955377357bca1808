"""Dispatch-level cost counter: the port's counterpart of the reference's
`launch/hlocost.py`.

The reference compiles a step and walks XLA's post-SPMD HLO text. PyTorch
has no whole-step graph, so `OpCounter` (a `TorchDispatchMode`) counts
what the step dispatches, per process, as it runs: on meta tensors (the
dry run, `launch/dryrun.py`) or on real ones. Each count stands for one
`HloCost.totals()` quantity:

  flops      : 2 M N K of every mm, addmm, bmm and baddbmm (einsums and
               matmuls reach dispatch as these) and the convolutions,
               by `torch.utils.flop_counter`'s formulas ("flops": every
               dot and convolution). Eager dispatch runs every iteration
               of a Python loop, so a layer stack needs no trip counts.
  hbm_bytes  : result plus operand bytes of the data-moving ops only, the
               reference's perfect-fusion model ("hbm_bytes" over its
               `_COUNT_BYTES_OPS`): products and convolutions, gathers
               (gather, index_select, embedding, index), scatters
               (scatter, scatter_add, index_put, index_add), writes into
               a slice (`copy_` into part of a storage, and the
               slice/select backward), reductions (sum, mean, amax,
               logsumexp, softmax and the like), sorts (sort, topk),
               copies (clone, `_to_copy`) and cat / pad. Views and
               elementwise ops cost nothing, as they would once fused.
  collective : the mesh's per-kind counts (`dist/collectives.py`
               `CollectiveStats.kinds`), its ring traffic per process
               ("collective_bytes", "collectives").

and what the reference takes from XLA's `memory_analysis()`: the bytes
live at once and their peak. Every storage an op returns that was not
seen before is live from then until its last tensor dies (a weakref
finalizer on the storage); the inputs given to `hold` are live from the
start. This counts what the step holds, not what an allocator rounds it
to.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..dist import collectives as col

# the data-moving ops whose operands and result cross HBM
DOT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "convolution",
                     "convolution_backward"})
GATHER_OPS = frozenset({"gather", "index_select", "embedding", "index"})
SCATTER_OPS = frozenset({"scatter", "scatter_", "scatter_add",
                         "scatter_add_", "scatter_reduce", "scatter_reduce_",
                         "index_put", "index_put_", "_index_put_impl_",
                         "index_add", "index_add_",
                         "embedding_dense_backward"})
SLICE_OPS = frozenset({"slice_scatter", "select_scatter", "slice_backward",
                       "select_backward"})
REDUCE_OPS = frozenset({"sum", "mean", "amax", "amin", "max", "min",
                        "argmax", "argmin", "prod", "logsumexp", "var",
                        "std", "var_mean", "linalg_vector_norm", "norm",
                        "any", "all", "cumsum", "_softmax", "_log_softmax",
                        "_softmax_backward_data",
                        "_log_softmax_backward_data"})
SORT_OPS = frozenset({"sort", "topk"})
COPY_OPS = frozenset({"clone", "_to_copy", "copy"})
CONCAT_OPS = frozenset({"cat", "constant_pad_nd"})
BYTE_OPS = (DOT_OPS | GATHER_OPS | SCATTER_OPS | SLICE_OPS | REDUCE_OPS
            | SORT_OPS | COPY_OPS | CONCAT_OPS)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> int:
    """`torch.utils.flop_counter.conv_flop_count`: 2 x batch x the output
    (input, when transposed) positions x the filter x c_out x c_in."""
    batch = x_shape[0]
    positions = (x_shape if transposed else out_shape)[2:]
    c_out, c_in, *filt = w_shape
    return (2 * batch * math.prod(positions) * math.prod(filt) * c_out
            * c_in)


def op_flops(name: str, args, out) -> int:
    """The products' FLOPs of one dispatched op (0 for any other op)."""
    if name == "mm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2 * m * n * k
    if name == "addmm":
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2 * m * n * k
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        bs, m, k = a.shape
        return 2 * bs * m * b.shape[2] * k
    if name == "convolution":
        return _conv_flops(args[0].shape, args[1].shape, out.shape, args[6])
    if name == "convolution_backward":
        # (grad_out, input, weight, bias_sizes, stride, padding, dilation,
        #  transposed, output_padding, groups, output_mask): the input's
        # and the weight's gradients each cost the forward's products
        grad_out, x, w, transposed, mask = (args[0], args[1], args[2],
                                            args[7], args[10])
        one = _conv_flops(x.shape, w.shape, grad_out.shape, transposed)
        return one * (int(mask[0]) + int(mask[1]))
    return 0


def _covers_storage(t: torch.Tensor) -> bool:
    return nbytes(t) >= t.untyped_storage().nbytes()


def op_bytes(name: str, overload: str, args, kwargs, out) -> int:
    """Result plus operand bytes of a data-moving op (0 for the rest)."""
    if name == "copy_":
        # a write into part of a storage: the reference's
        # dynamic-update-slice; a whole-storage copy_ fuses away
        dst, src = args[0], args[1]
        return 0 if _covers_storage(dst) else nbytes(dst) + nbytes(src)
    if name not in BYTE_OPS or (name in ("max", "min")
                                and overload == "other"):
        return 0
    ins, _ = tree_flatten((args, kwargs))
    outs, _ = tree_flatten(out)
    return sum(nbytes(t) for t in ins + outs
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, HBM bytes and live bytes of everything dispatched
    inside `with counter:`; with `mesh`, also that mesh's collectives
    (its stats are reset on entry).

        counter = OpCounter(mesh)
        counter.hold(inputs...)          # live from the start
        with counter:
            out = step(...)
        counter.totals()
    """

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.flops = 0
        self.hbm_bytes = 0
        self.ops: Dict[str, list] = {}       # name -> [calls, flops, bytes]
        self.live = 0
        self.peak = 0
        self.held = 0
        self._storages: Dict[int, int] = {}
        self._held = set()

    # ---- live bytes ------------------------------------------------------
    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor, size: Optional[int] = None) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes() if size is None else int(size)
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key).atexit = False
        return n

    def hold(self, *trees, size: Optional[int] = None) -> int:
        """Mark the tensors of `trees` live from now on (a step's inputs);
        `size` overrides a single tensor's bytes (a global batch of which
        the step keeps its rows). Returns the bytes added."""
        leaves, _ = tree_flatten(trees)
        ts = [t for t in leaves if isinstance(t, torch.Tensor)]
        if size is not None and len(ts) != 1:
            raise ValueError("size= takes exactly one tensor")
        added = sum(self._track(t, size) for t in ts)
        self._held.update(t.untyped_storage()._cdata for t in ts)
        self.held += added
        return added

    def is_held(self, t: torch.Tensor) -> bool:
        """Whether `t` shares its storage with an input given to `hold`."""
        return t.untyped_storage()._cdata in self._held

    # ---- dispatch --------------------------------------------------------
    def __enter__(self):
        if self.mesh is not None:
            col.stats(self.mesh).reset()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        f = op_flops(name, args, out)
        b = op_bytes(name, func._overloadname, args, kwargs, out)
        if f or b:
            self.flops += f
            self.hbm_bytes += b
            rec = self.ops.setdefault(name, [0, 0, 0])
            rec[0] += 1
            rec[1] += f
            rec[2] += b
        leaves, _ = tree_flatten(out)
        for t in leaves:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    # ---- results ---------------------------------------------------------
    def collectives(self) -> list:
        """The reference's `collectives` list: per kind, the calls and the
        ring traffic in bytes, largest first."""
        if self.mesh is None:
            return []
        kinds = col.stats(self.mesh).kinds
        return sorted((dict(kind=k.replace("_", "-"), count=v["calls"],
                            bytes=v["traffic"]) for k, v in kinds.items()),
                      key=lambda a: -a["bytes"])

    def totals(self) -> dict:
        coll = self.collectives()
        return dict(flops=float(self.flops), hbm_bytes=float(self.hbm_bytes),
                    collective_bytes=float(sum(c["bytes"] for c in coll)),
                    collectives=coll, peak_bytes=self.peak,
                    held_bytes=self.held,
                    ops={k: dict(calls=v[0], flops=v[1], bytes=v[2])
                         for k, v in sorted(self.ops.items())})
