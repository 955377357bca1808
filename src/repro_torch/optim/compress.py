"""Gradient compression for the cross-pod data-parallel all-reduce
(`repro/optim/compress.py`).

Per-leaf symmetric int8 quantization with error feedback: the residual
(g - dequant(quant(g))) is carried to the next step, so compression bias
vanishes in expectation. One scale per leaf of the reference's tree: a
stacked block weight shares one scale over all its layers. Rounding is
half to even (`torch.round`, as `jnp.round`). Sharded (a spec tree and
its bound mesh given), a leaf's scale is the maximum over the whole
logical leaf: the blocks' maxima are all-reduced over the axes the leaf
is sharded on.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..dist import collectives as col
from ..models.params import tree_map

PyTree = Any
F32 = torch.float32


def int8_compress(g: torch.Tensor, mesh=None, axes=()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale); `axes`: the mesh axes `g` is one
    block of the leaf over (the scale is the whole leaf's)."""
    gf = g.to(F32)
    amax = torch.amax(torch.abs(gf))
    if axes:
        amax = col.all_reduce_max(amax, mesh, axes)
    scale = amax / amax.new_tensor(127.0) + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    dtype=F32) -> torch.Tensor:
    return (q.to(F32) * scale).to(dtype)


def compress_decompress(grads: PyTree, residuals: Optional[PyTree] = None,
                        specs: PyTree = None, mesh=None
                        ) -> Tuple[PyTree, PyTree]:
    """Quantize and dequantize each leaf with error feedback; returns
    (the compressed-equivalent grads in each leaf's dtype, the new float32
    residuals). The inputs are not modified. specs, mesh: `grads` holds
    this process's blocks, cut by the spec tree `specs` on `mesh`."""
    from .adamw import sharded_axes
    if residuals is None:
        residuals = tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                                   device=g.device), grads)
    if specs is None:
        specs = tree_map(lambda g: (), grads)

    def one(g, r, sp):
        gf = g.to(F32) + r
        q, s = int8_compress(gf, mesh, sharded_axes(sp, mesh) if sp else ())
        deq = int8_decompress(q, s)
        return deq.to(g.dtype), gf - deq

    pairs = tree_map(one, grads, residuals, specs)
    newg = tree_map(lambda t: t[0], pairs)
    newr = tree_map(lambda t: t[1], pairs)
    return newg, newr
