"""N:M sparsity modeling (paper Sec. IV); PyTorch port of
`repro.core.sparsity`.

Sparsity lives on the weight operand W[M_rows, K]: each block of `m`
consecutive K-elements in a row holds `n` nonzeros. Layer-wise sparsity uses
one n for the whole layer; row-wise sparsity randomizes n per (row, block)
with n <= m/2 (paper constraint — density beyond m/2 negates the benefit).

Compute model: on a weight-stationary systolic array the compressed weight
stream only loads/streams nonzero reduction rows, so the effective reduction
dim K' shrinks. Columns advance in lockstep, so a fold's K' is the max over
the fold's columns of their nonzero counts (layer-wise: exactly K*n/m).

Storage model (paper Fig. 6): blocked ELLPACK = values + ceil(log2(m))-bit
metadata per value; CSR/CSC also reported for comparison.

Every quantity has a *_model twin taking float32 tensors (or Python
numbers) instead of a SparsityConfig, with no Python branching on config
values: `enabled`/`row_wise` are data (nonzero = on) selected with
`torch.where`, so the batched sweep evaluates mixed dense/sparse design
grids with a leading design axis. The config-taking entry points delegate
to the same models.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .accelerator import SparsityConfig
from .dataflow import cdiv, map_gemm

REPRESENTATIONS = ("ellpack_block", "csr", "csc")

# The fixed j-grid of the row-wise expected-max sum: supports m <= 2*cap
# (SparsityConfig validates row_wise m against this bound so the masked
# sum is always exact, never truncated).
ROWWISE_HALF_CAP = 64


def _device(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _f32(x, dev) -> torch.Tensor:
    """`x` as a float32 tensor (a Python number rounds to float32 once, as
    JAX rounds a weakly typed scalar)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(float(x), dtype=torch.float32, device=dev)


def _on(x, dev) -> torch.Tensor:
    """A 0/1 selector (bool, number or tensor) as a bool tensor."""
    if isinstance(x, torch.Tensor):
        return x != 0
    return torch.tensor(bool(x), device=dev)


def metadata_bits(m: int) -> int:
    return max(1, int(math.ceil(math.log2(m))))


def expected_rowwise_n(m: int) -> float:
    """Row-wise n ~ Uniform{1..m//2}: E[n] = (1 + m//2) / 2."""
    return (1 + m // 2) / 2.0


def effective_K_model(K, n, m, row_wise, cols_in_fold, enabled=True):
    """`effective_K` on tensors: every argument may be a tensor.

    Layer-wise: K' = ceil(K * n / m).
    Row-wise:   per-block fold length is the max over `cols_in_fold` iid
    Uniform{1..m//2} draws; E[max] = m/2 - sum_{j<m/2} (j/(m/2))^c (exact
    for iid uniforms), applied per block of m. The j-sum runs over a fixed
    `ROWWISE_HALF_CAP` grid masked to j < m//2 so m stays data.
    """
    dev = _device(K, n, m, row_wise, cols_in_fold, enabled)
    K = _f32(K, dev)
    n = _f32(n, dev)
    m = torch.clamp_min(_f32(m, dev), 1.0)
    lw = cdiv(K * n, m)
    half, c = torch.broadcast_tensors(
        torch.clamp_min(torch.floor(m / 2.0), 1.0),
        torch.clamp_min(_f32(cols_in_fold, dev), 1.0))
    j = torch.arange(1, ROWWISE_HALF_CAP, dtype=torch.float32, device=dev)
    jb = j.reshape(j.shape + (1,) * half.dim())       # sum axis leads
    terms = torch.where(jb < half, (jb / half) ** c, 0.0)
    emax = half - torch.sum(terms, dim=0)
    rw = torch.ceil(cdiv(K, m) * emax)
    return torch.where(_on(enabled, dev),
                       torch.where(_on(row_wise, dev), rw, lw), K)


def effective_K(K, sp: SparsityConfig, cols_in_fold: int = 1):
    """Effective reduction length K' after N:M compression (config form),
    through `effective_K_model`'s float32 math."""
    if not sp.enabled:
        return K
    k_eff = effective_K_model(K, sp.n, sp.m, sp.row_wise, cols_in_fold)
    return k_eff if isinstance(K, torch.Tensor) else int(k_eff)


def sparse_compute_cycles_model(dataflow: str, M, N, K, R, C,
                                n, m, row_wise, enabled=True):
    """Compute cycles with compressed weight streaming, on tensors.
    `dataflow` is static. Dense designs (enabled == 0) reduce exactly to
    `dataflow.compute_cycles`."""
    K_eff = effective_K_model(K, n, m, row_wise, cols_in_fold=C,
                              enabled=enabled)
    Sr, Sc, T = map_gemm(dataflow, M, N, K_eff)
    return (2 * R + C + T - 2) * cdiv(Sr, R) * cdiv(Sc, C)


def sparse_compute_cycles(dataflow: str, M, N, K, R: int, C: int,
                          sp: SparsityConfig):
    """Compute cycles with compressed weight streaming (ws recommended)."""
    return sparse_compute_cycles_model(dataflow, M, N, K, R, C, sp.n, sp.m,
                                       sp.row_wise, enabled=sp.enabled)


def storage_bytes_model(rows, K, n, m, row_wise, representation: str,
                        word_bytes, enabled=True):
    """`storage_report`'s byte math on tensors (representation and nothing
    else is static). Returns (original, values, metadata, total) with the
    dense fallback already selected where enabled == 0."""
    dev = _device(rows, K, n, m, row_wise, word_bytes, enabled)
    rows = _f32(rows, dev)
    K = _f32(K, dev)
    n = _f32(n, dev)
    m = torch.clamp_min(_f32(m, dev), 1.0)
    wb = _f32(word_bytes, dev)
    dense = rows * K * wb
    exp_n = (1.0 + torch.floor(m / 2.0)) / 2.0        # E[Uniform{1..m//2}]
    nnz = torch.where(_on(row_wise, dev), rows * (K / m) * exp_n,
                      rows * K * n / m)
    if representation == "ellpack_block":
        bits = torch.clamp_min(torch.ceil(torch.log2(m)), 1.0)
        meta = nnz * bits / 8.0
    elif representation == "csr":
        idx_bytes = torch.clamp_min(torch.ceil(
            torch.ceil(torch.log2(torch.clamp_min(K, 2.0))) / 8.0), 1.0)
        meta = nnz * idx_bytes + (rows + 1.0) * 4.0
    elif representation == "csc":
        idx_bytes = torch.clamp_min(torch.ceil(
            torch.ceil(torch.log2(torch.clamp_min(rows, 2.0))) / 8.0), 1.0)
        meta = nnz * idx_bytes + (K + 1.0) * 4.0
    else:
        raise ValueError(f"unknown representation {representation!r}")
    values = nnz * wb
    en = _on(enabled, dev)
    return (dense, torch.where(en, values, dense),
            torch.where(en, meta, 0.0),
            torch.where(en, values + meta, dense))


def storage_report(rows: int, K: int, sp: SparsityConfig,
                   word_bytes: int = 2) -> Dict[str, float]:
    """SPARSE_REPORT: original vs compressed filter storage in bytes."""
    orig, values, meta, total = storage_bytes_model(
        rows, K, sp.n, sp.m, sp.row_wise, sp.representation, word_bytes,
        enabled=sp.enabled)
    return dict(representation=sp.representation if sp.enabled else "dense",
                original_bytes=float(orig), values_bytes=float(values),
                metadata_bytes=float(meta), total_bytes=float(total))


def sample_rowwise_counts(generator: torch.Generator, rows: int, K: int,
                          m: int) -> torch.Tensor:
    """(rows, K//m) int32 nonzero counts, Uniform{1..m//2} (trace
    fidelity), drawn from `generator` on its device.

    The reference draws from `jax.random.randint`'s threefry stream; a
    `torch.Generator` cannot reproduce those bits, so the two agree in
    distribution (dtype, shape, range, mean `expected_rowwise_n(m)`), not
    draw for draw."""
    blocks = K // m
    half = max(1, m // 2)
    return torch.randint(1, half + 1, (rows, blocks), generator=generator,
                         dtype=torch.int32, device=generator.device)


def pack_ellpack_block(w: torch.Tensor, m: int):
    """Reference blocked-ELLPACK packer (Fig. 6): (values, indices, counts).

    w: (rows, K); the trailing K % m columns are dropped. Values
    (rows, K//m, max count) hold each block's nonzeros first, in order;
    indices their intra-block positions (int32), -1 past a block's count;
    counts (rows, K//m) int32. The kernels' oracle and the tests use it.
    """
    rows, K = w.shape
    blocks = K // m
    wb = w[:, :blocks * m].reshape(rows, blocks, m)
    nz = wb != 0
    # stable order: nonzeros first, preserving index order (sorted as
    # uint8 0/1 keys, the same order as the bool mask's)
    order = torch.argsort((~nz).to(torch.uint8), dim=-1, stable=True)
    vals = torch.take_along_dim(wb, order, dim=-1)
    idx = torch.where(torch.take_along_dim(nz, order, dim=-1), order,
                      -1).to(torch.int32)
    counts = nz.sum(-1, dtype=torch.int32)
    keep = int(counts.max()) if counts.numel() else 0
    return vals[..., :keep], idx[..., :keep], counts
