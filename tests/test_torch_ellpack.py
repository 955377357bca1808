"""The PyTorch port's ELLPACK plane on the CPU against the JAX reference:
the packer's plain version against the Pallas kernel (interpret mode) and
`ellpack_pack_reference`, `pack_ellpack_block`, `pack_with_report` and
`sample_rowwise_counts`, and the inputs of each of the CUDA kernel's two
paths. The same seeded numpy matrices go to both; values
and indices must be equal exactly. Inputs are finite: the Pallas kernel
selects through a one-hot contraction, which spreads a NaN or +-Inf over
its block, and the port copies values (ROADMAP section 3). The CUDA kernel
itself is held against the plain version on the card
(`test_torch_cuda.py`, `chip_smoke.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as rsp
from repro.kernels import ellpack as rell
from repro_torch.core import sparsity as tsp
from repro_torch.kernels import ellpack as tell


def _pruned(seed, rows, K, m, n_max=None, p=0.4):
    """A float32 (rows, K) matrix whose m-blocks keep at most n_max of
    their nonzeros (all of them when n_max is None)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((rows, K)).astype(np.float32)
    w[rng.random((rows, K)) >= p] = 0.0
    if n_max is not None:
        wb = w.reshape(rows, K // m, m)
        nz = wb != 0
        rank = np.cumsum(nz, -1) - nz
        w = np.where(rank < n_max, wb, 0.0).reshape(rows, K)
    return w


def _equal(got, want):
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        g = g.to(torch.float32).numpy() if g.is_floating_point() \
            else g.numpy()
        assert g.shape == w_.shape
        np.testing.assert_array_equal(g, w_.astype(g.dtype))


@pytest.mark.parametrize("rows,K,m", [(16, 32, 4), (64, 64, 8), (33, 48, 4)])
def test_pack_matches_pallas_kernel_and_reference(rows, K, m):
    """The reference kernel test's cases (N <= M/2 per block)."""
    w = _pruned(rows + K, rows, K, m, n_max=m // 2)
    want = rell.ellpack_pack(jnp.asarray(w), m=m, interpret=True)
    got = tell.pack_ellpack(torch.from_numpy(w), m=m)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _equal(got, want)
    _equal(got, rell.ellpack_pack_reference(jnp.asarray(w), m=m))
    _equal(tell.ellpack_pack_reference(torch.from_numpy(w), m=m), want)


@pytest.mark.parametrize("m,keep", [(4, 0), (4, 3), (8, 0), (8, 6), (2, 1)])
def test_blocks_with_more_than_keep_nonzeros(m, keep):
    """Dense and half-dense blocks: a block with more than `keep` nonzeros
    keeps its first `keep`; one with fewer pads with 0 and -1."""
    w = _pruned(m * 10 + keep, 24, 8 * m, m, p=0.8)
    w[0] = 1.0 + np.arange(8 * m)                  # every block full
    w[1] = 0.0                                     # every block empty
    want = rell.ellpack_pack(jnp.asarray(w), m=m, keep=keep, interpret=True)
    got = tell.pack_ellpack(torch.from_numpy(w), m=m, keep=keep)
    _equal(got, want)
    _equal(tell.ellpack_pack_reference(torch.from_numpy(w), m=m, keep=keep),
           want)
    k = keep or max(1, m // 2)
    assert got[1].shape[-1] == k
    np.testing.assert_array_equal(got[1][0, 0].numpy(), np.arange(k))
    assert bool((got[1][1] == -1).all())


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_pack_half_precision_matches_pallas_kernel(dt):
    w = _pruned(3, 20, 64, 8, n_max=4)
    jw = jnp.asarray(w, getattr(jnp, dt))
    tw = torch.from_numpy(w).to(getattr(torch, dt))
    got = tell.pack_ellpack(tw, m=8)
    assert got[0].dtype == tw.dtype
    _equal(got, rell.ellpack_pack(jw, m=8, interpret=True))


# (m, keep, dtype): every vector instance's element size and block width,
# and the scalar path's keep and m (which path the CUDA kernel takes for
# each is held in `tests/test_torch_emulated.py`)
PATH_CASES = [(2, 1, "float32"), (4, 2, "float32"), (8, 4, "float32"),
              (16, 4, "float32"), (16, 1, "float32"), (4, 2, "bfloat16"),
              (16, 2, "float16"), (2, 1, "bfloat16"), (4, 3, "float32"),
              (8, 6, "float16"), (8, 8, "float32"), (6, 3, "float32")]


@pytest.mark.parametrize("m,keep,dt", PATH_CASES,
                         ids=[f"m{c[0]}-k{c[1]}-{c[2]}" for c in PATH_CASES])
def test_each_path_choice_matches_pallas_kernel(m, keep, dt):
    """The inputs the CUDA kernel's two paths take, through the plain
    version against the Pallas kernel: full blocks (more than keep
    nonzeros), empty blocks and negative zeros, aligned and as a view one
    element into its buffer (which always takes the scalar path)."""
    rows, K = 12, 8 * m
    w = _pruned(m * 16 + keep, rows, K, m, p=0.6)
    w[0] = 1.0 + np.arange(K)
    w[1] = 0.0
    w[2, ::3] = -0.0
    buf = torch.zeros(rows * K + 1, dtype=getattr(torch, dt))
    buf[1:] = torch.from_numpy(w.reshape(-1)).to(buf.dtype)
    offset = buf[1:].view(rows, K)
    aligned = offset.clone()
    want = rell.ellpack_pack(jnp.asarray(w, getattr(jnp, dt)), m=m,
                             keep=keep, interpret=True)
    for x in (aligned, offset):
        got = tell.pack_ellpack(x, m=m, keep=keep)
        assert got[0].dtype == x.dtype
        _equal(got, want)
    assert bool((got[1][1] == -1).all())
    np.testing.assert_array_equal(got[1][0, 0].numpy(), np.arange(keep))


def test_negative_zero_is_zero_and_bad_inputs_raise():
    w = np.array([[-0.0, 2.0, -0.0, -3.0, 0.0, -0.0, 0.0, 5.0]], np.float32)
    want = rell.ellpack_pack(jnp.asarray(w), m=4, interpret=True)
    got = tell.pack_ellpack(torch.from_numpy(w), m=4)
    _equal(got, want)
    np.testing.assert_array_equal(got[1].numpy(), [[[1, 3], [3, -1]]])
    with pytest.raises(ValueError, match="multiple of m"):
        tell.pack_ellpack(torch.zeros((2, 10)), m=4)
    with pytest.raises(TypeError, match="64-bit"):
        tell.pack_ellpack(torch.zeros((2, 8), dtype=torch.float64), m=4)
    with pytest.raises(TypeError, match="bool"):
        tell.pack_ellpack(torch.zeros((2, 8), dtype=torch.bool), m=4)
    with pytest.raises(TypeError, match="complex"):
        tell.pack_ellpack(torch.zeros((2, 8), dtype=torch.complex64), m=4)


@pytest.mark.parametrize("dt", ["int8", "uint8", "int16", "int32"])
@pytest.mark.parametrize("m,keep", [(4, 2), (8, 4), (8, 3)])
def test_pack_integers_matches_pallas_kernel(dt, m, keep):
    """Integer matrices, full range, the most negative value among them
    (the sign bit alone: nonzero), blocks fuller than keep and empty ones:
    values (in w's dtype) and indices equal to the Pallas kernel's in
    interpret mode and to the sort-based reference's."""
    rng = np.random.default_rng(m * 10 + keep + len(dt))
    info = np.iinfo(dt)
    rows, K = 24, 12 * m
    w = rng.integers(info.min, int(info.max) + 1, (rows, K)).astype(dt)
    w[rng.random((rows, K)) < 0.5] = 0
    w[0, ::3] = info.min
    w[1] = 0
    want = rell.ellpack_pack(jnp.asarray(w), m=m, keep=keep, interpret=True)
    tw = torch.from_numpy(w)
    got = tell.pack_ellpack(tw, m=m, keep=keep)
    assert got[0].dtype == tw.dtype and str(want[0].dtype) == dt
    _equal(got, want)
    ref = tell.ellpack_pack_reference(tw, m=m, keep=keep)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("rows,K,m", [(16, 32, 4), (9, 50, 4), (12, 64, 8),
                                      (0, 16, 4)])
def test_pack_ellpack_block_matches_reference(rows, K, m):
    """Including a K that is not a multiple of m (the tail is dropped) and
    an empty matrix."""
    w = _pruned(rows * K + 1, rows, K, m, p=0.5) if rows else \
        np.zeros((0, K), np.float32)
    want = rsp.pack_ellpack_block(jnp.asarray(w), m)
    got = tsp.pack_ellpack_block(torch.from_numpy(w), m)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32
    _equal(got, want)


@pytest.mark.parametrize("m,keep,dt", [(4, 0, "float32"), (8, 0, "bfloat16"),
                                       (8, 2, "float16")])
def test_pack_with_report_matches_reference(m, keep, dt):
    w = _pruned(m + keep, 48, 16 * m, m, n_max=m // 2)
    rv, ri, r_rep = rell.pack_with_report(jnp.asarray(w, getattr(jnp, dt)),
                                          m=m, keep=keep, interpret=True)
    tv, ti, t_rep = tell.pack_with_report(
        torch.from_numpy(w).to(getattr(torch, dt)), m=m, keep=keep)
    _equal((tv, ti), (rv, ri))
    assert t_rep == r_rep


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_sample_rowwise_counts_distribution(m):
    """Not the reference's draws (threefry bits are not reproducible with
    a torch.Generator): the same dtype, shape and range, and a mean within
    5 standard errors of E[n] = (1 + m//2) / 2."""
    rows, K = 200, 64 * m
    got = tsp.sample_rowwise_counts(torch.Generator().manual_seed(m), rows,
                                    K, m)
    ref = rsp.sample_rowwise_counts(jax.random.PRNGKey(m), rows, K, m)
    assert got.dtype == torch.int32 and str(ref.dtype) == "int32"
    assert tuple(got.shape) == tuple(ref.shape) == (rows, K // m)
    half = max(1, m // 2)
    for c in (got.numpy(), np.asarray(ref)):
        assert c.min() >= 1 and c.max() <= half
    exp = tsp.expected_rowwise_n(m)
    assert exp == rsp.expected_rowwise_n(m)
    se = np.sqrt((half ** 2 - 1) / 12.0 / got.numel())
    assert abs(float(got.double().mean()) - exp) <= 5 * se + 1e-12
    # seeded: the same generator state gives the same counts
    again = tsp.sample_rowwise_counts(torch.Generator().manual_seed(m), rows,
                                      K, m)
    assert torch.equal(got, again)
