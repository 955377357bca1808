"""The PyTorch port's traced feature models on the CPU against the JAX
reference: N:M sparsity (`core.sparsity`), the partition equations
(`core.partition`) and the multi-core split (`core.multicore`) give the
reference's numbers on the same numpy-made inputs: floats within 1e-6
relative, integer shares exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multicore as rmc
from repro.core import partition as rpart
from repro.core import sparsity as rsp
from repro.core.accelerator import AcceleratorConfig as RConfig
from repro.core.accelerator import CoreConfig as RCore
from repro.core.accelerator import SparsityConfig as RSparsity
from repro_torch.core import multicore as tmc
from repro_torch.core import partition as tpart
from repro_torch.core import sparsity as tsp
from repro_torch.core.accelerator import AcceleratorConfig, CoreConfig
from repro_torch.core.accelerator import NocConfig, SparsityConfig

RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol)


def _grid():
    """A mixed grid of (K, n, m, row_wise, cols, enabled) columns."""
    rng = np.random.default_rng(0)
    n_pts = 400
    m = rng.choice([2, 4, 8, 16, 32, 64, 128], n_pts).astype(np.float32)
    n = np.maximum(1, np.floor(rng.random(n_pts) * m / 2)).astype(np.float32)
    K = rng.choice([1, 63, 64, 197, 768, 3072, 4096, 151_936],
                   n_pts).astype(np.float32)
    cols = rng.choice([1, 2, 8, 32, 128], n_pts).astype(np.float32)
    rw = (rng.random(n_pts) < 0.5).astype(np.float32)
    en = (rng.random(n_pts) < 0.8).astype(np.float32)
    return K, n, m, rw, cols, en


def test_effective_k_model_matches_on_mixed_grid():
    """Within 1e-6 relative; the row-wise ceil of a 63-term float32 sum may
    land one unit apart from XLA's at a boundary, which the tolerance of
    the per-column frame comparison (1e-3) absorbs."""
    cols = _grid()
    got = tsp.effective_K_model(*(torch.from_numpy(c) for c in cols))
    want = rsp.effective_K_model(*(jnp.asarray(c) for c in cols))
    a, b = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(a - b) <= np.maximum(RTOL * b, 1.0))
    assert np.mean(a == b) > 0.99


@pytest.mark.parametrize("K,n,m,rw,cols", [
    (1024, 2, 4, False, 1), (1024, 1, 4, False, 32), (1024, 2, 8, True, 32),
    (4096, 1, 4, True, 1), (4096, 4, 8, True, 128), (768, 3, 8, False, 8)])
def test_effective_k_and_sparse_cycles_match(K, n, m, rw, cols):
    sp = SparsityConfig(enabled=True, n=n, m=m, row_wise=rw)
    rsp_cfg = RSparsity(enabled=True, n=n, m=m, row_wise=rw)
    assert tsp.effective_K(K, sp, cols) == rsp.effective_K(K, rsp_cfg, cols)
    assert tsp.effective_K(K, SparsityConfig(), cols) == K
    for df in ("ws", "os", "is"):
        got = tsp.sparse_compute_cycles(df, 512, 197, K, 32, cols, sp)
        want = rsp.sparse_compute_cycles(df, 512, 197, K, 32, cols, rsp_cfg)
        _close(float(got), float(want))


@pytest.mark.parametrize("rep", ["ellpack_block", "csr", "csc"])
def test_storage_bytes_model_matches(rep):
    K, n, m, rw, _, en = _grid()
    rows = np.random.default_rng(1).choice(
        [1, 64, 768, 4096], K.shape).astype(np.float32)
    got = tsp.storage_bytes_model(torch.from_numpy(rows), torch.from_numpy(K),
                                  torch.from_numpy(n), torch.from_numpy(m),
                                  torch.from_numpy(rw), rep, 2,
                                  enabled=torch.from_numpy(en))
    want = rsp.storage_bytes_model(jnp.asarray(rows), jnp.asarray(K),
                                   jnp.asarray(n), jnp.asarray(m),
                                   jnp.asarray(rw), rep, 2,
                                   enabled=jnp.asarray(en))
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    for sp in (SparsityConfig(enabled=True, n=1, m=4, representation=rep),
               SparsityConfig(enabled=True, n=2, m=8, row_wise=True,
                              representation=rep), SparsityConfig()):
        rs = RSparsity(**{f: getattr(sp, f) for f in
                          ("enabled", "n", "m", "row_wise",
                           "representation")})
        assert tsp.storage_report(768, 3072, sp) == \
            pytest.approx(rsp.storage_report(768, 3072, rs), rel=RTOL)
    with pytest.raises(ValueError, match="representation"):
        tsp.storage_bytes_model(1.0, 1.0, 1.0, 4.0, 0.0, "coo", 2)


def test_sparsity_helpers_match():
    for m in (2, 3, 4, 8, 16, 128):
        assert tsp.metadata_bits(m) == rsp.metadata_bits(m)
        assert tsp.expected_rowwise_n(m) == rsp.expected_rowwise_n(m)
    assert tsp.ROWWISE_HALF_CAP == rsp.ROWWISE_HALF_CAP


@pytest.mark.parametrize("df", ["ws", "os", "is"])
def test_partition_equations_and_plans_match(df):
    for (M, N, K) in [(64, 3136, 576), (1000, 1, 768), (197, 197, 64),
                      (4096, 128, 1024)]:
        Sr, Sc, T = rpart.map_gemm(df, M, N, K)
        for scheme in tpart.SCHEMES:
            for Pr, Pc in tpart.factor_pairs(16):
                assert tpart.partition_cycles(scheme, 32, 16, Sr, Sc, T,
                                              Pr, Pc) == \
                    rpart.partition_cycles(scheme, 32, 16, Sr, Sc, T, Pr, Pc)
                for dedup in (False, True):
                    assert tpart.partition_footprint(
                        scheme, df, Sr, Sc, T, Pr, Pc, dedup) == \
                        rpart.partition_footprint(scheme, df, Sr, Sc, T, Pr,
                                                  Pc, dedup)
        got = tpart.enumerate_plans(df, M, N, K, 32, 32, 8)
        want = rpart.enumerate_plans(df, M, N, K, 32, 32, 8)
        assert [tuple(vars(p).values()) for p in got] == \
            [tuple(vars(p).values()) for p in want]
        for obj in ("cycles", "footprint"):
            assert vars(tpart.best_plan(df, M, N, K, 16, 16, 4, obj)) == \
                vars(rpart.best_plan(df, M, N, K, 16, 16, 4, obj))
    # tensor inputs give the integer results in float32
    t = tpart.partition_cycles("st1", torch.tensor(32.0), torch.tensor(16.0),
                               torch.tensor(768.0), torch.tensor(197.0),
                               torch.tensor(3072.0), 2, 2)
    assert float(t) == rpart.partition_cycles("st1", 32, 16, 768, 197,
                                              3072, 2, 2)


@pytest.mark.parametrize("total,rates,offsets", [
    (1000, [1.0, 1.0, 2.0], [0.0, 0.0, 0.0]),
    (1000, [1.0, 1.0], [0.0, 500.0]),
    (7, [1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]),      # exact ties
    (10, [3.0, 3.0, 3.0], [1.0, 1.0, 1.0]),               # exact ties
    (10_000_000, [1.0, 1.0, 2.0], [0.0, 0.0, 0.0]),
    ((1 << 24) - 3, [1.0, 3.0, 7.0], [0.0, 2.0, 5.0]),    # near 2^24
    ((1 << 24) + 5, [1.0, 1.0, 2.0], [0.0, 0.0, 0.0]),    # past 2^24
    (3, [1.0, 2.0, 4.0, 8.0], [0.0, 1e6, 0.0, 0.0]),
])
def test_nonuniform_split_matches_exactly(total, rates, offsets):
    got = tmc.nonuniform_split(total, rates, offsets)
    assert got == rmc.nonuniform_split(total, rates, offsets)
    assert all(s >= 0 for s in got)


def test_split_shares_model_batched_ties_match():
    rng = np.random.default_rng(4)
    a = rng.choice([1.0, 2.0, 3.0], (4, 50)).astype(np.float32)
    b = rng.choice([0.0, 0.0, 7.0, 100.0], (4, 50)).astype(np.float32)
    total = rng.choice([5.0, 64.0, 197.0, 4095.0, 16_777_000.0],
                       50).astype(np.float32)
    got = tmc.split_shares_model(torch.from_numpy(total), torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()
    want = np.asarray(rmc.split_shares_model(jnp.asarray(total),
                                             jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


def _configs():
    """Homogeneous and heterogeneous grids, with and without NoP hops, in
    both packages."""
    out = []
    for (Pr, Pc, rows, cols, hops, nop) in [
            (2, 2, [32] * 4, [32] * 4, [0, 0, 0, 0], 2.0),
            (2, 2, [32] * 4, [32] * 4, [0, 1, 1, 2], 2.0),
            (1, 3, [64, 32, 16], [64, 32, 16], [0, 1, 2], 4.0),
            (2, 2, [32, 64, 16, 32], [16, 64, 32, 32], [0, 2, 1, 3], 8.0),
            (4, 4, [32] * 16, [32] * 16, list(range(16)), 1.0)]:
        out.append(tuple(
            C(cores=tuple(K(rows=r, cols=c, nop_hops=h)
                          for r, c, h in zip(rows, cols, hops)),
              mesh_rows=Pr, mesh_cols=Pc, nop_cycles_per_hop=nop)
            for C, K in ((AcceleratorConfig, CoreConfig), (RConfig, RCore))))
    return out


@pytest.mark.parametrize("df", ["ws", "os", "is"])
def test_simulate_multicore_matches(df):
    for cfg, rcfg in _configs():
        cfg, rcfg = cfg.with_(dataflow=df), rcfg.with_(dataflow=df)
        for (M, N, K) in [(512, 2048, 4096), (64, 3136, 576), (1000, 1, 768)]:
            for scheme in tpart.SCHEMES:
                got = tmc.simulate_multicore(cfg, M, N, K, scheme)
                want = rmc.simulate_multicore(rcfg, M, N, K, scheme)
                assert got.per_core_share == want.per_core_share
                _close(got.per_core_cycles, want.per_core_cycles)
                assert (got.l2_fit, got.footprint_l1, got.reduce_elems) == \
                    (want.l2_fit, want.footprint_l1, want.reduce_elems)
            assert vars(tmc.best_multicore(cfg, M, N, K)) == \
                pytest.approx(vars(rmc.best_multicore(rcfg, M, N, K)),
                              rel=RTOL)


def test_batched_multicore_models_match():
    """The sweep's layout: per-core columns (designs, 1, cores) against
    (ops,) GEMM dims, every scheme and the best-scheme makespan."""
    rng = np.random.default_rng(9)
    D, P = 6, 4
    rows = rng.choice([16, 32, 64], (D, 1, P)).astype(np.float32)
    cols = rng.choice([16, 32, 64], (D, 1, P)).astype(np.float32)
    hops = rng.choice([0, 1, 2, 3], (D, 1, P)).astype(np.float32)
    nop = rng.choice([0.0, 2.0, 8.0], (D, 1)).astype(np.float32)
    M = np.array([64, 768, 1000, 4096], np.float32)
    N = np.array([3136, 197, 1, 128], np.float32)
    K = np.array([576, 768, 768, 1024], np.float32)
    t = [torch.from_numpy(x) for x in (M, N, K, rows, cols, hops, nop)]
    for df in ("ws", "os", "is"):
        for scheme in tpart.SCHEMES:
            got = tmc.multicore_model(df, scheme, *t[:6], t[6], 2, 2)
            for i in range(D):
                want = rmc.multicore_model(
                    df, scheme, jnp.asarray(M), jnp.asarray(N),
                    jnp.asarray(K), jnp.asarray(rows[i, 0]),
                    jnp.asarray(cols[i, 0]), jnp.asarray(hops[i, 0]),
                    jnp.float32(nop[i, 0]), 2, 2)
                _close(got[0][i].numpy(), want[0])
                _close(got[1][:, i].numpy(), want[1])
                np.testing.assert_array_equal(got[2][:, i].numpy(),
                                              np.asarray(want[2]))
        best = tmc.best_multicore_cycles_model(df, *t[:6], t[6], 2, 2)
        assert best.shape == (D, 4)
        for i in range(D):
            _close(best[i].numpy(), rmc.best_multicore_cycles_model(
                df, jnp.asarray(M), jnp.asarray(N), jnp.asarray(K),
                jnp.asarray(rows[i, 0]), jnp.asarray(cols[i, 0]),
                jnp.asarray(hops[i, 0]), jnp.float32(nop[i, 0]), 2, 2))


@pytest.mark.parametrize("topology", ["mesh", "torus", "ring"])
def test_effective_nop_hops_routes_the_noc(topology):
    """Config hops with the NoC off; routed hops with it on, as the
    reference's; a single core keeps its config hops either way."""
    cfg, rcfg = _configs()[1]
    assert list(tmc.effective_nop_hops(cfg)) == [0.0, 1.0, 1.0, 2.0]
    on = cfg.with_(noc=NocConfig(enabled=True, topology=topology))
    ron = RConfig.from_dict(on.to_dict())
    np.testing.assert_array_equal(tmc.effective_nop_hops(on),
                                  rmc.effective_nop_hops(ron))
    one = AcceleratorConfig(cores=(CoreConfig(rows=32, cols=32,
                                              nop_hops=3),),
                            noc=NocConfig(enabled=True, topology=topology))
    assert list(tmc.effective_nop_hops(one)) == [3.0]
