"""The PyTorch port's feature sweep at `trace` fidelity on the CPU against
the JAX reference: a randomized mixed dense / sparse / multi-core / layout
grid replays streams generated from the effective compute window and the
sparsity-shrunk traffic, and its frame matches the reference's per column
within 1e-3. (Kept apart from `test_torch_feature_sweep.py`, whose grids
share its helpers, so the two files run on separate test workers.)"""
from repro.trace import TraceSpec as RTraceSpec
from test_torch_feature_sweep import OPS, _assert_parity, _mixed_designs, \
    _studies


def test_randomized_mixed_grid_parity_trace():
    designs = _mixed_designs(7, n=6, arrays=(16, 32))
    port, ref = _studies(designs, {"w": OPS[:2]}, "trace",
                         spec=RTraceSpec(cap=1024))
    res = port.run(device="cpu")
    assert res.meta["engine"] == "torch:plain"
    _assert_parity(res, ref.run())
