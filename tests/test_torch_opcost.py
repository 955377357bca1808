"""The dispatch-level cost counter (`repro_torch.launch.opcost`), the twins
of `tests/test_hlocost.py`'s four cases, and the collectives' dry mode
(`repro_torch.dist.collectives` on a `backend="dry"` mesh)."""
import pytest
import torch

from repro_torch.dist import collectives as col
from repro_torch.launch.dryrun import dry_mesh
from repro_torch.launch.opcost import OpCounter


def _count(fn, *inputs, mesh=None):
    counter = OpCounter(mesh)
    counter.hold(*inputs)
    with counter:
        out = fn(*inputs)
    return counter, out


# ---- the twins of test_hlocost.py ---------------------------------------------

def test_loop_flops_are_n_times_one_layer():
    x = torch.randn(128, 256)
    w = torch.randn(256, 256)

    def stacked(x, w):
        h = x
        for _ in range(10):
            h = torch.tanh(h @ w)
        return h

    c, _ = _count(stacked, x, w)
    assert c.flops == 2 * 128 * 256 * 256 * 10
    assert c.totals()["ops"]["mm"]["calls"] == 10


def test_grad_flops_counted():
    # one product: its backward takes one product per differentiable input
    x = torch.randn(128, 256, requires_grad=True)
    w = torch.randn(256, 256, requires_grad=True)
    one = 2 * 128 * 256 * 256
    c, _ = _count(lambda x, w: (x @ w).sum().backward(), x, w)
    assert c.flops == 3 * one                 # forward + two gradients

    # a 4-layer stack differentiated in w alone: 4 forward products, a
    # weight gradient per layer and an input gradient for all but the
    # first (x takes none)
    xs = torch.randn(128, 256)

    def train(x, w):
        h = x
        for _ in range(4):
            h = torch.tanh(h @ w)
        torch.sum(h * h).backward()

    c, _ = _count(train, xs, w)
    assert c.flops == (4 + 4 + 3) * one


def test_single_matmul_bytes():
    a = torch.randn(512, 512)
    b = torch.randn(512, 512)
    c, _ = _count(lambda a, b: a @ b, a, b)
    assert c.hbm_bytes == 3 * 512 * 512 * 4
    assert c.totals()["hbm_bytes"] == 3 * 512 * 512 * 4


def test_no_collectives_on_single_device():
    mesh = dry_mesh((1, 1), ("data", "model"))
    x = torch.empty(64, 64, device="meta")

    def step(x):
        y = x @ x
        return col.all_reduce(col.all_gather(y, mesh, "model", 0), mesh,
                              ("data", "model"))

    c, _ = _count(step, x, mesh=mesh)
    t = c.totals()
    assert t["collective_bytes"] == 0.0 and t["collectives"] == []
    assert t["flops"] == 2 * 64 ** 3


# ---- the perfect-fusion byte model and live bytes ---------------------------

def test_views_and_elementwise_ops_move_no_bytes():
    x = torch.randn(64, 32)
    c, _ = _count(lambda x: (x.t().reshape(32, 64) * 2 + 1).exp(), x)
    assert c.hbm_bytes == 0 and c.flops == 0


def test_data_moving_ops_count_result_and_operands():
    x = torch.randn(64, 32)
    idx = torch.arange(16)

    c, _ = _count(lambda x: x.sum(-1), x)
    assert c.hbm_bytes == 64 * 32 * 4 + 64 * 4
    c, _ = _count(lambda x, i: x[i], x, idx)
    assert c.hbm_bytes == 64 * 32 * 4 + 16 * 8 + 16 * 32 * 4
    c, _ = _count(lambda x: torch.cat([x, x]), x)
    assert c.hbm_bytes == 4 * 64 * 32 * 4
    c, _ = _count(lambda x: x.to(torch.bfloat16), x)
    assert c.hbm_bytes == 64 * 32 * (4 + 2)


def test_copy_into_a_slice_counts_a_whole_copy_does_not():
    buf = torch.zeros(8, 64)
    row = torch.randn(64)
    c, _ = _count(lambda b, r: b[3].copy_(r), buf, row)
    assert c.hbm_bytes == 2 * 64 * 4
    c, _ = _count(lambda b, s: b.copy_(s), buf, torch.randn(8, 64))
    assert c.hbm_bytes == 0


def test_peak_follows_live_storages():
    x = torch.empty(1024, device="meta")             # 4 KiB held

    def step(x):
        a = x * 2                                     # + 4 KiB
        b = a.view(32, 32)                            # a view: nothing new
        del a
        c = torch.cat([b.reshape(-1), x])             # + 8 KiB: peak 16
        del b                                         # a's storage freed
        return c.sum()

    counter, out = _count(step, x)
    assert counter.held == 4096
    assert counter.peak == 4096 + 4096 + 8192
    assert counter.live == 4096 + 4                   # x and the sum
    assert counter.is_held(x) and not counter.is_held(out)


def test_inputs_with_a_size_count_as_their_rows():
    c = OpCounter()
    assert c.hold(torch.empty(8, 4, device="meta"), size=64) == 64
    with pytest.raises(ValueError):
        c.hold(torch.empty(1), torch.empty(1), size=4)


# ---- dry-mode collectives -----------------------------------------------------

@pytest.fixture
def mesh():
    m = dry_mesh((2, 2), ("data", "model"))
    col.stats(m).reset()
    return m


def test_dry_collectives_return_meta_tensors_of_the_result_shape(mesh):
    x = torch.empty(8, 6, dtype=torch.bfloat16, device="meta")
    assert col.all_gather(x, mesh, "model", 0).shape == (16, 6)
    assert col.all_gather(x, mesh, ("data", "model"), 1).shape == (8, 24)
    assert col.reduce_scatter(x, mesh, "model", 0).shape == (4, 6)
    assert col.all_reduce(x, mesh, "data").shape == (8, 6)
    assert col.all_reduce_max(x, mesh, "model").shape == (8, 6)
    y = col.all_to_all(x, mesh, ("data", "model"), 0, 1)
    assert y.shape == (2, 24) and y.device.type == "meta"
    assert y.dtype == torch.bfloat16
    # a size-1 axis set is no collective at all
    one = dry_mesh((1, 4), ("data", "model"))
    assert col.all_gather(x, one, "data", 0) is x


def test_dry_collectives_count_traffic_by_the_ring_factors(mesh):
    x = torch.empty(8, 6, device="meta")            # 192 bytes
    col.all_gather(x, mesh, "model", 0)             # g 2: (g-1) x shard
    col.reduce_scatter(x, mesh, ("data", "model"), 0)   # g 4: (g-1)/g
    col.all_reduce(x, mesh, "data")                 # 2 (g-1)/g
    col.all_to_all(x, mesh, ("data", "model"), 0, 1)    # (g-1)/g
    k = col.stats(mesh).kinds
    assert k["all_gather"] == dict(calls=1, bytes=192, traffic=192.0)
    assert k["reduce_scatter"]["traffic"] == 192 * 3 / 4
    assert k["all_reduce"]["traffic"] == 192.0
    assert k["all_to_all"]["traffic"] == 192 * 3 / 4
    st = col.stats(mesh)
    assert st.calls == 4 and st.bytes == 4 * 192
    # the reference's factors on the shapes XLA prints: the gathered shape
    # for an all-gather, the scattered shard for a reduce-scatter
    assert col.ring_traffic("all_gather", 2) * 192 == 384 * (2 - 1) / 2
    assert col.ring_traffic("reduce_scatter", 4) * 192 == 48 * (4 - 1)
    assert col.ring_traffic("all_reduce", 1) == 0.0


def test_dry_collectives_refuse_tensors_off_meta(mesh):
    with pytest.raises(ValueError, match="meta"):
        col.all_gather(torch.zeros(4, 4), mesh, "model", 0)
    with pytest.raises(ValueError, match="meta"):
        col.all_reduce(torch.zeros(4), mesh, "data")


def test_dry_collectives_differentiate_as_the_real_ones(mesh):
    w = torch.empty(4, 6, device="meta", requires_grad=True)
    col.all_gather(w, mesh, ("data", "model"), 0).sum().backward()
    assert w.grad.shape == (4, 6)
    k = col.stats(mesh).kinds
    assert k["all_gather"]["calls"] == 1
    assert k["reduce_scatter"]["calls"] == 1       # the adjoint


def test_counter_reports_the_mesh_s_collectives_by_kind(mesh):
    x = torch.empty(16, 16, device="meta")

    def step(x):
        return col.all_reduce(col.all_gather(x, mesh, "model", 0) @ x,
                              mesh, "data")

    c, _ = _count(step, x, mesh=mesh)
    t = c.totals()
    kinds = {e["kind"]: e for e in t["collectives"]}
    assert set(kinds) == {"all-gather", "all-reduce"}
    assert kinds["all-gather"]["bytes"] == 16 * 16 * 4
    assert t["collective_bytes"] == sum(e["bytes"] for e in kinds.values())
