"""The batched sweep sharded over a mesh of devices, and the sharded
weight draw, on the CPU: the counterparts of tests/test_api.py's
`test_sweep_sharded_over_host_mesh`, tests/test_study.py's
`test_sharded_vs_unsharded_equality` and tests/test_farm.py's
`test_worker_mesh_mode_matches_plain`. A list of `cpu` entries stands in
for the reference's forced host devices: each entry runs its block of a
group's designs, through the kernels' plain versions. The sharded frame equals the unsharded one bit for bit, and
the reference's frame within 1e-3 per column."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.api as rapi
from repro.api import preset_grid as r_preset_grid
from repro.api.presets import as_sparsity as r_as_sparsity
from repro.api.presets import get_preset as r_get_preset
from repro.core.engine import simulate_network as r_simulate_network
from repro.core.workloads import Op as ROp
from repro_torch.api import Simulator, Study, get_preset, preset_grid
from repro_torch.api.presets import as_sparsity
from repro_torch.configs import get_config
from repro_torch.core.workloads import Op
from repro_torch.dist.sharding import Mesh, make_mesh_ctx
from repro_torch.farm import Broker, FarmClient, Worker
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import params as pm
from repro_torch.models.zoo import ModelBundle
from repro_torch.trace.generator import TraceSpec

CPU4 = ["cpu"] * 4
OPS = [Op("a", 256, 1024, 512), Op("b", 512, 197, 768, count=3.0)]
COLUMNS = ("total_cycles", "compute_cycles", "stall_cycles", "dram_bytes",
           "energy_pj", "utilization", "edp")


def _ref_ops(ops):
    return [ROp(**dataclasses.asdict(o)) for o in ops]


def _close(got, ref, rtol=1e-3):
    for k in COLUMNS:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, err_msg=k)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the mesh ---------------------------------------------------------------

def test_device_mesh_names_its_devices():
    mesh = make_device_mesh(CPU4)
    assert mesh.size == 4 and mesh.shape == {"data": 4}
    assert mesh.devices == (torch.device("cpu"),) * 4 and not mesh.bound
    m2 = make_device_mesh(CPU4, shape=(4, 1), axis_names=("data", "model"))
    assert m2.shape == {"data": 4, "model": 1}
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="does not exist"):
        make_device_mesh([f"cuda:{n}"])
    with pytest.raises(ValueError, match="index"):
        make_device_mesh(["cuda"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_device_mesh(["cpu"] * 3, shape=(2, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="name the mesh's devices"):
            make_device_mesh()


def test_mesh_and_device_must_agree():
    study = (Study().designs(preset_grid(array=[8, 16]))
             .workloads({"w": OPS[:1]}).fidelity("fast"))
    with pytest.raises(ValueError, match="not one of the mesh's"):
        study.run(mesh=make_device_mesh(CPU4), device="meta")
    with pytest.raises(ValueError, match="mesh of devices"):
        study.run(mesh=Mesh((2, 2), ("data", "model")))
    res = study.run(mesh=make_device_mesh(CPU4), device="cpu")
    assert res.meta["device"] == "cpu"


# ---- the sweep --------------------------------------------------------------

def test_sweep_sharded_over_device_mesh():
    """3 designs over 4 devices (one padded copy of the last design), each
    held to the reference's per-op engine and the unsharded sweep."""
    grid = preset_grid(array=[8, 16, 32], sram_mb=[1.0])
    rgrid = r_preset_grid(array=[8, 16, 32], sram_mb=[1.0])
    sim = Simulator(device="cpu")
    res = sim.sweep(grid, OPS[:1], mesh=make_device_mesh(CPU4))
    plain = sim.sweep(grid, OPS[:1])
    assert len(res) == 3 and res.batched
    for k in ("total_cycles", "energy_pj", "stall_cycles", "utilization"):
        assert np.array_equal(getattr(res, k), getattr(plain, k)), k
    for i in range(3):
        rep = r_simulate_network(rgrid[i], _ref_ops(OPS[:1]))
        assert res.total_cycles[i] == pytest.approx(rep.total_cycles,
                                                    rel=1e-3)


def test_sharded_vs_unsharded_equality():
    grid = preset_grid(array=[8, 16, 32], sram_mb=[1.0])
    rgrid = r_preset_grid(array=[8, 16, 32], sram_mb=[1.0])

    def mk():
        return (Study().designs(grid).workloads({"wa": OPS[:1]})
                .fidelity("fast"))
    plain = mk().run(device="cpu")
    shard = mk().run(mesh=make_device_mesh(CPU4))
    assert shard.equals(plain) and shard.fraction_batched == 1.0
    ref = (rapi.Study().designs(rgrid).workloads({"wa": _ref_ops(OPS[:1])})
           .fidelity("fast").run())
    _close(shard, ref)


def _trace_designs():
    """Seven trace designs in one group (layout on): two arrays, dense and
    2:4, and SIMD widths that leave a design's stream unchanged, ordered
    so that every block of 2 over four devices holds streams another
    block holds too, and the last block is the pad's."""
    out = {}
    for lanes in (64, 128, 256):
        for a, sp in ((32, None), (64, "2:4")):
            cfg = get_preset("table-v-corner", array=a, layout_banks=16)
            ref = r_get_preset("table-v-corner", array=a, layout_banks=16)
            cfg = cfg.with_(cores=(dataclasses.replace(
                cfg.cores[0], simd_lanes=lanes),),
                sparsity=as_sparsity(sp))
            ref = ref.with_(cores=(dataclasses.replace(
                ref.cores[0], simd_lanes=lanes),),
                sparsity=r_as_sparsity(sp))
            out[f"a{a}-{sp or 'dense'}-l{lanes}"] = (cfg, ref)
    out["a32-dense-l512"] = (
        out["a32-dense-l64"][0].with_(cores=(dataclasses.replace(
            out["a32-dense-l64"][0].cores[0], simd_lanes=512),)),
        out["a32-dense-l64"][1].with_(cores=(dataclasses.replace(
            out["a32-dense-l64"][1].cores[0], simd_lanes=512),)))
    return out


def test_trace_group_with_shared_streams_over_the_mesh():
    """At trace fidelity each block replays the streams its designs
    reference (re-indexed for the block); streams shared across blocks,
    a block without a sparse design and the pad leave every design's
    values as the unsharded sweep's, bit for bit, and within 1e-3 of the
    reference's."""
    designs = _trace_designs()
    ops = OPS + [Op("v", kind="vector", vector_elems=8192.0, count=2.0)]
    spec = TraceSpec(cap=256)

    def mk():
        return (Study().designs({k: c for k, (c, _) in designs.items()})
                .workloads({"w": ops}).fidelity("fast", "trace")
                .options(trace_spec=spec))
    plan = mk().plan()
    assert [len(g.cells) for g in plan.groups] == [7, 7]
    plain = mk().run(device="cpu")
    shard = mk().run(mesh=make_device_mesh(CPU4))
    assert shard.equals(plain)
    assert shard.meta["engine"] == "torch:plain"
    from repro.trace.generator import TraceSpec as RTraceSpec
    ref = (rapi.Study().designs({k: r for k, (_, r) in designs.items()})
           .workloads({"w": _ref_ops(ops)}).fidelity("fast", "trace")
           .options(trace_spec=RTraceSpec(cap=256)).run())
    _close(shard, ref)


def test_a_failing_block_fails_its_group_only(monkeypatch):
    """A block that raises fails its whole group's cells (the group is one
    call: its later blocks are not run), and the other group runs."""
    import repro_torch.api.simulator as tsim
    real = tsim._sweep_block
    calls = []

    def flaky(cfgs, ops, *a, device, **kw):
        calls.append(device)
        if ops[0].name == "a" and len(calls) == 2:
            raise RuntimeError("lost card")
        return real(cfgs, ops, *a, device=device, **kw)
    monkeypatch.setattr(tsim, "_sweep_block", flaky)
    res = (Study().designs(preset_grid(array=[8, 16, 32]))
           .workloads({"wa": OPS[:1], "wb": OPS[1:]}).fidelity("fast")
           .run(mesh=make_device_mesh(CPU4)))
    failed = res.filter(workload="wa")
    assert np.all(failed["cell_status"] == 1.0)
    assert np.all(res.filter(workload="wb")["cell_status"] == 0.0)
    assert len(calls) == 2 + 4


# ---- the farm worker --------------------------------------------------------

def _drive(broker, workers, client, sid, max_rounds=50):
    broker.step()
    for _ in range(max_rounds):
        if client.status(sid).get("state") != "running":
            return
        for w in workers:
            w.step()
        broker.step()
    raise AssertionError(f"farm did not settle: {client.status(sid)}")


def _farm_study():
    return (Study("meshfarm").designs(preset_grid(array=[8, 16, 32]))
            .workloads({"wa": OPS, "wb": OPS[:1]}).fidelity("fast"))


def test_worker_mesh_mode_matches_plain(tmp_path):
    root = str(tmp_path / "farm")
    broker, client = Broker(root, max_shard_cells=8), FarmClient(root)
    local = _farm_study().run(device="cpu")
    sid = client.submit(_farm_study())
    meshed = Worker(root, "meshed", use_mesh=True, mesh_devices=CPU4)
    assert meshed.device == torch.device("cpu")
    _drive(broker, [meshed], client, sid)
    res = client.result(sid, timeout=5)
    assert res.equals(local)
    hb = json.load(open(broker.dirs.worker_path("meshed")))
    assert hb["mesh"] == [4, 1] and hb["device"] == "cpu"
    shard = json.load(open(broker.dirs.shard_result_path(sid, 0)))
    assert shard["mesh"] == [4, 1]


def test_worker_cli_takes_mesh(tmp_path, capsys):
    from repro_torch.farm.__main__ import _main
    assert _main(["worker", "--root", str(tmp_path / "f"), "--mesh",
                  "--device", "cpu", "--once"]) == 0
    out = capsys.readouterr().out
    assert "on a mesh [1, 1] of cpu" in out
    hb = json.load(open(tmp_path / "f" / "workers" / next(iter(
        p.name for p in (tmp_path / "f" / "workers").iterdir()))))
    assert hb["mesh"] == [1, 1]


# ---- the sharded weight draw ------------------------------------------------

class _Allocs(TorchDispatchMode):
    """Every op's output sizes (elements) and every normal draw's."""

    def __init__(self):
        super().__init__()
        self.outs, self.draws = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.outs.append(t.numel())
                if "randn" in str(func) or "normal" in str(func):
                    self.draws.append(t.numel())
        return out


def _layer_slice(defs) -> int:
    """The largest layer (one index of the stacked dims) of any leaf."""
    return max(int(np.prod(d.shape[d.stacked:])) for d in
               pm.tree_leaves(defs) if d.stacked)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-72b"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("serve", [False, True])
def test_rank_draws_its_blocks_of_the_one_device_draw(arch, shape, serve):
    bundle = ModelBundle(get_config(arch, smoke=True))
    whole = bundle.init(torch.Generator().manual_seed(7)).tree
    limit = _layer_slice(bundle.defs)
    for r in range(4):
        mesh = Mesh(shape, ("data", "model"), rank=r)
        ctx = make_mesh_ctx(mesh)
        specs = bundle.param_specs(ctx, serve=serve)
        with _Allocs() as seen:
            got = bundle.init(torch.Generator().manual_seed(7), ctx,
                              serve=serve)
        cut = pm.shard_tree(whole, specs, mesh)
        for n, (a, b) in enumerate(zip(pm.tree_leaves(got.tree),
                                       pm.tree_leaves(cut))):
            assert torch.equal(a, b), (arch, shape, r, n)
        blocks = {t.numel() for t in pm.tree_leaves(got.tree)}
        assert max(seen.draws) <= limit
        assert all(n <= limit or n in blocks for n in seen.outs)


def test_draw_units_cut_large_layers_in_row_blocks(monkeypatch):
    """With units smaller than a layer, a leaf is drawn in row blocks, and
    each rank's blocks still equal the one-device draw's."""
    monkeypatch.setattr(pm, "DRAW_ELEMS", 1000)
    bundle = ModelBundle(get_config("mixtral-8x7b", smoke=True))
    w_up = bundle.defs["blocks"]["w_up"]            # (2, 4, 64, 256)
    units = list(pm.draw_units(w_up))
    assert len(units) == 2 * 4 and units[0] == ((0,), (0, 1))
    whole = bundle.init(torch.Generator().manual_seed(1)).tree
    for r in range(4):
        mesh = Mesh((2, 2), ("data", "model"), rank=r)
        ctx = make_mesh_ctx(mesh)
        with _Allocs() as seen:
            got = bundle.init(torch.Generator().manual_seed(1), ctx)
        assert max(seen.draws) <= 64 * 256
        for a, b in zip(pm.tree_leaves(got.tree), pm.tree_leaves(
                pm.shard_tree(whole, bundle.param_specs(ctx), mesh))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_one_draw_cut_for_serving_and_training(shape):
    """`init(serve=(True, False))` draws each unit once and cuts it into
    the serving and the training blocks: each equals its own draw."""
    bundle = ModelBundle(get_config("mixtral-8x7b", smoke=True))
    for r in range(4):
        ctx = make_mesh_ctx(Mesh(shape, ("data", "model"), rank=r))
        with _Allocs() as pair_seen:
            both = bundle.init(torch.Generator().manual_seed(3), ctx,
                               serve=(True, False))
        with _Allocs() as serve_seen:
            serve = bundle.init(torch.Generator().manual_seed(3), ctx,
                                serve=True)
        train = bundle.init(torch.Generator().manual_seed(3), ctx)
        assert len(pair_seen.draws) == len(serve_seen.draws)
        for got, ref in zip(both, (serve, train)):
            assert got.specs == ref.specs
            for a, b in zip(pm.tree_leaves(got.tree),
                            pm.tree_leaves(ref.tree)):
                assert torch.equal(a, b), (shape, r)
