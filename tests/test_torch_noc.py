"""The PyTorch port's routed NoC plane on the CPU against the JAX reference
(`repro.noc`), on the same numpy-seeded inputs: the routing tables equal;
the link loads and the contention closure within 1e-6 relative (float32),
with flit conservation; the numpy twins, the all-reduce and halo models
equal or within 1e-6; routed hops and the contention path's arrival skew
equal, and the contention path on a NoC pod; and `nop_bound(smoke=True)`
within 1e-3 with its six claims true on both. The batched sweep's NoC
pods: `test_torch_noc_sweep.py`."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.study as rstudy
import repro.noc.router as rrouter
import repro.noc.topology as rtopo
import repro.noc.traffic as rtraffic
from repro.core import multicore as rmc
from repro.core.accelerator import AcceleratorConfig as RConfig
from repro.noc.stage import noc_arrival_skew as r_skew
from repro.trace import TraceSpec as RTraceSpec
from repro.trace import contention as rcont
import repro_torch as rt
import repro_torch.api.study as tstudy
import repro_torch.noc.router as trouter
import repro_torch.noc.topology as ttopo
import repro_torch.noc.traffic as ttraffic
from repro_torch.api.presets import get_preset
from repro_torch.core import multicore as tmc
from repro_torch.noc.stage import noc_arrival_skew

TOPOS = ("mesh", "torus", "ring")
GRIDS = ((1, 1), (1, 5), (2, 2), (3, 5), (4, 4), (8, 8))
NOC_COLUMNS = ("noc_stall_cycles", "noc_link_util", "allreduce_cycles")
FRAME_COLUMNS = ("total_cycles", "compute_cycles", "stall_cycles",
                 "dram_bytes", "energy_pj", "utilization", "edp",
                 "energy_mac_pj", "energy_sram_pj", "energy_dram_pj",
                 "energy_static_pj") + NOC_COLUMNS


def _link_params(rng, shape):
    """Seeded link bandwidth, flit size, credit depth, hop cycles and
    window of `shape`, as float32 numpy arrays."""
    f32 = np.float32
    return (rng.choice([2.0, 4.0, 32.0, 256.0], shape).astype(f32),
            rng.choice([16.0, 32.0, 64.0], shape).astype(f32),
            rng.choice([4.0, 8.0, 64.0], shape).astype(f32),
            rng.choice([1.0, 2.0, 5.0], shape).astype(f32),
            rng.uniform(10.0, 5e4, shape).astype(f32))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def _assert_frames(port, ref, tol=1e-3):
    """Per column within `tol` relative; a NoC column is NaN on exactly
    the rows without the routed plane, in both frames."""
    assert list(port.column_names()) == list(ref.column_names())
    for a in ("design", "workload", "fidelity"):
        assert list(port[a]) == list(ref[a]), a
    for col in FRAME_COLUMNS:
        if col not in ref.column_names():
            continue
        a = np.asarray(port[col], float)
        b = np.asarray(ref[col], float)
        assert np.array_equal(np.isnan(a), np.isnan(b)), col
        m = ~np.isnan(b)
        rel = np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]), 1.0)
        assert rel.max(initial=0.0) <= tol, (col, float(rel.max()))


# --- topology: routing tables ------------------------------------------------

@pytest.mark.parametrize("topology", TOPOS)
@pytest.mark.parametrize("pr,pc", GRIDS)
def test_routing_tables_equal_the_reference(topology, pr, pc):
    for fn in ("parent_links", "routed_hop_counts", "subtree_sizes",
               "link_fanin"):
        np.testing.assert_array_equal(getattr(ttopo, fn)(topology, pr, pc),
                                      getattr(rtopo, fn)(topology, pr, pc))
    for a, b in zip(ttopo.route_pairs(topology, pr, pc),
                    rtopo.route_pairs(topology, pr, pc)):
        np.testing.assert_array_equal(a, b)


# --- router: loads and the contention closure -------------------------------

@pytest.mark.parametrize("topology", TOPOS)
@pytest.mark.parametrize("pr,pc", [(1, 5), (3, 5), (4, 4), (8, 8)])
def test_link_loads_and_delay_model_match_the_reference(topology, pr, pc):
    """A (designs, ops, cores) batch of seeded flits and per-(design, op)
    link parameters: loads and every output of the closure within 1e-6,
    loads conserving flits link by link."""
    n = pr * pc
    rng = np.random.default_rng(pr * 100 + pc + len(topology))
    flits = rng.uniform(0.0, 500.0, (3, 4, n)).astype(np.float32)
    flits[0, 0] = 0.0                              # an idle op
    bw, fb, buf, hop, win = _link_params(rng, (3, 4))
    win[1, 1] = 0.5                                # a window below 1
    load = trouter.link_loads(topology, pr, pc, torch.from_numpy(flits))
    _close(load, rrouter.link_loads(topology, pr, pc, jnp.asarray(flits)),
           1e-6)
    parent = ttopo.parent_links(topology, pr, pc)
    child = np.zeros((3, 4, n))
    np.add.at(child, (..., parent[1:]), load.numpy()[..., 1:])
    np.testing.assert_allclose(load.numpy()[..., 1:],
                               (flits + child)[..., 1:], rtol=1e-5)
    assert (load[..., 0] == 0).all()
    got = trouter.noc_delay_model(topology, pr, pc, torch.from_numpy(flits),
                                  *(torch.from_numpy(x) for x in
                                    (bw, fb, buf, hop, win)))
    want = rrouter.noc_delay_model(topology, pr, pc, jnp.asarray(flits),
                                   *(jnp.asarray(x) for x in
                                     (bw, fb, buf, hop, win)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        _close(got[k], want[k], 1e-6)
    # the float64 twin agrees with the float32 model
    eager = trouter.eager_noc_delay(topology, pr, pc, flits[1, 2], bw[1, 2],
                                    fb[1, 2], buf[1, 2], hop[1, 2],
                                    win[1, 2])
    _close(got["extra"][1, 2], eager["extra"], 1e-5)


@pytest.mark.parametrize("topology", TOPOS)
@pytest.mark.parametrize("pr,pc", [(1, 1), (2, 2), (3, 5), (4, 4)])
def test_numpy_twins_equal_the_reference(topology, pr, pc):
    n = pr * pc
    rng = np.random.default_rng(n + len(topology))
    flits = rng.uniform(0.0, 300.0, (2, n))
    flits[:, 0] = 0.0
    _close(trouter.link_loads(topology, pr, pc, flits, xp=np),
           rrouter.link_loads(topology, pr, pc, flits, xp=np), 0.0)
    for bw, buf, win in ((4.0, 8, [100.0, 5e3]), (1e9, 1 << 20, [1.0, 2.0])):
        got = trouter.eager_noc_delay(topology, pr, pc, flits, bw, 32, buf,
                                      2, np.asarray(win))
        want = rrouter.eager_noc_delay(topology, pr, pc, flits, bw, 32, buf,
                                       2, np.asarray(win))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    kw = dict(cap_per_window=3.0, buffer_flits=4, windows=60)
    got = trouter.windowed_link_sim(topology, pr, pc, flits[0], **kw)
    want = rrouter.windowed_link_sim(topology, pr, pc, flits[0], **kw)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("topology", TOPOS)
@pytest.mark.parametrize("pr,pc", [(1, 1), (1, 2), (1, 5), (2, 2), (3, 5),
                                   (4, 4), (8, 8)])
def test_traffic_models_match_the_reference(topology, pr, pc):
    rng = np.random.default_rng(3 * pr + pc)
    bw, fb, buf, hop, _ = _link_params(rng, (5,))
    payload = rng.uniform(1e3, 1e7, (5,)).astype(np.float32)
    for fn in ("allreduce_cycles", "halo_exchange_cycles"):
        got = getattr(ttraffic, fn)(topology, pr, pc,
                                    *(torch.from_numpy(x) for x in
                                      (payload, bw, fb, buf, hop)))
        want = getattr(rtraffic, fn)(topology, pr, pc,
                                     *(jnp.asarray(x) for x in
                                       (payload, bw, fb, buf, hop)))
        _close(got, want, 1e-6)
    # scalars in, as the per-op stage passes them
    _close(ttraffic.allreduce_cycles(topology, pr, pc, 4096.0, 8.0, 32, 8,
                                     2),
           rtraffic.allreduce_cycles(topology, pr, pc, 4096.0, 8.0, 32, 8,
                                     2), 1e-6)
    assert ttraffic._degree(topology, pr, pc) == \
        rtraffic._degree(topology, pr, pc)
    assert ttraffic._ring_embedding(topology, pr, pc) == \
        rtraffic._ring_embedding(topology, pr, pc)
    assert float(ttraffic.memory_flits(torch.tensor(6400.0), pr * pc, 32)) \
        == pytest.approx(float(rtraffic.memory_flits(6400.0, pr * pc, 32)))


# --- routed hops and the contention path's arrival skew ---------------------

@pytest.mark.parametrize("topology", TOPOS)
@pytest.mark.parametrize("cores", [1, 4, 16, 64])
def test_routed_hops_and_arrival_skew_equal_the_reference(topology, cores):
    cfg = get_preset("pod-mesh", cores=cores, topology=topology, link_bw=4.0)
    ref = RConfig.from_dict(cfg.to_dict())
    np.testing.assert_array_equal(tmc.effective_nop_hops(cfg),
                                  rmc.effective_nop_hops(ref))
    rng = np.random.default_rng(cores)
    per_core = rng.uniform(1e4, 1e6, cores)
    for window in (10.0, 1e4, 1e7):
        np.testing.assert_array_equal(
            noc_arrival_skew(cfg, per_core, window),
            r_skew(ref, per_core, window))
    off = cfg.with_(noc=dataclasses.replace(cfg.noc, enabled=False))
    np.testing.assert_array_equal(tmc.effective_nop_hops(off),
                                  [c.nop_hops for c in off.cores])


@pytest.mark.parametrize("topology", TOPOS)
def test_noc_kind_is_the_one_pod_rule(topology):
    """`noc_kind` names the topology of a NoC pod only (the NoC on and more
    than one core); the plan groups designs by it and each group's sweep
    flavor carries the same kind, as the reference's plan key does."""
    from repro_torch.api.simulator import _flavor, as_workload
    pod = get_preset("pod-mesh", cores=4, topology=topology)
    one = get_preset("pod-mesh", cores=1, topology=topology)
    off = pod.with_(noc=dataclasses.replace(pod.noc, enabled=False))
    assert [ttopo.noc_kind(c) for c in (pod, one, off)] == [topology, None,
                                                             None]
    ops = as_workload("resnet18")
    plan = rt.Study().designs({"pod": pod, "off": off, "pod2": pod.with_(
        noc=dataclasses.replace(pod.noc, buffer_flits=4))}) \
        .workloads("resnet18").plan()
    ref_plan = rstudy.Study().designs({"pod": RConfig.from_dict(
        pod.to_dict()), "off": RConfig.from_dict(off.to_dict()),
        "pod2": RConfig.from_dict(pod.with_(noc=dataclasses.replace(
            pod.noc, buffer_flits=4)).to_dict())}).workloads(
        "resnet18").plan()
    assert len(plan.groups) == 2
    assert [g.cells for g in plan.groups] == [g.cells for g in
                                              ref_plan.groups]
    for g in plan.groups:
        cfgs = [plan.cells[i].config for i in g.cells]
        kinds = {ttopo.noc_kind(c) for c in cfgs}
        assert len(kinds) == 1
        assert _flavor(cfgs, ops).noc == kinds.pop()


def test_contention_on_a_noc_pod_matches_the_reference():
    """The routed skew (hops plus router queueing) feeds the shared-DRAM
    replay of a 4-core NoC mesh with slow links."""
    cfg = get_preset("pod-mesh", cores=4, link_bw=2.0, channels=2)
    ref = RConfig.from_dict(cfg.to_dict())
    got = tmc.simulate_multicore_contention(
        cfg, 256, 1024, 512, spec=rt.TraceSpec(cap=512), device="cpu")
    want = rcont.multicore_contention(ref, 256, 1024, 512,
                                      spec=RTraceSpec(cap=512))
    for k in ("row_hits", "row_misses", "row_conflicts", "per_core_compute",
              "scaled_by"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("per_core_stall_isolated", "per_core_stall_shared"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-3, err_msg=k)
    assert got.makespan_shared == pytest.approx(want.makespan_shared,
                                                rel=1e-3)


def test_nop_bound_smoke_matches_the_reference():
    port = tstudy.studies.nop_bound(smoke=True).run(device="cpu")
    ref = rstudy.studies.nop_bound(smoke=True).run()
    for r in (port, ref):
        claims = r.check_claims()
        assert len(claims) == 6 and all(claims.values()), claims
    _assert_frames(port, ref)
    tot = dict(zip(port["design"], port["total_cycles"]))
    assert tot["noc-zero-load"] == tot["legacy-hops"]
