"""The PyTorch port's batched sweep on NoC pods on the CPU against the JAX
reference: Study frames of mesh, torus and ring pods (some sparse, some
with the layout stage on) at `fast` and `trace` fidelity within 1e-3 per
column, the zero-load pair bit for bit, and `preset_grid(pods=)` grids
grouped by topology and run batched. (Kept apart from
`test_torch_noc.py` so the two files run on separate test workers.)"""
import dataclasses

import numpy as np
import pytest

from repro.core.accelerator import AcceleratorConfig as RConfig
from repro.core.accelerator import LayoutConfig as RLayoutConfig
from repro.trace import TraceSpec as RTraceSpec
import repro_torch as rt
from repro_torch.api.presets import get_preset
from repro_torch.core.accelerator import LayoutConfig
from repro_torch.noc import topology as ttopo
from test_torch_feature_sweep import OPS, _studies
from test_torch_noc import TOPOS, _assert_frames


def _pods(cores, seed, layout=True):
    """Mesh, torus and ring pods of `cores` cores with seeded link
    parameters, a torus with the layout stage on (`layout`): {label:
    (port config, reference config)}."""
    rng = np.random.default_rng(seed)
    out = {}
    for topo in TOPOS:
        for i in range(2):
            cfg = get_preset("pod-mesh", cores=cores, topology=topo,
                             array=int(rng.choice([16, 32])),
                             link_bw=float(rng.choice([1.0, 8.0, 128.0])),
                             buffer_flits=int(rng.choice([4, 16])),
                             channels=int(rng.choice([1, 4])))
            ref = RConfig.from_dict(cfg.to_dict())
            if layout and i == 1 and topo == "torus":
                cfg = cfg.with_(layout=LayoutConfig(enabled=True))
                ref = ref.with_(layout=RLayoutConfig(enabled=True))
            out[f"{topo}-{cores}c-{i}"] = (cfg, ref)
    return out


@pytest.mark.parametrize("fidelity", ["fast", "trace"])
def test_noc_pod_frames_match_the_reference(fidelity):
    """Mesh, torus and ring pods, every cell batched: at `fast` 4 and 16
    cores beside a NoC-free design, with the per-op N:M override and the
    vector op; at `trace` (where each group compiles a reference replay)
    4 cores without the layout stage."""
    fast = fidelity == "fast"
    designs = _pods(4, 1, layout=fast)
    if fast:
        designs.update(_pods(16, 2))
        plain = get_preset("multicore-16x32")
        designs["no-noc"] = (plain, RConfig.from_dict(plain.to_dict()))
    port, ref = _studies(designs, {"w": OPS if fast else OPS[:2]}, fidelity,
                         spec=None if fast else RTraceSpec(cap=512))
    res = port.run(device="cpu")
    assert res.fraction_batched == 1.0 and not res.failed_cells
    assert len(port.plan().groups) == len(ref.plan().groups)
    _assert_frames(res, ref.run())
    noc = np.asarray(res["noc_stall_cycles"], float)
    assert np.isnan(noc).tolist() == [d == "no-noc" for d in res["design"]]
    assert (noc > 0).any()


def test_zero_load_pair_is_bit_for_bit():
    """The legacy hop offsets set to the routed mesh hops against the NoC
    plane with effectively infinite links: equal total cycles in the port
    at both fidelities, and the frame the reference's at `fast`."""
    legacy = get_preset("pod-mesh", cores=16)
    legacy = legacy.with_(
        cores=tuple(dataclasses.replace(c, nop_hops=int(h))
                    for c, h in zip(legacy.cores,
                                    ttopo.routed_hop_counts("mesh", 4, 4))),
        noc=dataclasses.replace(legacy.noc, enabled=False))
    zero = get_preset("pod-mesh", cores=16, link_bw=1e9,
                      buffer_flits=1 << 20)
    designs = {k: (c, RConfig.from_dict(c.to_dict()))
               for k, c in (("legacy", legacy), ("zero", zero))}
    for fid in ("fast", "trace"):
        port, ref = _studies(designs, {"w": OPS[:2]}, fid,
                             spec=RTraceSpec(cap=512) if fid == "trace"
                             else None)
        res = port.run(device="cpu")
        tot = dict(zip(res["design"], res["total_cycles"]))
        assert tot["zero"] == tot["legacy"]
        assert res.filter(design="zero")["noc_stall_cycles"][0] == 0.0
        if fid == "fast":
            _assert_frames(res, ref.run())


def test_pod_grid_runs_batched_in_one_group_per_topology():
    """`preset_grid(pods=)` remeshes onto the default mesh, as the
    reference does; its designs and a torus pod form one group per
    (pod, topology) and all run batched. A NoC design and a NoC-free one
    with the same configured hops never share a stream."""
    grid = rt.preset_grid("pod-mesh", pods=[16, 64], link_bw=[4.0, 64.0])
    assert all(c.noc.enabled and c.noc.topology == "mesh" for c in grid)
    torus = get_preset("pod-mesh", cores=16, topology="torus")
    s = rt.Study().designs(grid + [torus]).workloads({"w": OPS[:2]}) \
        .fidelity("fast")
    assert len(s.plan().groups) == 3
    assert s.run(device="cpu").fraction_batched == 1.0
    from repro_torch.api.simulator import _flavor, _stream_dedup
    off = grid[0].with_(noc=dataclasses.replace(grid[0].noc, enabled=False))
    assert _stream_dedup([grid[0], grid[2], off])[1] == [0, 0, 1]
    with pytest.raises(ValueError, match="NoC"):
        _flavor([grid[0], off], OPS[:2])
