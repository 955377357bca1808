"""The plain reference against the program's CPU path, and the control
(the reference in bfloat16) against the reference."""
import pytest
import torch

from simbench.harness import cell as cm
from simbench.harness import check, designs as dz, registry
from simbench.reference import sim

from ._small import small_cell

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]
# The published networks' stall under the control is off by far more
# than its limit; a cell added later is held to the general checks.
PUBLISHED = ("vit_base.trace64k", "resnet18.trace64k")


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program_on_the_cpu(name):
    cell = small_cell(name, n_ops=200)
    cell.mix["trace_spec"]["cap"] = 1024
    res = cm.run(cell, seed=2**31 + 3, seconds=1e-3, trace=False,
                 device="cpu")
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == 6
    for name_, v in res["checks"].items():
        assert v["gap"] <= v["limit"], name_


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_is_not_correct(name):
    cell = small_cell(name, n_ops=200)
    mix = cell.mix
    designs = dz.grid(mix)
    kw = dict(spec=mix["trace_spec"], dram=mix["dram"], device="cpu")
    ref = sim.reference_frame(designs, cell.config["ops"], **kw)
    ctl = sim.reference_frame(designs, cell.config["ops"],
                              dtype=torch.bfloat16, **kw)
    frame = check.frame_of(ctl, designs)
    keys = {dz.label(d): sim.design_key(d) for d in designs}
    checks, failed, rows = check.compare([frame], keys, ref, mix["limits"])
    assert failed == rows == len(designs)
    # every column reads over its limit, the stall by a wide margin
    for c in sim.METRIC_COLUMNS:
        assert checks[c]["gap"] > checks[c]["limit"], c
    if name in PUBLISHED:
        assert checks["stall_cycles"]["gap"] > 0.1
