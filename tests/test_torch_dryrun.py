"""The port's dry run (`repro_torch.launch.dryrun`) against the
reference's (`repro.launch.dryrun`, `repro.configs.shapes`): the cells,
the model FLOPs, the skip policy, bounded caches, production cells on
meta tensors under the reference's artifact checks, and parity with the
reference's compiled small cells (`tests/jax_dryrun_ref.py`)."""
import json
import math
import os
import subprocess
import sys

import pytest

from repro.configs import get_config as rget
from repro.configs.shapes import SHAPES as RSHAPES
from repro.configs.shapes import skip_reason as rskip

# importing the reference's dry run sets XLA_FLAGS to 512 host devices
# (for its own runs); scrub it so that other tests' subprocesses do not
# inherit it (as tests/test_dryrun_meta.py does)
_prev = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as rdry  # noqa: E402
if _prev is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _prev

import repro.api as rapi  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, skip_reason  # noqa: E402
from repro_torch.dist.sharding import Mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import params as pm  # noqa: E402
from repro_torch.models.zoo import ModelBundle  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")
TERMS = ("compute_s", "memory_s", "collective_s")


def check_artifact(c):
    """tests/test_dryrun_meta.py's checks on one cell."""
    assert c["ok"]
    assert all(v >= 0 for v in c["terms"].values())
    assert c["op_flops_per_device"] > 0
    assert c["dominant"] in TERMS
    assert 0 < c["useful_flops_ratio"] < 5


# ---- cells, model FLOPs, skips ---------------------------------------------------

def test_cell_list_is_the_reference_s():
    cells = dryrun.cell_list()
    assert cells == rdry.cell_list()
    assert len(cells) == 66 and len({c[0] for c in cells}) == 10


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_and_skips_equal_the_reference_s(arch):
    assert list(SHAPES) == list(RSHAPES)
    for shape, spec in SHAPES.items():
        assert skip_reason(get_config(arch), shape) == \
            rskip(rget(arch), shape)
        kw = dict(seq=spec["seq"], batch=spec["batch"], mode=spec["mode"])
        assert dryrun.model_flops(get_config(arch), **kw) == \
            rdry.model_flops(rget(arch), **kw)


def test_skipped_cell_reports_the_reason():
    r = dryrun.run_cell("qwen2-72b", "long_500k", "pod")
    assert r == dict(arch="qwen2-72b", shape="long_500k", mesh="pod",
                     skipped=rskip(rget("qwen2-72b"), "long_500k"))


def test_windowed_cache_is_bounded():
    defs = ModelBundle(get_config("mixtral-8x7b")).cache_defs(
        batch=1, cache_len=524288)
    assert defs["k"].shape[2] == 4096             # the window, not 524,288
    # ssm archs carry O(1) state
    defs = ModelBundle(get_config("xlstm-1.3b")).cache_defs(
        batch=1, cache_len=524288)
    total = sum(math.prod(d.shape) * pm.torch_dtype(d.dtype).itemsize
                for d in pm.tree_leaves(defs))
    assert total < 2 * 2 ** 30


# ---- production cells on meta ------------------------------------------------------

@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_production_decode_cell_meets_the_artifact_checks(mesh):
    c = dryrun.run_cell("qwen2-1.5b", "decode_32k", mesh)
    check_artifact(c)
    assert c["chips"] == (256 if mesh == "pod" else 512)
    assert c["collective_bytes_per_chip"] > 0 and c["collectives"]
    assert c["fits_hbm"] and c["peak_bytes_per_device"] >= \
        c["arg_bytes_per_device"] > 0
    assert c["temp_bytes_per_device"] == \
        c["peak_bytes_per_device"] - c["arg_bytes_per_device"]
    assert c["out_bytes_per_device"] > 0          # the logits; the cache
    #                                               is written in place
    for k in ("hlo_flops_per_device", "hlo_bytes_per_device",
              "xla_flops_once", "xla_bytes_once"):
        assert k not in c


def test_train_weak_scaling_from_pod_to_multipod():
    pod = dryrun.run_cell("whisper-base", "train_4k", "pod")
    multi = dryrun.run_cell("whisper-base", "train_4k", "multipod")
    check_artifact(pod)
    check_artifact(multi)
    ratio = pod["terms"]["compute_s"] / multi["terms"]["compute_s"]
    assert 1.2 < ratio < 3.5


def test_dry_run_takes_a_dry_mesh_and_meta_inputs():
    cfg = get_config("qwen2-1.5b", smoke=True)
    with pytest.raises(ValueError, match="dry mesh"):
        dryrun.count_cell(cfg, Mesh((1, 1), ("data", "model")), seq=8,
                          batch=2, mode="train")


def test_sim_accel_attaches_the_reference_s_cost_model():
    c = dryrun.run_cell("qwen2-1.5b", "decode_32k", "pod",
                        sim_accel="paper-32", device="cpu")
    ref = rapi.Simulator("paper-32").run_lm(rget("qwen2-1.5b"), seq=32768,
                                            batch=128, mode="decode")
    s = c["sim_accel"]
    assert s["device"] == "cpu" and s["preset"] == "paper-32"
    assert s["total_cycles"] == pytest.approx(ref.total_cycles, rel=1e-3)
    assert s["energy_pj"] == pytest.approx(ref.energy_pj, rel=1e-3)


def test_all_enumerates_the_reference_s_cells(tmp_path, monkeypatch):
    launched = []

    class Done:
        def __init__(self, cmd):
            launched.append(cmd)

        def poll(self):
            return 0

        def wait(self):
            return 0

    monkeypatch.setattr(dryrun.subprocess, "Popen", Done)
    dryrun.main(["--all", "--jobs", "8", "--out", str(tmp_path)])
    cells = [(c[c.index("--arch") + 1], c[c.index("--shape") + 1],
              c[c.index("--mesh") + 1]) for c in launched]
    assert cells == rdry.cell_list()
    assert all(c[1:3] == ["-m", "repro_torch.launch.dryrun"]
               for c in launched)
    # --missing-only launches none of the cells already written
    for a, s, m in cells[:60]:
        (tmp_path / f"{a}__{s}__{m}.json").write_text("{}")
    launched.clear()
    dryrun.main(["--all", "--missing-only", "--out", str(tmp_path)])
    assert len(launched) == 6


def test_cli_writes_the_cell_without_jax(tmp_path):
    """The acceptance command, in a fresh interpreter: the JSON written,
    nothing allocated (no CUDA), neither jax nor the reference loaded."""
    code = (
        "import sys\n"
        "from repro_torch.launch import dryrun, opcost\n"
        "dryrun.main(['--arch', 'qwen2-1.5b', '--shape', 'decode_32k',"
        f" '--mesh', 'pod', '--out', {str(tmp_path)!r}])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' or"
        " m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(tmp_path / "qwen2-1.5b__decode_32k__pod.json") as f:
        check_artifact(json.load(f))


# ---- parity with the reference's compiled cells ------------------------------------

PARITY = [
    dict(name="qwen2_train", arch="qwen2-1.5b", mode="train", seq=64,
         batch=4),
    dict(name="mixtral_train", arch="mixtral-8x7b", mode="train", seq=64,
         batch=4),
    dict(name="zamba2_decode", arch="zamba2-7b", mode="decode", seq=64,
         batch=4),
    dict(name="granite_train", arch="granite-moe-3b-a800m", mode="train",
         seq=64, batch=4),
    dict(name="xlstm_train", arch="xlstm-1.3b", mode="train", seq=64,
         batch=4),
    dict(name="xlstm_decode", arch="xlstm-1.3b", mode="decode", seq=64,
         batch=4),
    dict(name="zamba2_train", arch="zamba2-7b", mode="train", seq=64,
         batch=4),
    # 2 x 1: the data axis alone, which tells the split over `data` from
    # the split over `model`
    dict(name="granite_train_2x1", arch="granite-moe-3b-a800m",
         mode="train", seq=64, batch=4, mesh=[2, 1]),
    dict(name="xlstm_train_2x1", arch="xlstm-1.3b", mode="train", seq=64,
         batch=4, mesh=[2, 1]),
    dict(name="xlstm_decode_2x1", arch="xlstm-1.3b", mode="decode", seq=64,
         batch=4, mesh=[2, 1]),
    dict(name="zamba2_train_2x1", arch="zamba2-7b", mode="train", seq=64,
         batch=4, mesh=[2, 1]),
]


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ref")
    cells = d / "cells.json"
    cells.write_text(json.dumps(PARITY))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "jax_dryrun_ref.py"),
         str(cells), str(d / "ref.json")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(d / "ref.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", PARITY, ids=[c["name"] for c in PARITY])
def test_small_cells_match_the_compiled_reference(compiled, cell):
    ref = compiled[cell["name"]]
    got = dryrun.count_cell(get_config(cell["arch"], smoke=True),
                            dryrun.dry_mesh(tuple(cell.get("mesh", (2, 2))),
                                            ("data", "model")),
                            seq=cell["seq"], batch=cell["batch"],
                            mode=cell["mode"])
    assert got["arg_bytes"] == ref["arg_bytes"]
    # the port partitions the MoE's short-batch path and the recurrent
    # blocks as XLA partitions the reference
    assert abs(got["flops"] / ref["flops"] - 1) <= 0.02
