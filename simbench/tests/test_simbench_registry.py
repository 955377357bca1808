"""Cells, configurations, mixes and metrics are found by name from files,
and a file-only addition is found the same way."""
import json
import shutil

import pytest

from simbench.harness import registry

CELLS = ["vit_base.trace64k", "resnet18.trace64k"]
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_loads_from_its_files(name):
    cell = registry.Cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.mix["name"] == "trace64k"
    assert {m["name"] for m in cell.end_to_end} == {
        "designs_per_s", "frame_ms_p90", "device_peak_gib", "setup_s"}
    assert len(cell.readers) == 8
    assert set(cell.spans()) == {"sweep", "stage_math", "streams", "replay"}
    assert len(cell.counters()) == 2


def test_op_lists_are_the_published_networks():
    vit = registry.Cell("vit_base.trace64k").config["ops"]
    rn = registry.Cell("resnet18.trace64k").config["ops"]
    kinds = lambda ops, k: sum(o["kind"] == k for o in ops)  # noqa: E731
    assert (kinds(vit, "gemm"), kinds(vit, "vector")) == (74, 36)
    assert (kinds(rn, "gemm"), kinds(rn, "vector")) == (21, 0)
    qkv = next(o for o in vit if o["name"] == "vitb_0_qkv")
    assert (qkv["M"], qkv["N"], qkv["K"]) == (3 * 768, 197, 768)
    assert rn[0]["M"] * rn[0]["N"] * rn[0]["K"] == 64 * 112 * 112 * 147


def test_benchmark_json_keeps_to_its_contract():
    b = registry.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert [w["name"] for w in b["workloads"]] == CELLS
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert set(n) <= NAME_CHARS and len(n) <= 64
    for w in b["workloads"] + b["configs"]:
        assert 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_a_file_only_addition_is_found(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.BENCH_DIR, tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = registry.load_mix("trace64k")
    mix = dict(mix, name="small", axes=dict(mix["axes"], array=[16, 32]))
    (tmp_path / "simbench" / "mixes" / "small.json").write_text(
        json.dumps(mix))
    (tmp_path / "simbench" / "metrics" / "sweep_calls.py").write_text(
        'LAYER = "study plan + frame"\nUNIT = "calls"\n'
        'MOVES = "designs_per_s"\nREADS = "the sweep span"\n'
        'SPANS = {"sweep": "repro_torch.api.study:_sweep_batched"}\n'
        "def read(trace):\n    return 3.0\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(name="resnet18.small", config="resnet18",
                               traffic="small", chips=1, why="a test"))
    b["per_layer"].append(dict(name="sweep_calls", unit="calls",
                               better="lower", source="program_span",
                               layer="study plan + frame",
                               moves="designs_per_s",
                               workloads=["resnet18.small"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = registry.Cell("resnet18.small", tmp_path)
    assert cell.mix["axes"]["array"] == [16, 32]
    assert list(cell.readers) == ["sweep_calls"]
    assert cell.readers["sweep_calls"].read({}) == 3.0
    with pytest.raises(KeyError):
        registry.Cell("resnet18.nothing", tmp_path)
