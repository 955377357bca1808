"""Cells, configurations, mixes and metrics are found by name from files,
and a file-only addition is found the same way and kept to the contract."""
import json
import shutil

import pytest

from simbench.harness import cell as cm
from simbench.harness import contract, registry

from ._small import small_cell

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]
# What the two published networks' cells report and read: the four
# end-to-end metrics, and the 8 readers' spans and counters.
PUBLISHED = {name: ({"designs_per_s", "frame_ms_p90", "device_peak_gib",
                     "setup_s"},
                    8, {"sweep", "stage_math", "streams", "replay"}, 2)
             for name in ("vit_base.trace64k", "resnet18.trace64k")}


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_loads_from_its_files(name):
    cell = registry.Cell(name)
    bench = registry.load_benchmark()
    assert cell.config["name"] == cell.entry["config"]
    assert cell.mix["name"] == cell.entry["traffic"]
    assert {m["name"] for m in cell.end_to_end} == {
        m["name"] for m in bench["end_to_end"]
        if name in m.get("workloads", CELLS)}
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert set(cell.readers) == {m["name"] for m in bench["per_layer"]
                                 if name in m["workloads"]}
    assert set(cell.spans()) == {s for mod in cell.readers.values()
                                 for s in getattr(mod, "SPANS", {})}
    files = {mod.__file__: mod for mod in cell.readers.values()}
    assert len(cell.counters()) == sum(
        len(getattr(mod, "COUNTERS", ())) for mod in files.values())
    if name in PUBLISHED:
        assert ({m["name"] for m in cell.end_to_end}, len(cell.readers),
                set(cell.spans()), len(cell.counters())) == PUBLISHED[name]


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
    assert contract.problems(registry.ROOT) == []
    assert set(PUBLISHED) <= set(CELLS)


def _copy(tmp_path):
    """The benchmark's files, copied to `tmp_path`; returns its
    BENCHMARK.json as a dict."""
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.BENCH_DIR, tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def _metric_file(tmp_path, name):
    (tmp_path / "simbench" / "metrics" / f"{name}.py").write_text(
        'LAYER = "study plan + frame"\nUNIT = "calls"\n'
        'MOVES = "designs_per_s"\nREADS = "the sweep span"\n'
        'SPANS = {"sweep": "repro_torch.api.study:_sweep_batched"}\n'
        "def read(trace):\n    return 3.0\n")
    return dict(name=name, unit="calls", better="lower",
                source="program_span", layer="study plan + frame",
                moves="designs_per_s")


def test_a_file_only_addition_is_found(tmp_path):
    b = _copy(tmp_path)
    mix = registry.load_mix("trace64k")
    mix = dict(mix, name="small", axes=dict(mix["axes"], array=[16, 32]))
    (tmp_path / "simbench" / "mixes" / "small.json").write_text(
        json.dumps(mix))
    b["workloads"].append(dict(name="resnet18.small", config="resnet18",
                               traffic="small", chips=1, why="a test"))
    b["per_layer"].append(dict(_metric_file(tmp_path, "sweep_calls"),
                               workloads=["resnet18.small"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    assert contract.problems(tmp_path) == []
    cell = registry.Cell("resnet18.small", tmp_path)
    assert cell.mix["axes"]["array"] == [16, 32]
    assert list(cell.readers) == ["sweep_calls"]
    assert cell.readers["sweep_calls"].read({}) == 3.0
    with pytest.raises(KeyError):
        registry.Cell("resnet18.nothing", tmp_path)


def _gemm(name, M, N, K):
    return dict(name=name, kind="gemm", M=M, N=N, K=K, count=64.0,
                vector_elems=0.0)


# The shapes a decode step brings: one token's GEMVs (N = 1), a routed
# expert's few tokens (N = 6), attention's reduction over a long cache
# (K = 16,384); 64 of each, as over a decode batch or an expert set.
DECODE_OPS = [_gemm("q_proj", 3072, 1, 2048),
              _gemm("expert_up", 1408, 6, 2048),
              _gemm("attn_score", 512, 1, 16384),
              dict(name="attn_softmax", kind="vector", M=0, N=0, K=0,
                   count=64.0, vector_elems=16.0 * 16384)]


LIKE = "resnet18.trace64k"


def _aliases(b, cell):
    """New entries `<metric>.<config>` that list only `cell`, one for each
    metric of `LIKE`: its readers, taken by `cell` with no entry edited."""
    return [dict(m, name=f"{m['name']}.{cell.split('.')[0]}",
                 workloads=[cell]) for m in b["per_layer"]
            if LIKE in m["workloads"]]


def _decode_addition(tmp_path):
    """A configuration, its cell, the existing readers under new entries
    and a metric that lists only that cell, added to a copy as files and
    entries; returns BENCHMARK.json as a dict, written back by the
    caller."""
    b = _copy(tmp_path)
    b["per_layer"] += _aliases(b, "decode_like.trace64k")
    (tmp_path / "simbench" / "configs" / "decode_like.json").write_text(
        json.dumps(dict(name="decode_like", source="decode-step shapes",
                        reduced=[], ops=DECODE_OPS)))
    b["configs"].append(dict(name="decode_like",
                             source="decode-step shapes",
                             file="simbench/configs/decode_like.json",
                             reduced=[], why="decode-step GEMM shapes"))
    b["workloads"].append(dict(name="decode_like.trace64k",
                               config="decode_like", traffic="trace64k",
                               chips=1, why="a test"))
    b["per_layer"].append(dict(_metric_file(tmp_path, "decode_calls"),
                               workloads=["decode_like.trace64k"]))
    return b


def _write(tmp_path, b):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))


def test_an_addition_of_files_and_entries_runs_correct(tmp_path):
    before = registry.load_benchmark()
    b = _decode_addition(tmp_path)
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        assert b[section][:len(before[section])] == before[section]
    _write(tmp_path, b)
    assert contract.problems(tmp_path) == []
    cell = small_cell("decode_like.trace64k", root=tmp_path)
    assert list(cell.readers) == [
        f"{name}.decode_like" for name in registry.Cell(LIKE).readers] + [
        "decode_calls"]
    assert set(cell.spans()) == {"sweep", "stage_math", "streams", "replay"}
    assert len(cell.counters()) == 2
    res = cm.run(cell, seed=2**31 + 11, seconds=1e-3, trace=False,
                 device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 6
    for name, v in res["checks"].items():
        assert v["gap"] <= v["limit"], name


def test_a_new_cell_reads_the_existing_readers_by_new_names(tmp_path):
    _write(tmp_path, _decode_addition(tmp_path))
    cell = small_cell("decode_like.trace64k", root=tmp_path)
    res = cm.run(cell, seed=2**31 + 12, seconds=1e-3, trace=True,
                 device="cpu")
    assert res["correct"]
    m = res["metrics"]
    assert {"streams_ms.decode_like", "replay_ms.decode_like",
            "stage_math_ms.decode_like", "decode_calls"} <= set(m)
    assert m["requests_per_pass.decode_like"]["value"] > 0
    assert 0 < m["replay_roofline.decode_like"]["value"] < 100


def test_a_reader_two_metrics_share_counts_once(tmp_path):
    b = _copy(tmp_path)
    b["per_layer"] += _aliases(b, LIKE)
    _write(tmp_path, b)
    assert contract.problems(tmp_path) == []
    like = registry.Cell(LIKE)
    cell = registry.Cell(LIKE, tmp_path)
    assert len(cell.readers) == 2 * len(like.readers)
    assert len(cell.counters()) == len(like.counters()) == 2


def _op_without_count(tmp_path, b):
    path = tmp_path / "simbench" / "configs" / "decode_like.json"
    cfg = json.loads(path.read_text())
    del cfg["ops"][0]["count"]
    path.write_text(json.dumps(cfg))


def _metric_lists_an_unknown_cell(tmp_path, b):
    b["per_layer"][-1]["workloads"] = ["decode_like.nothing"]


def _a_second_four_chip_cell(tmp_path, b):
    for w in b["workloads"][-2:]:
        w["chips"] = 4


def _config_file_missing(tmp_path, b):
    b["configs"][-1]["file"] = "simbench/configs/decode_missing.json"


def _an_alias_without_a_reader(tmp_path, b):
    b["per_layer"].append(dict(b["per_layer"][-1], name="nothing_ms.decode"))


BREAKS = [(_op_without_count, "count"),
          (_an_alias_without_a_reader, "nothing_ms"),
          (_metric_lists_an_unknown_cell, "decode_like.nothing"),
          (_a_second_four_chip_cell, "4 chips"),
          (_config_file_missing, "decode_missing.json")]


@pytest.mark.parametrize("fault,word", BREAKS,
                         ids=[f.__name__.strip("_") for f, _ in BREAKS])
def test_a_broken_addition_is_a_problem(tmp_path, fault, word):
    b = _decode_addition(tmp_path)
    fault(tmp_path, b)
    _write(tmp_path, b)
    found = contract.problems(tmp_path)
    assert any(word in p for p in found), found
