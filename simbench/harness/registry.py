"""Find a cell's configuration, traffic mix and per-layer metrics by name.

Everything is data: `BENCHMARK.json` names the cells, configurations and
metrics; a configuration is the JSON file its entry names, a traffic mix
is `simbench/mixes/<traffic>.json`, and a per-layer metric is the reader
`simbench/metrics/<name>.py`. A metric named `<reader>.<suffix>` with no
file of its own is read by `simbench/metrics/<reader>.py`: a new cell
takes an existing reader through a new entry that lists it, and the
entries there stay as they are. Adding any of them is adding files and
entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# What a metric reader module declares besides `read(trace)`.
METRIC_FIELDS = ("LAYER", "UNIT", "MOVES", "READS")


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_mix(traffic: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    mix = load_json(bench_dir / "mixes" / f"{traffic}.json")
    if mix.get("name") != traffic:
        raise ValueError(f"mix file {traffic}.json names {mix.get('name')!r}")
    return mix


def metric_file(name: str, bench_dir: pathlib.Path = BENCH_DIR
                ) -> pathlib.Path:
    """`metrics/<name>.py`, or for `<reader>.<suffix>` with no file of its
    own, `metrics/<reader>.py`."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = bench_dir / "metrics" / f"{name.split('.', 1)[0]}.py"
    return path


def load_metric(name: str, bench_dir: pathlib.Path = BENCH_DIR
                ) -> ModuleType:
    """The reader module of one per-layer metric, loaded from its file."""
    path = metric_file(name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        f"simbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in METRIC_FIELDS + ("read",) if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"metric {name} lacks {missing}")
    return mod


def load_reader(entry: dict, bench_dir: pathlib.Path = BENCH_DIR
                ) -> ModuleType:
    """The reader of the per-layer metric `entry` (its `per_layer` entry),
    its `LAYER`, `UNIT` and `MOVES` held to the entry's."""
    mod = load_metric(entry["name"], bench_dir)
    for field, key in (("LAYER", "layer"), ("UNIT", "unit"),
                       ("MOVES", "moves")):
        if getattr(mod, field) != entry[key]:
            raise ValueError(f"metric {entry['name']}: its file's {field} "
                             f"{getattr(mod, field)!r} is not "
                             f"BENCHMARK.json's {entry[key]!r}")
    return mod


class Cell:
    """One entry of `workloads`, resolved: its configuration (with the op
    list), its mix, its end-to-end metrics and its per-layer readers."""

    def __init__(self, name: str, root: pathlib.Path = ROOT):
        bench = load_benchmark(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"unknown workload {name!r}; known: "
                           f"{sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.run_seconds = int(bench["run_seconds"])
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = cfgs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.mix = load_mix(self.entry["traffic"], root / "simbench")
        self.end_to_end = [m for m in bench["end_to_end"] if self._in(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._in(m)]
        self.readers: Dict[str, ModuleType] = {
            m["name"]: load_reader(m, root / "simbench")
            for m in self.per_layer}

    def _in(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def spans(self) -> Dict[str, str]:
        """{span name: "module:attribute"} that the cell's readers ask
        for (the union of their `SPANS`)."""
        out: Dict[str, str] = {}
        for name, mod in self.readers.items():
            for span, target in getattr(mod, "SPANS", {}).items():
                if out.get(span, target) != target:
                    raise ValueError(f"span {span!r} names two targets")
                out[span] = target
        return out

    def counters(self) -> List:
        """The counter hooks of the cell's readers: (span, fn) pairs;
        fn(args, kwargs, out) returns a dict of numbers to add up. A
        reader file that two of the cell's metrics share counts once."""
        files = {mod.__file__: mod for mod in self.readers.values()}
        return [hook for mod in files.values()
                for hook in getattr(mod, "COUNTERS", ())]
