"""What `BENCHMARK.json` and the files it names must keep to, read from the
file itself: a cell, a configuration, a mix or a metric added as files
and entries is held to the same rules as those there already.

    from simbench.harness import contract
    assert contract.problems(ROOT) == []

`problems(root)` returns one line for each rule broken, and an empty list
when there is none. It checks the benchmark's own contract (its keys, its
names, `why`s, bounds, sources, `run_seconds`, the file's size) and what
a cell needs to run: its configuration's file and op list, its mix file,
and the per-layer metrics that list it, each reader loaded from its file
(`registry.metric_file`: a `<reader>.<suffix>` with no file of its own is
read by `<reader>`'s).
"""
from __future__ import annotations

import json
import math
import pathlib
import re
from typing import List

from . import registry
from .cell import validate_mix

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
OP_KEYS = {"name", "kind", "M", "N", "K", "count", "vector_elems"}
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
END_TO_END_SOURCES = {"host_clock", "device_trace"}
SOURCES = END_TO_END_SOURCES | {"program_span", "program_counter"}
MAX_CELLS = 24
MAX_BYTES = 64 * 1024


def _line(text, what: str, out: List[str]) -> None:
    if not (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text):
        out.append(f"{what}: not one line of 1-200 characters")


def _number(v) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v))


def _whole(v) -> bool:
    return _number(v) and float(v) == int(v)


def op_problems(op: dict, where: str) -> List[str]:
    """An op of a configuration's list: exactly `OP_KEYS`; a gemm with
    whole M, N, K of at least 1, a vector op with elements; a count."""
    if not isinstance(op, dict) or set(op) != OP_KEYS:
        got = sorted(op) if isinstance(op, dict) else type(op).__name__
        return [f"{where}: keys {got}, not {sorted(OP_KEYS)}"]
    out = []
    if not (_number(op["count"]) and op["count"] > 0):
        out.append(f"{where}: count {op['count']!r} is not above 0")
    if op["kind"] == "gemm":
        for k in ("M", "N", "K"):
            if not (_whole(op[k]) and op[k] >= 1):
                out.append(f"{where}: {k} {op[k]!r} is not a whole "
                           "number of at least 1")
    elif op["kind"] == "vector":
        if not (_number(op["vector_elems"]) and op["vector_elems"] > 0):
            out.append(f"{where}: vector_elems {op['vector_elems']!r} is "
                       "not above 0")
    else:
        out.append(f"{where}: kind {op['kind']!r} is neither gemm nor "
                   "vector")
    return out


def config_problems(entry: dict, root: pathlib.Path, paths: List[str]
                    ) -> List[str]:
    """A configuration's file: under `paths`, named as its entry, with a
    source, a `reduced` list and a sound op list."""
    where = f"config {entry.get('name')!r}"
    rel = entry.get("file")
    if not isinstance(rel, str) or not any(
            rel.startswith(p.rstrip("/") + "/") for p in paths):
        return [f"{where}: file {rel!r} is not under {paths}"]
    try:
        cfg = registry.load_json(root / rel)
    except (OSError, ValueError) as e:
        return [f"{where}: file {rel} does not load: {e}"]
    out = []
    if cfg.get("name") != entry.get("name"):
        out.append(f"{where}: its file names {cfg.get('name')!r}")
    if not cfg.get("source"):
        out.append(f"{where}: its file has no source")
    if not isinstance(cfg.get("reduced"), list):
        out.append(f"{where}: its file has no reduced list")
    ops = cfg.get("ops")
    if not (isinstance(ops, list) and ops):
        return out + [f"{where}: its file has no ops"]
    for i, op in enumerate(ops):
        out += op_problems(op, f"{where} op {i}")
    names = [op.get("name") for op in ops if isinstance(op, dict)]
    if len(names) != len(set(names)):
        out.append(f"{where}: op names repeat")
    return out


def problems(root: pathlib.Path = registry.ROOT) -> List[str]:
    """Every rule that `root`'s BENCHMARK.json, or a file it names,
    breaks; empty when there is none."""
    root = pathlib.Path(root)
    try:
        raw = (root / "BENCHMARK.json").read_bytes()
        b = json.loads(raw)
    except (OSError, ValueError) as e:
        return [f"BENCHMARK.json does not load: {e}"]
    if not isinstance(b, dict) or set(b) != TOP_KEYS:
        got = sorted(b) if isinstance(b, dict) else type(b).__name__
        return [f"BENCHMARK.json: keys {got}, not {sorted(TOP_KEYS)}"]
    out: List[str] = []
    if len(raw) >= MAX_BYTES:
        out.append(f"BENCHMARK.json: {len(raw)} bytes, not under 64 KiB")
    if not (isinstance(b["run_seconds"], int)
            and 1 <= b["run_seconds"] <= 51):
        out.append(f"run_seconds {b['run_seconds']!r} is not a whole "
                   "number in 1-51")
    _entries(b, out)
    _configs(b, root, out)
    _cells(b, root, out)
    _metrics(b, root, out)
    return out


def _entries(b: dict, out: List[str]) -> None:
    """Each entry's keys; names unique and well formed."""
    for section, keys in ENTRY_KEYS.items():
        for e in b[section]:
            extra = set(e) - keys - ({"workloads"} if section in (
                "end_to_end", "per_layer") else set())
            if keys - set(e) or extra:
                out.append(f"{section} entry {e.get('name')!r}: keys "
                           f"{sorted(e)}, not {sorted(keys)}")
    seen = set()
    for n in (e.get("name") for s in ENTRY_KEYS for e in b[s]):
        if not (isinstance(n, str) and NAME.fullmatch(n)):
            out.append(f"name {n!r}: not 1-64 of [A-Za-z0-9_.-] from "
                       "[A-Za-z0-9_]")
        if n in seen:
            out.append(f"name {n!r} is given twice")
        seen.add(n)


def _configs(b: dict, root: pathlib.Path, out: List[str]) -> None:
    used = {w.get("config") for w in b["workloads"]}
    paths = [p for p in b["paths"] if isinstance(p, str)]
    for c in b["configs"]:
        where = f"config {c.get('name')!r}"
        _line(c.get("why"), f"{where} why", out)
        _line(c.get("source"), f"{where} source", out)
        for k in c.get("reduced", []):
            if not (isinstance(k, str) and NAME.fullmatch(k)):
                out.append(f"{where}: reduced key {k!r}")
        if c.get("name") not in used:
            out.append(f"{where}: no cell uses it")
        out += config_problems(c, root, paths)


def _cells(b: dict, root: pathlib.Path, out: List[str]) -> None:
    """Count and chips; each cell's configuration, mix and metrics."""
    cells = [w.get("name") for w in b["workloads"]]
    if not 1 <= len(cells) <= MAX_CELLS:
        out.append(f"{len(cells)} cells, not 1-{MAX_CELLS}")
    four = [w.get("name") for w in b["workloads"] if w.get("chips") == 4]
    if len(four) > max(1, len(cells) // 4):
        out.append(f"{len(four)} cells on 4 chips {four}: at most "
                   f"{max(1, len(cells) // 4)} of {len(cells)}")
    pairs = [(w.get("config"), w.get("traffic")) for w in b["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a pair of config and traffic is given twice")
    configs = {c.get("name") for c in b["configs"]}
    mixes = set()
    for w in b["workloads"]:
        where = f"cell {w.get('name')!r}"
        _line(w.get("why"), f"{where} why", out)
        if w.get("chips") not in (1, 4):
            out.append(f"{where}: chips {w.get('chips')!r}, not 1 or 4")
        if w.get("config") not in configs:
            out.append(f"{where}: config {w.get('config')!r} is no entry "
                       "of configs")
        t = w.get("traffic")
        if not (isinstance(t, str) and NAME.fullmatch(t)):
            out.append(f"{where}: traffic {t!r} is no name")
        elif t not in mixes:
            mixes.add(t)
            try:
                validate_mix(registry.load_mix(t, root / "simbench"))
            except (OSError, ValueError, KeyError) as e:
                out.append(f"{where}: mix simbench/mixes/{t}.json: {e!r}")
        name = w.get("name")
        e2e = {m.get("name") for m in b["end_to_end"]
               if name in m.get("workloads", cells)}
        if "setup_s" not in e2e or len(e2e) < 2:
            out.append(f"{where}: end-to-end metrics {sorted(e2e)}, not "
                       "setup_s and one more")
        if not any(name in m.get("workloads", ()) for m in b["per_layer"]):
            out.append(f"{where}: no per-layer metric lists it")


def _metrics(b: dict, root: pathlib.Path, out: List[str]) -> None:
    cells = [w.get("name") for w in b["workloads"]]
    end_to_end = {m.get("name") for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        where = f"end_to_end {m.get('name')!r}"
        if not (_number(m.get("bound")) and 0.01 <= m["bound"] <= 0.25):
            out.append(f"{where}: bound {m.get('bound')!r} not in "
                       "0.01-0.25")
        if m.get("source") not in END_TO_END_SOURCES:
            out.append(f"{where}: source {m.get('source')!r}")
    for m in b["per_layer"]:
        where = f"per_layer {m.get('name')!r}"
        if m.get("source") not in SOURCES:
            out.append(f"{where}: source {m.get('source')!r}")
        if m.get("moves") not in end_to_end:
            out.append(f"{where}: moves {m.get('moves')!r}, no "
                       "end-to-end metric")
        if "workloads" not in m:
            out.append(f"{where}: no workloads list, so a cell added "
                       "later would have to report it")
        _line(m.get("layer"), f"{where} layer", out)
        try:
            registry.load_reader(m, root / "simbench")
        except Exception as e:  # noqa: BLE001 -- a reader's fault is reported
            out.append(f"{where}: its reader does not load: {e!r}")
    for m in b["end_to_end"] + b["per_layer"]:
        where = f"metric {m.get('name')!r}"
        if not (isinstance(m.get("unit"), str) and UNIT.fullmatch(m["unit"])):
            out.append(f"{where}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"{where}: better {m.get('better')!r}")
        listed = m.get("workloads", cells)
        if not (isinstance(listed, list) and listed
                and set(listed) <= set(cells)):
            out.append(f"{where}: workloads {listed!r} is not a list of "
                       "cells")
