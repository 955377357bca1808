"""Declarative Study API (PyTorch port of `repro.api.study`):
cross-product experiment plans over designs x workloads x fidelities,
reduced to a columnar result frame.

    res = (Study()
           .designs({"32": "paper-32", "64": "paper-64"})
           .workloads({"vit-base": vit_base_linear()})
           .fidelity("fast", "trace")
           .run())                      # on the CUDA device by default
    res.best("edp")                      # winning row (dict)
    res.filter(fidelity="trace").compare("total_cycles",
                                         axis="design", baseline="32")

`Study.run` groups the `fast` and `trace` cells by the static sweep
flavor (workload, fidelity, dataflow, word size, the DramConfig at trace
fidelity, the core grid, the layout config when the layout stage is on,
the sparse representation and the NoC topology of a NoC pod) and runs
each group as one batched `_sweep_batched` call; at trace fidelity that
is one replay-kernel launch per group, and with the layout stage on one
bank-conflict-kernel launch per group (`run(mesh=)`: per group and
device of a device mesh, each device running its block of the group's
designs). Every `cycle` cell, every cell of
a `force_fallback` study (the per-op oracle the parity tests hold the
batched sweep against) and every cell of a custom evaluator runs on its
own through the per-op engine (`core.engine.simulate_network`: one
replay launch per gemm op at `cycle`/`trace`, one conflict launch per
gemm op with layout on). A cell whose evaluation raises anything but
`ValueError` becomes a failed cell (`cell_status = 1.0`, NaN metrics);
a `ValueError` (an invalid configuration) propagates. Nothing reruns
elsewhere.

A content-hash keyed on-disk cache (`Study.cache`) makes a rerun execute
only changed cells; `to_spec`/`from_spec` are the wire format and
`_execute_cells` + `assemble_frame` the unit of work of a farm. The
paper's analyses ship as named studies with machine-checkable claims
(`studies.edp_array_size`, `studies.dataflow_dram_flip`,
`studies.sparse_speedup`, `studies.multicore_contention`,
`studies.nop_bound`, and the search layer's `studies.search_edp`). CLI:

    PYTHONPATH=src python -m repro_torch.api --study edp_array_size \
        --smoke --device cpu --csv STUDY_edp_array_size.csv
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import stages as st
from ..core.accelerator import AcceleratorConfig, DramConfig
from ..core.energy import DEFAULT_ERT, ERT, edp as _edp
from ..core.engine import (ENERGY_GROUP_COLUMNS, RESULT_SCHEMA_VERSION,
                           energy_group_totals, simulate_network,
                           write_csv_table)
from ..core.replay import resolve_device
from ..core.workloads import Op
from ..faults import fs as _fs
from ..noc.topology import noc_kind
from .simulator import _sweep_batched, as_config, as_workload

AXIS_COLUMNS = ("design", "workload", "fidelity")

# Canonical metric columns, grouped-energy columns included.
METRIC_COLUMNS = ("total_cycles", "compute_cycles", "stall_cycles",
                  "dram_bytes", "energy_pj", "utilization",
                  "edp") + ENERGY_GROUP_COLUMNS

_METRIC_ALIASES = {"latency": "total_cycles", "cycles": "total_cycles",
                   "energy": "energy_pj"}


def _mesh_device(mesh, device) -> torch.device:
    """The device a run's per-op cells and labels take: `device` resolved
    (CUDA by default), or with a device mesh its first device, and a
    named device must then be one of the mesh's (a bare "cuda" is the
    current card)."""
    if mesh is None:
        return resolve_device(device)
    if mesh.devices is None:
        raise ValueError("a study shards over a mesh of devices "
                         "(launch/mesh.py::make_device_mesh), not a process "
                         "world")
    if device is None:
        return mesh.devices[0]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in mesh.devices:
        raise ValueError(f"device {dev} is not one of the mesh's "
                         f"{[str(d) for d in mesh.devices]}")
    return dev


def _flag_non_finite(metrics: Dict[str, float]) -> None:
    """NaN anywhere, or +-Inf on a canonical metric column, marks the cell
    failed (`cell_status = 1.0`)."""
    for k, v in metrics.items():
        if k in ("batched", "cell_status"):
            continue
        if v != v or (k in METRIC_COLUMNS
                      and v in (float("inf"), float("-inf"))):
            metrics["cell_status"] = 1.0
            return


def _code_digest(code) -> str:
    """Process-stable digest of a code object: bytecode + literal
    constants (recursing into nested code objects, whose default reprs
    embed memory addresses) + referenced names."""
    h = hashlib.sha256(code.co_code)
    for const in code.co_consts:
        if hasattr(const, "co_code"):
            h.update(_code_digest(const).encode())
        else:
            h.update(repr(const).encode())
    h.update(repr(code.co_names).encode())
    return h.hexdigest()


# --------------------------------------------------------------------------
# Execution plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StudyCell:
    """One point of the cross-product: frame row `index`."""
    index: int
    design: str
    workload: str
    fidelity: str
    config: AcceleratorConfig


@dataclasses.dataclass
class BatchGroup:
    """Cells that execute as ONE `_sweep_batched` call: same workload +
    fidelity and the static flavor (dataflow, word_bytes[, DramConfig],
    core grid, layout, sparse representation, NoC topology)."""
    workload: str
    fidelity: str
    dataflow: str
    word_bytes: int
    dram: Optional[DramConfig]
    cells: List[int]


@dataclasses.dataclass
class StudyPlan:
    cells: List[StudyCell]
    groups: List[BatchGroup]          # batched cells, by sweep flavor
    fallback: List[int]               # per-op engine and evaluator cells

    @property
    def n_batched(self) -> int:
        return sum(len(g.cells) for g in self.groups)

    def __len__(self) -> int:
        return len(self.cells)


# --------------------------------------------------------------------------
# Columnar result frame
# --------------------------------------------------------------------------

class StudyResult:
    """Pandas-free columnar frame: numpy columns + axis metadata.

    Axis columns (`design`, `workload`, `fidelity`) are object arrays of
    labels; metric columns are float64; `batched` is 1.0 for a cell of
    the batched sweep and 0.0 for a per-op or evaluator cell;
    `cell_status` is 1.0 for failed cells (the evaluation raised, or
    non-finite canonical metrics), whose metric columns read NaN: `ok()`
    drops them, `failed_cells` lists them, `argbest`/`pareto`/`topk`
    never pick them. `meta["engine"]` names the replay engine that ran
    ("cuda", "torch:plain" or "reference") when a fidelity replayed DRAM
    streams, `meta["device"]` the device.
    """

    # every in-process frame speaks the current schema; concat() checks
    # it so frames of another schema never mix silently
    schema_version = RESULT_SCHEMA_VERSION

    def __init__(self, columns: Dict[str, np.ndarray],
                 axes: Dict[str, List[str]], *,
                 executed_cells: int = 0, cache_hits: int = 0,
                 claims: Optional[List[Tuple[str, Callable]]] = None):
        self.columns = columns
        self.axes = axes
        self.executed_cells = executed_cells
        self.cache_hits = cache_hits
        self._claims = list(claims or [])
        self.meta: Dict[str, object] = {}

    def __len__(self) -> int:
        return 0 if not self.columns else len(next(iter(self.columns.values())))

    @property
    def fraction_batched(self) -> float:
        """Fraction of cells that executed through the batched sweep (1.0
        = the whole study ran batched)."""
        if not len(self) or "batched" not in self.columns:
            return 1.0
        return float(np.mean(self.columns["batched"]))

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[_METRIC_ALIASES.get(name, name)]

    def column_names(self) -> List[str]:
        return list(self.columns)

    def row(self, i: int) -> Dict[str, object]:
        return {k: (str(v[i]) if k in AXIS_COLUMNS else float(v[i]))
                for k, v in self.columns.items()}

    def rows(self) -> List[Dict[str, object]]:
        return [self.row(i) for i in range(len(self))]

    def equals(self, other: "StudyResult") -> bool:
        """Same columns, axes and values bit for bit; NaN in the same
        place counts as equal (a failed cell replays as the same failed
        cell)."""
        def _eq(a: np.ndarray, b: np.ndarray) -> bool:
            if a.dtype.kind == "f" and b.dtype.kind == "f":
                return np.array_equal(a, b, equal_nan=True)
            return np.array_equal(a, b)
        return (list(self.columns) == list(other.columns)
                and self.axes == other.axes
                and all(_eq(self.columns[k], other.columns[k])
                        for k in self.columns))

    # ---- relational ops ----------------------------------------------------
    def _subset(self, mask: np.ndarray) -> "StudyResult":
        # claims are scoped to the full frame and do not propagate
        cols = {k: v[mask] for k, v in self.columns.items()}
        axes = {a: [x for x in self.axes[a] if x in set(cols[a])]
                for a in self.axes}
        return StudyResult(cols, axes)

    def filter(self, pred: Optional[Callable[[Dict], bool]] = None,
               **eq) -> "StudyResult":
        """Row subset: keyword equality (scalar or collection of allowed
        values per column) and/or a row-dict predicate."""
        mask = np.ones(len(self), dtype=bool)
        for k, want in eq.items():
            col = self[k]
            if isinstance(want, (list, tuple, set, frozenset)):
                mask &= np.isin(col, list(want))
            else:
                mask &= (col == want)
        if pred is not None:
            mask &= np.array([bool(pred(self.row(i)))
                              for i in range(len(self))], dtype=bool)
        return self._subset(mask)

    def group(self, by: Union[str, Sequence[str]]
              ) -> Dict[object, "StudyResult"]:
        """Split into sub-frames keyed by the value(s) of `by`."""
        keys = (by,) if isinstance(by, str) else tuple(by)
        cols = [self[k] for k in keys]
        seen: List[object] = []
        for i in range(len(self)):
            key = tuple(c[i] for c in cols)
            key = key[0] if len(keys) == 1 else key
            if key not in seen:
                seen.append(key)
        return {key: self.filter(**(dict(zip(keys, key))
                                    if isinstance(key, tuple)
                                    else {keys[0]: key}))
                for key in seen}

    @property
    def failed_cells(self) -> List[int]:
        """Row indices of failed cells (`cell_status == 1`)."""
        if "cell_status" not in self.columns:
            return []
        return [int(i) for i in
                np.nonzero(self.columns["cell_status"] == 1.0)[0]]

    def ok(self) -> "StudyResult":
        """Subframe of the healthy rows only (drops failed cells)."""
        if "cell_status" not in self.columns:
            return self
        return self._subset(self.columns["cell_status"] != 1.0)

    def argbest(self, metric: str = "edp") -> int:
        """Row index minimizing `metric`; NaN rows never win, and an all-NaN
        column raises."""
        vals = np.asarray(self[metric], dtype=float)
        masked = np.where(np.isnan(vals), np.inf, vals)
        if not len(masked) or not np.isfinite(masked).any():
            raise ValueError(
                f"argbest({metric!r}): no finite values "
                f"({len(self.failed_cells)} failed cells of {len(self)})")
        return int(np.argmin(masked))

    def best(self, metric: str = "edp",
             by: Optional[Union[str, Sequence[str]]] = None):
        """Row (dict) minimizing `metric`; with `by`, the winner per group."""
        if by is None:
            return self.row(self.argbest(metric))
        return {k: sub.row(sub.argbest(metric))
                for k, sub in self.group(by).items()}

    def pareto(self, *objectives: str) -> "StudyResult":
        """Non-dominated rows, minimizing every objective; rows with a
        non-finite objective are excluded."""
        if not objectives:
            objectives = ("total_cycles", "energy_pj")
        vals = np.stack([np.asarray(self[m], dtype=float)
                         for m in objectives], axis=1)
        keep = np.isfinite(vals).all(axis=1)
        for i in np.nonzero(keep)[0]:
            dominated = (keep & (vals <= vals[i]).all(axis=1)
                         & (vals < vals[i]).any(axis=1))
            if dominated.any():
                keep[i] = False
        return self._subset(keep)

    def topk(self, metric: str, k: int) -> "StudyResult":
        """The `k` lowest-`metric` rows as a subframe, sorted ascending
        (stable: row order breaks ties). Rows with a non-finite value never
        place, so the subframe may hold fewer than `k` rows."""
        if k < 0:
            raise ValueError(f"topk k must be >= 0, got {k}")
        vals = np.asarray(self[metric], dtype=float)
        finite = np.isfinite(vals)
        order = np.argsort(np.where(finite, vals, np.inf), kind="stable")
        return self._subset(order[:min(int(k), int(finite.sum()))])

    @staticmethod
    def concat(frames: Sequence["StudyResult"]) -> "StudyResult":
        """Row-concatenate frames. Columns are the union in first-seen
        order (a metric missing from a frame fills with NaN); axis columns
        must be in every frame; axis vocabularies merge in first-seen
        order; every frame must carry the current schema version. Claims
        and meta do not propagate; executed/cache-hit counts sum."""
        frames = list(frames)
        if not frames:
            raise ValueError("concat() needs at least one frame")
        for f in frames:
            if getattr(f, "schema_version", None) != RESULT_SCHEMA_VERSION:
                raise ValueError(
                    f"cannot concat frame with schema_version "
                    f"{getattr(f, 'schema_version', None)!r} != supported "
                    f"{RESULT_SCHEMA_VERSION}")
        names: List[str] = []
        for f in frames:
            for c in f.column_names():
                if c not in names:
                    names.append(c)
        cols: Dict[str, np.ndarray] = {}
        for c in names:
            if c in AXIS_COLUMNS:
                missing = [i for i, f in enumerate(frames)
                           if c not in f.columns]
                if missing:
                    raise ValueError(
                        f"axis column {c!r} missing from concat frame(s) "
                        f"{missing}")
                cols[c] = np.concatenate(
                    [np.asarray(f.columns[c], dtype=object)
                     for f in frames])
            else:
                cols[c] = np.concatenate(
                    [np.asarray(f.columns[c], dtype=np.float64)
                     if c in f.columns
                     else np.full(len(f), np.nan) for f in frames])
        axes: Dict[str, List[str]] = {}
        for f in frames:
            for a, vocab in f.axes.items():
                dst = axes.setdefault(a, [])
                for v in vocab:
                    if v not in dst:
                        dst.append(v)
        return StudyResult(
            cols, axes,
            executed_cells=sum(f.executed_cells for f in frames),
            cache_hits=sum(f.cache_hits for f in frames))

    def compare(self, metric: str, *, axis: str,
                baseline: str) -> Dict[str, np.ndarray]:
        """Ratio of `metric` against the `baseline` value along one axis,
        matched on the remaining axis columns and row-aligned with
        `self.filter(**{axis: baseline})`; > 1 means worse than baseline."""
        other = [a for a in AXIS_COLUMNS if a != axis]
        base = self.filter(**{axis: baseline})
        if not len(base):
            raise KeyError(f"no rows with {axis}={baseline!r}")
        base_keys = list(zip(*(base[a] for a in other)))
        base_vals = np.asarray(base[metric], dtype=float)
        out: Dict[str, np.ndarray] = {}
        for v in self.axes[axis]:
            if v == baseline:
                continue
            sub = self.filter(**{axis: v})
            lut = {k: float(m) for k, m in
                   zip(zip(*(sub[a] for a in other)), sub[metric])}
            out[v] = np.array([lut[k] for k in base_keys]) / base_vals
        return out

    # ---- claims ------------------------------------------------------------
    def check_claims(self) -> Dict[str, bool]:
        """Evaluate the study's registered paper claims on this frame
        (claims do not survive a CSV round-trip)."""
        return {name: bool(fn(self)) for name, fn in self._claims}

    def claims_ok(self) -> bool:
        """True iff every registered claim holds; raises on a frame with no
        claims instead of returning a vacuous True."""
        claims = self.check_claims()
        if not claims:
            raise ValueError(
                "no claims registered on this frame (claims do not "
                "survive serialization); gate on check_claims() of the "
                "original Study.run() result")
        return all(claims.values())

    # ---- serialization (schema shared with the reference) -------------------
    def to_json(self) -> str:
        cols = {k: ([str(x) for x in v] if k in AXIS_COLUMNS
                    else [float(x) for x in v])
                for k, v in self.columns.items()}
        return json.dumps({"schema_version": RESULT_SCHEMA_VERSION,
                           "axes": self.axes, "columns": cols}, indent=1)

    @classmethod
    def from_json(cls, s: str) -> "StudyResult":
        d = json.loads(s)
        if d.get("schema_version") != RESULT_SCHEMA_VERSION:
            raise ValueError(
                f"study frame schema_version {d.get('schema_version')!r} "
                f"!= supported {RESULT_SCHEMA_VERSION}")
        cols = {k: (np.array(v, dtype=object) if k in AXIS_COLUMNS
                    else np.asarray(v, dtype=np.float64))
                for k, v in d["columns"].items()}
        return cls(cols, {a: list(v) for a, v in d["axes"].items()})

    def to_csv(self, path: str) -> None:
        names = list(self.columns)
        rows = [[(str(self.columns[c][i]) if c in AXIS_COLUMNS
                  else float(self.columns[c][i])) for c in names]
                for i in range(len(self))]
        write_csv_table(path, names, rows)

    @classmethod
    def from_csv(cls, path: str) -> "StudyResult":
        import csv
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            raw = [r for r in reader if r]
        cols: Dict[str, np.ndarray] = {}
        for j, name in enumerate(header):
            vals = [r[j] for r in raw]
            cols[name] = (np.array(vals, dtype=object)
                          if name in AXIS_COLUMNS
                          else np.array([float(v) for v in vals]))
        axes = {a: list(dict.fromkeys(cols[a])) for a in AXIS_COLUMNS
                if a in cols}
        return cls(cols, axes)

    def summary(self) -> str:
        lines = [f"{len(self)} cells | axes: "
                 + "; ".join(f"{a}={list(v)}" for a, v in self.axes.items())]
        metrics = [c for c in self.columns
                   if c not in AXIS_COLUMNS
                   and c not in ("batched", "cell_status")]
        failed = set(self.failed_cells)
        for i in range(len(self)):
            tag = " ".join(str(self.columns[a][i]) for a in AXIS_COLUMNS
                           if a in self.columns)
            if i in failed:
                lines.append(f"  {tag}: FAILED")
                continue
            vals = " ".join(f"{m}={float(self.columns[m][i]):.4g}"
                            for m in metrics[:6])
            lines.append(f"  {tag}: {vals}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# The Study builder
# --------------------------------------------------------------------------

class Study:
    """Declarative cross-product experiment plan (builder pattern): every
    setter returns `self`; `run` compiles the plan, executes it and
    returns a `StudyResult`."""

    def __init__(self, name: str = "study"):
        self.name = name
        self._designs: List[Tuple[str, AcceleratorConfig]] = []
        self._workloads: Dict[str, List[Op]] = {}
        self._fidelities: Tuple[str, ...] = ("fast",)
        self._metrics: Optional[Tuple[str, ...]] = None
        self._ert: ERT = DEFAULT_ERT
        self._engine: Optional[str] = None
        self._spec = None
        self._core_index: int = 0
        self._force_fallback: bool = False
        self._cache_dir: Optional[str] = None
        self._evaluator: Optional[Callable] = None
        self._claims: List[Tuple[str, Callable]] = []
        # registry provenance ({"study": name, "kwargs": {...}}), set by
        # get_study: to_spec serializes a registry study by reference, so
        # its claims and evaluator survive the round trip
        self._ref: Optional[Dict[str, object]] = None

    # ---- axes --------------------------------------------------------------
    def designs(self, configs, labels: Optional[Sequence[str]] = None
                ) -> "Study":
        """Design axis: dict {label: ConfigLike} or a sequence (e.g. a
        `preset_grid`) — sequence entries are auto-labeled
        `{rows}x{cols}-{dataflow}`, with the operand-SRAM size appended on
        geometry collisions and `#k` de-duplication suffixes."""
        out: List[Tuple[str, AcceleratorConfig]] = []
        if isinstance(configs, dict):
            out = [(str(k), as_config(v)) for k, v in configs.items()]
        else:
            cfgs = [as_config(c) for c in configs]
            if labels is not None:
                if len(labels) != len(cfgs):
                    raise ValueError("labels/configs length mismatch")
                out = list(zip([str(x) for x in labels], cfgs))
            else:
                def auto(c: AcceleratorConfig) -> str:
                    b = f"{c.cores[0].rows}x{c.cores[0].cols}-{c.dataflow}"
                    if c.num_cores > 1:
                        b += f"-{c.num_cores}c"
                    if c.sparsity.enabled:
                        b += (f"-{c.sparsity.n}:{c.sparsity.m}"
                              + ("rw" if c.sparsity.row_wise else ""))
                    if c.layout.enabled:
                        b += "-lay"
                    return b
                base = [auto(c) for c in cfgs]
                counts: Dict[str, int] = {}
                for b in base:
                    counts[b] = counts.get(b, 0) + 1
                labeled = []
                for b, c in zip(base, cfgs):
                    if counts[b] > 1:
                        mb = (c.memory.ifmap_sram_bytes
                              + c.memory.filter_sram_bytes
                              + c.memory.ofmap_sram_bytes) / (1 << 20)
                        b = f"{b}@{mb:.3g}MB"
                    labeled.append(b)
                seen: Dict[str, int] = {}
                for b, c in zip(labeled, cfgs):
                    k = seen.get(b, 0)
                    seen[b] = k + 1
                    out.append((b if k == 0 else f"{b}#{k}", c))
        if len({l for l, _ in out}) != len(out):
            raise ValueError("design labels must be unique")
        self._designs = out
        return self

    def workloads(self, *wls) -> "Study":
        """Workload axis: dicts {name: ops-or-paper-workload-name} and/or
        bare paper-workload names ('resnet18', 'vit_base', ...)."""
        m: Dict[str, List[Op]] = {}
        for w in wls:
            if isinstance(w, dict):
                for k, v in w.items():
                    m[str(k)] = as_workload(v)
            elif isinstance(w, str):
                m[w] = as_workload(w)
            else:
                raise TypeError(f"workloads() takes dicts or names, "
                                f"got {type(w)!r}")
        if not m:
            raise ValueError("workloads() needs at least one workload")
        self._workloads = m
        return self

    def fidelity(self, *fids: str) -> "Study":
        for f in fids:
            if f not in st.FIDELITIES:
                raise ValueError(f"fidelity must be one of {st.FIDELITIES}, "
                                 f"got {f!r}")
        if not fids:
            raise ValueError("fidelity() needs at least one level")
        self._fidelities = tuple(fids)
        return self

    # ---- options -----------------------------------------------------------
    def metrics(self, *names: str) -> "Study":
        """Restrict the frame's metric columns (axis columns, `batched` and
        `cell_status` always kept). Aliases: latency/cycles ->
        total_cycles, energy -> energy_pj."""
        self._metrics = tuple(_METRIC_ALIASES.get(n, n) for n in names)
        return self

    def options(self, *, ert: Optional[ERT] = None,
                engine: Optional[str] = None, trace_spec=None,
                core_index: Optional[int] = None,
                force_fallback: Optional[bool] = None) -> "Study":
        """Execution knobs shared by every cell: the energy table, the
        replay engine (`core.replay.ENGINES`), the trace spec, the core a
        heterogeneous mesh is analysed through, and `force_fallback`: run
        every cell through the per-op engine instead of the batched sweep
        (the differential-parity reference; same result contract, no
        batching)."""
        from ..core import replay as _rp
        if ert is not None:
            self._ert = ert
        if engine is not None:
            self._engine = _rp.resolve_engine(engine)
        if trace_spec is not None:
            self._spec = trace_spec
        if core_index is not None:
            self._core_index = int(core_index)
        if force_fallback is not None:
            self._force_fallback = bool(force_fallback)
        return self

    def cache(self, path: str) -> "Study":
        """Content-hash keyed on-disk cell cache: a rerun executes only the
        cells whose (config, ops, fidelity, ERT, engine, spec, core,
        force_fallback, evaluator, device type) content changed."""
        self._cache_dir = path
        return self

    def evaluator(self, fn: Callable) -> "Study":
        """Custom per-cell evaluator replacing the simulation pipeline (e.g.
        the multi-core contention study). The port calls it as
        `fn(config, ops, fidelity, device=device)`: the reference's
        `(config, ops, fidelity)` plus the device the study runs on, which
        the port makes explicit. Its cells run one at a time
        (`batched = 0.0`) and cache, keyed by the study name, the
        evaluator's qualname and a digest of its code (closure state is not
        hashed: give studies whose evaluators differ only there distinct
        names or cache directories)."""
        self._evaluator = fn
        return self

    def claim(self, name: str, fn: Callable[[StudyResult], bool]) -> "Study":
        """Attach a machine-checkable paper claim, evaluated on the frame
        via `StudyResult.check_claims()`."""
        self._claims.append((name, fn))
        return self

    # ---- wire format -----------------------------------------------------------
    def to_spec(self) -> dict:
        """JSON-serializable description of this study. A registry study
        (built via `get_study` or `studies.*`) serializes as a reference,
        rebuilt through the registry with its claims and evaluator; an
        ad-hoc study serializes inline (designs, workloads, fidelities,
        options), without claims, and refuses a custom evaluator."""
        if self._ref is not None:
            try:
                json.dumps(self._ref["kwargs"])
            except TypeError as e:
                raise ValueError(
                    "registry study kwargs must be JSON-serializable to "
                    "travel as a spec; rebuild the study with plain "
                    "kwargs or use an inline (non-registry) study") from e
            return {"kind": "study_spec",
                    "schema_version": RESULT_SCHEMA_VERSION,
                    "ref": {"study": self._ref["study"],
                            "kwargs": dict(self._ref["kwargs"])}}
        if self._evaluator is not None:
            raise ValueError(
                "a custom evaluator is not serializable; register the "
                "study (register_study) and build it by name")
        return {
            "kind": "study_spec",
            "schema_version": RESULT_SCHEMA_VERSION,
            "ref": None,
            "name": self.name,
            "designs": [[label, cfg.to_dict()]
                        for label, cfg in self._designs],
            "workloads": {
                name: [[o.name, o.M, o.N, o.K, o.count, o.kind,
                        o.vector_elems,
                        list(o.sparsity_nm) if o.sparsity_nm else None]
                       for o in ops]
                for name, ops in self._workloads.items()},
            "fidelities": list(self._fidelities),
            "metrics": (list(self._metrics)
                        if self._metrics is not None else None),
            "ert": dataclasses.asdict(self._ert),
            "engine": self._engine,
            "trace_spec": (dataclasses.asdict(self._spec)
                           if self._spec is not None else None),
            "core_index": self._core_index,
            "force_fallback": self._force_fallback,
        }

    @classmethod
    def from_spec(cls, d: dict) -> "Study":
        """Rebuild a study from `to_spec()` output (reference specs through
        the registry, inline specs field by field); cell hashes survive the
        round trip."""
        if not isinstance(d, dict) or d.get("kind") != "study_spec":
            raise ValueError("not a study spec (missing kind=study_spec)")
        if d.get("schema_version") != RESULT_SCHEMA_VERSION:
            raise ValueError(
                f"study spec schema_version {d.get('schema_version')!r} "
                f"!= supported {RESULT_SCHEMA_VERSION}")
        if d.get("ref"):
            return get_study(d["ref"]["study"], **d["ref"].get("kwargs", {}))
        s = cls(d.get("name", "study"))
        s._designs = [(str(label), AcceleratorConfig.from_dict(cfg))
                      for label, cfg in d["designs"]]
        s._workloads = {
            name: [Op(o[0], int(o[1]), int(o[2]), int(o[3]), float(o[4]),
                      o[5], float(o[6]),
                      tuple(int(x) for x in o[7]) if o[7] else None)
                   for o in ops]
            for name, ops in d["workloads"].items()}
        s._fidelities = tuple(d["fidelities"])
        if d.get("metrics") is not None:
            s._metrics = tuple(d["metrics"])
        s._ert = ERT(**d["ert"])
        s._engine = d.get("engine")
        if d.get("trace_spec") is not None:
            from ..trace.generator import TraceSpec
            s._spec = TraceSpec(**d["trace_spec"])
        s._core_index = int(d.get("core_index", 0))
        s._force_fallback = bool(d.get("force_fallback", False))
        return s

    # ---- plan + run --------------------------------------------------------
    def _spec_for(self, fidelity: str):
        if fidelity != "trace":
            return None
        if self._spec is None:
            from ..trace.generator import DEFAULT_SPEC
            return DEFAULT_SPEC
        return self._spec

    def plan(self) -> StudyPlan:
        """Compile the cross-product into cells + batchable groups. Cell
        order (= frame row order): fidelity-major, then workload, design
        fastest. `fast` and `trace` cells form groups; `cycle` cells, the
        cells of a `force_fallback` study and evaluator cells go to
        `fallback`, run one at a time."""
        if not self._designs:
            raise ValueError("Study has no designs; call .designs(...)")
        if not self._workloads:
            raise ValueError("Study has no workloads; call .workloads(...)")
        cells: List[StudyCell] = []
        for fid in self._fidelities:
            for wname in self._workloads:
                for label, cfg in self._designs:
                    cells.append(StudyCell(len(cells), label, wname, fid,
                                           cfg))
        by_key: Dict[tuple, List[int]] = {}
        fallback: List[int] = []
        for c in cells:
            if (self._evaluator is not None or self._force_fallback
                    or c.fidelity == "cycle"):
                fallback.append(c.index)
                continue
            cfg = c.config
            key = (c.workload, c.fidelity, cfg.dataflow,
                   cfg.memory.word_bytes,
                   cfg.dram if c.fidelity == "trace" else None,
                   # `_sweep_batched` reads the grid from the group's first
                   # design, so the grid is part of the flavor
                   (cfg.mesh_rows, cfg.mesh_cols),
                   # layout fields only matter when enabled: disabled
                   # cells share one flavor (and skip the layout math)
                   cfg.layout if cfg.layout.enabled else None,
                   cfg.sparsity.representation,
                   # NoC topology fixes the static routing tree; link
                   # parameters stay design columns inside the group
                   noc_kind(cfg))
            by_key.setdefault(key, []).append(c.index)
        groups = [BatchGroup(*key[:5], cells=idxs)
                  for key, idxs in by_key.items()]
        return StudyPlan(cells=cells, groups=groups, fallback=fallback)

    def _cell_hash(self, cell: StudyCell, device) -> str:
        """The cell's cache key: everything its metrics depend on, plus the
        package (this port and the JAX package agree only to 1e-3, so
        their cells never alias in a shared directory) and the device
        type (the card's kernels and their plain versions agree to 1e-3
        too)."""
        from ..core import replay as _rp
        spec = self._spec_for(cell.fidelity)
        payload = {
            "package": "repro_torch",
            "device": torch.device(device).type,
            "schema_version": RESULT_SCHEMA_VERSION,
            "config": cell.config.to_dict(),
            "ops": [(o.name, o.M, o.N, o.K, o.count, o.kind,
                     o.vector_elems, o.sparsity_nm)
                    for o in self._workloads[cell.workload]],
            "fidelity": cell.fidelity,
            "ert": dataclasses.asdict(self._ert),
            "engine": _rp.resolve_engine(self._engine),
            "spec": dataclasses.asdict(spec) if spec is not None else None,
            "core_index": self._core_index,
            # the per-op oracle and the batched sweep agree only to 1e-3:
            # their cells never alias
            "force_fallback": self._force_fallback,
            "evaluator": self._evaluator_key(),
        }
        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()

    def _evaluator_key(self):
        """Cache identity of a custom evaluator: study name + qualname +
        a digest of the code object (see `evaluator()`)."""
        fn = self._evaluator
        if fn is None:
            return None
        code = getattr(fn, "__code__", None)
        return [self.name, getattr(fn, "__qualname__", repr(fn)),
                _code_digest(code) if code is not None else None]

    def _cache_load(self, cache_dir: str, h: str
                    ) -> Optional[Dict[str, float]]:
        """Load one cached cell; anything unreadable (corrupt, truncated,
        wrong-shaped or of another schema) is a miss, never a crash."""
        path = os.path.join(cache_dir, h + ".json")
        try:
            with open(path) as f:
                d = json.load(f)
            if d.get("schema_version") != RESULT_SCHEMA_VERSION:
                return None
            return {k: float(v) for k, v in d["metrics"].items()}
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            return None

    def _cache_store(self, cache_dir: str, h: str,
                     metrics: Dict[str, float]) -> None:
        """Multi-process-safe store (temp file + `os.replace`): racing
        writers of one cell write the same content, so the last replace
        wins harmlessly. Routed through the fault shim
        (`site="cache.store"`) so the chaos schedules can land corrupt
        entries, which `_cache_load` degrades to misses."""
        _fs.atomic_write_json(
            os.path.join(cache_dir, h + ".json"),
            {"schema_version": RESULT_SCHEMA_VERSION, "study": self.name,
             "metrics": metrics},
            site="cache.store", indent=None)

    def run(self, *, device=None, mesh=None, cache: Optional[str] = None
            ) -> StudyResult:
        """Execute the plan on `device` (CUDA by default; pass "cpu" for the
        plain PyTorch version) and return the columnar frame.

        mesh: shard each batched group's design axis over a mesh of this
        process's devices (`launch/mesh.py::make_device_mesh`; see
        `Simulator.sweep`); the per-op cells run on `device`, which is
        then the mesh's first device unless named (and must be one of
        the mesh's). cache: overrides the builder's cache directory for
        this run only."""
        device = _mesh_device(mesh, device)
        cache_dir = cache if cache is not None else self._cache_dir
        plan = self.plan()
        results, executed, hits = self._execute_cells(
            plan, cache_dir=cache_dir, device=device, mesh=mesh)
        return self._frame(plan.cells,
                           [results[i] for i in range(len(plan.cells))],
                           executed, hits, device)

    def _per_op_metrics(self, cell: StudyCell, ops: Sequence[Op],
                        pipelines: Dict[str, tuple], device
                        ) -> Dict[str, float]:
        """One cell through the per-op engine (one pipeline per fidelity,
        built once per run), with the NoC columns on a NoC pod."""
        if cell.fidelity not in pipelines:
            pipelines[cell.fidelity] = st.build_pipeline(
                cell.fidelity, core_index=self._core_index,
                trace_spec=self._spec_for(cell.fidelity),
                engine=self._engine, device=device)
        rep = simulate_network(cell.config, ops, ert=self._ert,
                               pipeline=pipelines[cell.fidelity])
        m = dict(total_cycles=rep.total_cycles,
                 compute_cycles=rep.compute_cycles,
                 stall_cycles=rep.stall_cycles, dram_bytes=rep.dram_bytes,
                 energy_pj=rep.energy_pj, utilization=rep.utilization,
                 edp=rep.edp, **energy_group_totals(rep.energy_breakdown))
        if noc_kind(cell.config) is not None:
            m["noc_stall_cycles"] = rep.noc_stall_cycles
            m["noc_link_util"] = max(
                (o.noc_stats or {}).get("noc_link_util", 0.0)
                for o in rep.ops)
            m["allreduce_cycles"] = sum(
                (o.noc_stats or {}).get("allreduce_cycles", 0.0) * op.count
                for o, op in zip(rep.ops, ops))
        return m

    def _execute_cells(self, plan: StudyPlan,
                       indices: Optional[Sequence[int]] = None, *,
                       cache_dir: Optional[str] = None, device=None,
                       mesh=None
                       ) -> Tuple[Dict[int, Dict[str, float]], int, int]:
        """Execute a subset of the plan's cells (default: all of them) on
        `device` (CUDA unless the caller asks for the CPU), the batched
        groups over `mesh` when one is given (as `run` takes them).

        Returns ({cell_index: metrics}, executed_cells, cache_hits): the
        unit of work of a farm worker, one shard's cell indices against a
        shared cache directory. A batched group's selected, cache-missing
        cells still run as one `_sweep_batched` call; each design's
        values do not depend on which others share the call.

        Failure semantics: a group or cell whose evaluation raises, or
        whose canonical metrics come back NaN (or +-Inf), becomes failed
        cells (`cell_status = 1.0`, NaN metrics in the frame); nothing is
        rerun elsewhere. `ValueError` marks an invalid configuration and
        propagates. Completed cells land in the cache as they finish (a
        killed run resumes from its last completed cell); failed cells
        are never cached.
        """
        device = _mesh_device(mesh, device)
        if indices is None:
            sel = set(range(len(plan.cells)))
        else:
            sel = {int(i) for i in indices}
            bad = sel - set(range(len(plan.cells)))
            if bad:
                raise IndexError(f"cell indices {sorted(bad)} outside the "
                                 f"{len(plan.cells)}-cell plan")
        results: Dict[int, Dict[str, float]] = {}
        hashes: Dict[int, str] = {}
        hits = executed = 0
        if cache_dir is not None:
            for i in sorted(sel):
                hashes[i] = self._cell_hash(plan.cells[i], device)
                got = self._cache_load(cache_dir, hashes[i])
                if got is not None:
                    results[i] = got
                    hits += 1
        loaded = set(results)

        def finish(i: int, m: Dict[str, float]) -> None:
            nonlocal executed
            results[i] = m
            _flag_non_finite(m)
            executed += 1
            # best effort: a full disk must not fail a computed cell
            if (cache_dir is not None and i not in loaded
                    and not m.get("cell_status")):
                try:
                    self._cache_store(cache_dir, hashes[i], m)
                except OSError:
                    pass

        for grp in plan.groups:
            miss = [i for i in grp.cells if i in sel and i not in results]
            if not miss:
                continue
            try:
                vals = _sweep_batched(
                    [plan.cells[i].config for i in miss],
                    self._workloads[grp.workload], grp.dataflow,
                    grp.word_bytes, self._ert, dram=grp.dram,
                    spec=self._spec_for(grp.fidelity), engine=self._engine,
                    device=device, core_index=self._core_index, mesh=mesh)
                vals["edp"] = _edp(vals["energy_pj"], vals["total_cycles"])
            except ValueError:
                raise    # invalid configuration: loud, never a failed cell
            except Exception:  # noqa: BLE001 -- the group fails, study lives
                for i in miss:
                    results[i] = {"batched": 1.0, "cell_status": 1.0}
                continue
            for j, i in enumerate(miss):
                m = {k: float(v[j]) for k, v in vals.items()}
                m["batched"] = 1.0
                finish(i, m)

        pipelines: Dict[str, tuple] = {}
        for i in plan.fallback:
            if i not in sel or i in results:
                continue
            cell = plan.cells[i]
            ops = self._workloads[cell.workload]
            try:
                if self._evaluator is not None:
                    m = {k: float(v) for k, v in self._evaluator(
                        cell.config, ops, cell.fidelity,
                        device=device).items()}
                else:
                    m = self._per_op_metrics(cell, ops, pipelines, device)
            except ValueError:
                raise    # invalid configuration: loud, never a failed cell
            except Exception:  # noqa: BLE001 -- one bad cell, study lives
                results[i] = {"batched": 0.0, "cell_status": 1.0}
                continue
            m["batched"] = 0.0
            finish(i, m)
        return results, executed, hits

    def assemble_frame(self, results: Dict[int, Dict[str, float]], *,
                       executed_cells: int = 0, cache_hits: int = 0,
                       plan: Optional[StudyPlan] = None,
                       partial: bool = False, device=None) -> StudyResult:
        """Build the frame from per-cell metric dicts keyed by plan index
        (a farm client's reassembly), through the code `run()` uses, so
        with every cell present the frame equals a local run's. `device`
        is where the cells ran, as the workers report it (it labels
        `meta`; None when no cell ran, and then `meta` names no device).
        Nothing runs here, so a frame of CUDA cells assembles without a
        card. `partial=True` permits missing cells and returns the
        completed rows only."""
        device = None if device is None else torch.device(device)
        plan = self.plan() if plan is None else plan
        have = sorted(int(i) for i in results)
        if not partial:
            missing = sorted(set(range(len(plan.cells))) - set(have))
            if missing:
                raise ValueError(
                    f"{len(missing)} cells missing (e.g. {missing[:4]}); "
                    f"pass partial=True for an incremental frame")
        return self._frame([plan.cells[i] for i in have],
                           [results[i] for i in have],
                           executed_cells, cache_hits, device)

    def _frame(self, cells: Sequence[StudyCell],
               results: List[Dict[str, float]], executed: int, hits: int,
               device) -> StudyResult:
        from ..core import replay as _rp
        metric_names = [m for m in METRIC_COLUMNS
                        if any(m in r for r in results)]
        # other metrics (an evaluator's own, the NoC columns) follow the
        # canonical ones, sorted
        metric_names += sorted({k for r in results for k in r}
                               - set(metric_names)
                               - {"batched", "cell_status"})
        if self._metrics is not None:
            missing = set(self._metrics) - set(metric_names)
            if missing:
                raise KeyError(f"metrics not produced by this study: "
                               f"{sorted(missing)}")
            metric_names = [m for m in metric_names if m in self._metrics]
        cols: Dict[str, np.ndarray] = {
            "design": np.array([c.design for c in cells], dtype=object),
            "workload": np.array([c.workload for c in cells], dtype=object),
            "fidelity": np.array([c.fidelity for c in cells], dtype=object),
        }
        for m in metric_names:
            cols[m] = np.array([r.get(m, np.nan) for r in results],
                               dtype=np.float64)
        cols["batched"] = np.array([r.get("batched", 0.0) for r in results],
                                   dtype=np.float64)
        cols["cell_status"] = np.array(
            [r.get("cell_status", 0.0) for r in results], dtype=np.float64)
        axes = {"design": [l for l, _ in self._designs],
                "workload": list(self._workloads),
                "fidelity": list(self._fidelities)}
        res = StudyResult(cols, axes, executed_cells=executed,
                          cache_hits=hits, claims=self._claims)
        if device is None:
            return res
        if any(f in ("trace", "cycle") for f in self._fidelities):
            res.meta["engine"] = _rp.resolve_engine_runtime(self._engine,
                                                            device)
        res.meta["device"] = str(device)
        return res


# --------------------------------------------------------------------------
# Named studies: the paper's analyses as first-class objects
# --------------------------------------------------------------------------

_STUDIES: Dict[str, Callable[..., Study]] = {}


def register_study(name: str):
    """Decorator: register a Study factory under `name`."""
    def deco(fn: Callable[..., Study]):
        if name in _STUDIES:
            raise ValueError(f"study {name!r} already registered")
        _STUDIES[name] = fn
        return fn
    return deco


def get_study(name: str, **kw) -> Study:
    if name not in _STUDIES:
        raise KeyError(f"unknown study {name!r}; "
                       f"available: {sorted(_STUDIES)}")
    s = _STUDIES[name](**kw)
    # registry provenance: lets Study.to_spec serialize by reference, so
    # the rebuilt study keeps its claims and evaluator
    s._ref = {"study": name, "kwargs": dict(kw)}
    return s


def list_studies() -> List[str]:
    return sorted(_STUDIES)


class _StudyNamespace:
    """`studies.edp_array_size(...)` attribute access over the registry."""

    def __getattr__(self, name: str) -> Callable[..., Study]:
        if name in _STUDIES:
            # through get_study, so the study carries its provenance
            import functools

            @functools.wraps(_STUDIES[name])
            def factory(**kw) -> Study:
                return get_study(name, **kw)
            return factory
        raise AttributeError(f"no study {name!r}; "
                             f"available: {sorted(_STUDIES)}")

    def __dir__(self):
        return sorted(_STUDIES)


studies = _StudyNamespace()


@register_study("edp_array_size")
def edp_array_size(smoke: bool = False) -> Study:
    """Paper Table V: array-size sweep on ViT-base linear layers.
    32x32 wins energy (~2.86x vs 128x128), 128x128 wins latency, and
    64x64 wins EdP. `smoke` shrinks to 2 transformer layers (identical
    per-layer shapes, so every ratio/winner claim is layer-count
    invariant)."""
    from ..core.workloads import vit_linear
    wl = vit_linear(768, 2 if smoke else 12, 3072, prefix="vitb")
    s = (Study("edp_array_size")
         .designs({"32": "paper-32", "64": "paper-64", "128": "paper-128"})
         .workloads({"vit-base": wl})
         .fidelity("fast"))
    s.claim("latency_winner_is_128",
            lambda r: r.best("total_cycles")["design"] == "128")
    s.claim("energy_winner_is_32",
            lambda r: r.best("energy_pj")["design"] == "32")
    s.claim("edp_winner_64_between_extremes",
            lambda r: r.best("edp")["design"] == "64")
    s.claim("energy_ratio_128_vs_32_in_band",
            lambda r: 2.3 < float(r.compare("energy_pj", axis="design",
                                            baseline="32")["128"][0]) < 3.4)
    return s


@register_study("dataflow_dram_flip")
def dataflow_dram_flip() -> Study:
    """Paper Sec. IX-B: WS beats OS on compute cycles, but OS wins
    end-to-end once DRAM stalls are modeled — and the OS advantage grows
    at trace fidelity, where the stall model sees the address stream each
    dataflow emits."""
    from ..core.accelerator import tpu_like_config
    from ..core.workloads import resnet18_six_layers
    designs = {df: tpu_like_config(array=32, dataflow=df, sram_mb=0.4)
               for df in ("ws", "os")}
    s = (Study("dataflow_dram_flip")
         .designs(designs)
         .workloads({"resnet18-6": resnet18_six_layers()})
         .fidelity("fast", "trace"))
    s.claim("ws_wins_compute_cycles",
            lambda r: all(
                r.filter(fidelity=f).best("compute_cycles")["design"] == "ws"
                for f in r.axes["fidelity"]))
    s.claim("os_wins_total_once_stalls_modeled",
            lambda r: r.filter(fidelity="trace")
                       .best("total_cycles")["design"] == "os")
    s.claim("os_margin_at_least_20pct",
            lambda r: float(
                r.filter(fidelity="trace").compare(
                    "total_cycles", axis="design", baseline="ws")["os"][0])
            < 0.8)
    s.claim("trace_fidelity_amplifies_flip",
            lambda r: float(r.filter(fidelity="trace").compare(
                "total_cycles", axis="design", baseline="os")["ws"][0])
            > float(r.filter(fidelity="fast").compare(
                "total_cycles", axis="design", baseline="os")["ws"][0]))
    return s


@register_study("multicore_contention")
def multicore_contention_study(channels: Sequence[int] = (1, 2, 4),
                               gemm: Tuple[int, int, int] = (512, 2048, 1024),
                               spec=None) -> Study:
    """Shared-DRAM contention across channel counts on the MCM package:
    per-core demand traces merged through shared channels vs each core
    alone (`simulate_multicore_contention`). The shared run never beats
    isolation, contention is material (>10% makespan inflation), and
    adding channels relieves the shared makespan. Its cells run through
    the study's evaluator, one per design, on the study's device."""
    from ..core.multicore import contention_summary
    from .presets import get_preset
    M, N, K = gemm

    def cell(cfg: AcceleratorConfig, ops: Sequence[Op], fidelity: str, *,
             device) -> Dict[str, float]:
        o = ops[0]
        return contention_summary(cfg, o.M, o.N, o.K, spec=spec,
                                  device=device)

    s = (Study("multicore_contention")
         .designs({f"ch{c}": get_preset("mcm-4x32", channels=c)
                   for c in channels})
         .workloads({f"gemm-{M}x{N}x{K}": [Op("gemm", M, N, K)]})
         .fidelity("trace")
         .options(trace_spec=spec)
         .evaluator(cell))
    s.claim("shared_never_beats_isolated",
            lambda r: bool((r["makespan_shared"]
                            >= r["makespan_isolated"] - 1e-6).all()))
    s.claim("contention_is_material",
            lambda r: bool((r["contention_slowdown"] > 1.1).all()))
    s.claim("more_channels_relieve_shared_makespan",
            lambda r: bool(np.all(np.diff(
                r["makespan_shared"][np.argsort(r["channels"])]) <= 0.0)))
    return s


@register_study("sparse_speedup")
def sparse_speedup(smoke: bool = False) -> Study:
    """Paper Sec. IV SpMM claim: on a weight-stationary array streaming
    compressed weights, layer-wise N:M sparsity shrinks compute cycles by
    ~m/n (2:4 halves them, 1:4 quarters them), while row-wise N:M (whose
    per-(row, block) nonzero count is Uniform{1..m/2} and whose fold length
    is the lockstep max over the fold's columns, `core.sparsity.
    effective_K_model`) lands strictly between dense and the matched
    layer-wise ratio. Every cell, sparse included, executes through the
    batched sweep (`fraction_batched == 1.0`). `smoke` shrinks the token
    dimension; the fold-count ratios the claims test are token-count
    invariant."""
    from .presets import get_preset
    n_tok = 128 if smoke else 1024
    wl = [Op("spmm-ffn1", 4096, n_tok, 1024),
          Op("spmm-ffn2", 1024, n_tok, 4096)]
    s = (Study("sparse_speedup")
         .designs({
             "dense": get_preset("paper-64"),
             "lw-2:4": get_preset("ws-64-sparse-2:4"),
             "lw-1:4": get_preset("ws-64-sparse-2:4", n=1),
             "rw-1:4": get_preset("ws-64-sparse-2:4", n=1, row_wise=True),
         })
         .workloads({"spmm-ffn": wl})
         .fidelity("fast"))

    def speedup(r: StudyResult, design: str) -> float:
        return 1.0 / float(r.compare("compute_cycles", axis="design",
                                     baseline="dense")[design][0])

    s.claim("layerwise_2to4_speedup_near_2x",
            lambda r: 1.9 < speedup(r, "lw-2:4") <= 2.05)
    s.claim("layerwise_1to4_speedup_near_4x",
            lambda r: 3.6 < speedup(r, "lw-1:4") <= 4.1)
    s.claim("rowwise_lands_between_dense_and_layerwise",
            lambda r: float(r.filter(design="lw-1:4")["compute_cycles"][0])
            < float(r.filter(design="rw-1:4")["compute_cycles"][0])
            < float(r.filter(design="dense")["compute_cycles"][0]))
    s.claim("compressed_weights_cut_dram_traffic",
            lambda r: float(r.filter(design="lw-2:4")["dram_bytes"][0])
            < float(r.filter(design="dense")["dram_bytes"][0]))
    s.claim("all_cells_batched",
            lambda r: r.fraction_batched == 1.0)
    return s


@register_study("nop_bound")
def nop_bound(smoke: bool = False) -> Study:
    """Pod-scale NoP study (the routed NoC plane, `repro_torch.noc`): sweep
    cores x link bandwidth x DRAM channels on routed-mesh pods and
    machine-check where the interconnect, not DRAM bandwidth, bounds the
    design:

    (a) with contention removed (huge link bandwidth and credit depth) the
        routed NoC reproduces the legacy hop-offset multicore cycles
        exactly (the zero-load contract, bit for bit);
    (b) beyond a core count, NoP link utilization (> 1: offered load
        exceeds link capacity), not DRAM bandwidth, dominates stall
        cycles: routed queueing overtakes DRAM stalls at the largest pod,
        and adding DRAM channels stops helping there while it still
        relieves the smallest pod;
    (c) a torus beats a mesh on ring all-reduce makespan at fixed link
        budget (the mesh serpentine must close over already-used links).

    Every cell, 16 to 1,024 cores, runs through the batched sweep
    (`fraction_batched == 1.0`).
    """
    from ..noc.topology import routed_hop_counts
    from .presets import get_preset

    pods = (16, 64, 256) if smoke else (64, 256, 1024)
    bw_lo, bw_hi = 4.0, 256.0
    ch_lo, ch_hi = 1, 8
    mm = 512 if smoke else 2048
    wl = [Op("mm1", mm, mm, mm), Op("mm2", 2 * mm, mm // 2, mm)]

    designs: Dict[str, AcceleratorConfig] = {}
    for p in pods:
        for bw in (bw_lo, bw_hi):
            for ch in (ch_lo, ch_hi):
                # scale credit depth with link bandwidth so the fast-link
                # corner is genuinely fast (with a fixed shallow buffer,
                # the credit round-trip s = 2*hop/buffer caps throughput
                # no matter how wide the link is)
                designs[f"mesh-{p}c-bw{int(bw)}-ch{ch}"] = get_preset(
                    "pod-mesh", cores=p, link_bw=bw, channels=ch,
                    buffer_flits=max(8, int(bw)))
        designs[f"torus-{p}c"] = get_preset(
            "pod-mesh", cores=p, topology="torus", link_bw=bw_lo,
            channels=ch_hi, buffer_flits=max(8, int(bw_lo)))

    # the exact zero-load parity pair: legacy per-core hop offsets set to
    # the routed mesh hop counts vs the NoC plane at effectively infinite
    # link bandwidth and credit depth (claim a is bit-for-bit equality)
    legacy = get_preset("pod-mesh", cores=16)
    legacy = legacy.with_(
        cores=tuple(dataclasses.replace(c, nop_hops=int(h))
                    for c, h in zip(legacy.cores,
                                    routed_hop_counts("mesh", 4, 4))),
        noc=dataclasses.replace(legacy.noc, enabled=False))
    designs["legacy-hops"] = legacy
    designs["noc-zero-load"] = get_preset(
        "pod-mesh", cores=16, link_bw=1e9, buffer_flits=1 << 20)

    s = (Study("nop_bound")
         .designs(designs)
         .workloads({f"mm-{mm}": wl})
         .fidelity("fast"))

    def cell(r: StudyResult, design: str, metric: str) -> float:
        return float(r.filter(design=design)[metric][0])

    big, small = pods[-1], pods[0]
    bound = f"mesh-{big}c-bw{int(bw_lo)}-ch{ch_hi}"      # NoP-bound corner
    free = f"mesh-{small}c-bw{int(bw_hi)}-ch{ch_hi}"     # DRAM-bound corner
    s.claim("zero_load_matches_legacy_exactly",
            lambda r: cell(r, "noc-zero-load", "total_cycles")
            == cell(r, "legacy-hops", "total_cycles"))
    s.claim("nop_overtakes_dram_stalls_at_scale",
            lambda r: cell(r, bound, "noc_stall_cycles")
            > cell(r, bound, "stall_cycles")
            and cell(r, free, "noc_stall_cycles")
            < cell(r, free, "stall_cycles"))
    s.claim("link_utilization_scales_with_cores",
            lambda r: cell(r, bound, "noc_link_util") > 1.0
            and all(
                cell(r, f"mesh-{a}c-bw{int(bw_lo)}-ch{ch_hi}",
                     "noc_link_util")
                < cell(r, f"mesh-{b}c-bw{int(bw_lo)}-ch{ch_hi}",
                       "noc_link_util")
                for a, b in zip(pods, pods[1:]))
            and cell(r, free, "noc_stall_cycles")
            < 0.1 * cell(r, free, "total_cycles"))
    s.claim("channels_relieve_dram_bound_not_nop_bound",
            lambda r: (cell(r, f"mesh-{small}c-bw{int(bw_hi)}-ch{ch_lo}",
                            "total_cycles")
                       / cell(r, free, "total_cycles")) > 2.0
            and (cell(r, f"mesh-{big}c-bw{int(bw_lo)}-ch{ch_lo}",
                      "total_cycles")
                 / cell(r, bound, "total_cycles")) < 1.2)
    s.claim("torus_beats_mesh_allreduce_at_fixed_budget",
            lambda r: all(
                cell(r, f"torus-{p}c", "allreduce_cycles")
                < cell(r, f"mesh-{p}c-bw{int(bw_lo)}-ch{ch_hi}",
                       "allreduce_cycles")
                for p in pods))
    s.claim("all_cells_batched",
            lambda r: r.fraction_batched == 1.0)
    return s


# --------------------------------------------------------------------------
# CLI: run a named study, print the frame + claims, emit CSV/JSON
# --------------------------------------------------------------------------

def _main(argv: Optional[Sequence[str]] = None) -> int:
    """`python -m repro_torch.api`: the reference's CLI plus `--device`."""
    import argparse
    import inspect
    ap = argparse.ArgumentParser(
        description="Run a named study (repro_torch.api.study registry)")
    ap.add_argument("--study", required=True, choices=list_studies())
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the study where the factory supports it")
    ap.add_argument("--device", default="cuda",
                    help="where the study runs (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--csv", help="write the result frame as CSV")
    ap.add_argument("--json", dest="json_out",
                    help="write the result frame as JSON")
    ap.add_argument("--cache", help="on-disk cell-cache directory")
    ap.add_argument("--search-log", dest="search_log",
                    help="write the SearchLog JSON artifact "
                         "(search studies only)")
    args = ap.parse_args(argv)

    kw = {}
    if args.smoke and "smoke" in inspect.signature(
            _STUDIES[args.study]).parameters:
        kw["smoke"] = True
    study = get_study(args.study, **kw)
    if args.cache:
        study.cache(args.cache)
    res = study.run(device=args.device)
    print(f"study {args.study}: executed {res.executed_cells} cells "
          f"({res.cache_hits} cache hits) on {res.meta['device']}")
    if len(res) <= 200:
        print(res.summary())
    else:
        # a search frame holds thousands of rows; print its accounting
        # instead and leave the rows to --csv/--json
        print(f"{len(res)} rows (row dump suppressed; use --csv/--json)")
        for k, v in sorted(res.meta.items()):
            if k != "search_log":
                print(f"  {k} = {v}")
    claims = res.check_claims()
    for name, ok in claims.items():
        print(f"claim {'PASS' if ok else 'FAIL'}: {name}")
    if args.csv:
        res.to_csv(args.csv)
        print(f"wrote {args.csv}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(res.to_json())
        print(f"wrote {args.json_out}")
    if args.search_log:
        blob = res.meta.get("search_log")
        if blob is None:
            print(f"--search-log: {args.study} is not a search study "
                  f"(no log on its result)")
            return 1
        with open(args.search_log, "w") as f:
            f.write(str(blob))
        print(f"wrote {args.search_log}")
    return 0 if all(claims.values()) else 1
