"""Declarative Study API (PyTorch port of the core of `repro.api.study`):
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

`Study.run` groups the cells by the static sweep flavor (workload,
fidelity, dataflow, word size, the DramConfig at trace fidelity, the core
grid, the layout config when the layout stage is on, the sparse
representation and the NoC topology of a NoC pod) and runs each group as
one batched `_sweep_batched` call;
at trace fidelity that is one replay-kernel launch per group, and with
the layout stage on one bank-conflict-kernel launch per group. The
paper's analyses ship as named studies with machine-checkable claims
(`studies.edp_array_size`, `studies.dataflow_dram_flip`,
`studies.sparse_speedup`, `studies.nop_bound`).

Custom evaluators (`Study.evaluator`) run one cell at a time, outside the
batched groups; the named study `multicore_contention` is one.

Not in this slice: the on-disk cell cache, `force_fallback`, the farm
wire format (`to_spec`), `concat`/`topk` and the CLI.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import stages as st
from ..core.accelerator import AcceleratorConfig, DramConfig
from ..core.energy import DEFAULT_ERT, ERT, edp as _edp
from ..core.engine import (ENERGY_GROUP_COLUMNS, RESULT_SCHEMA_VERSION,
                           write_csv_table)
from ..core.workloads import Op
from ..noc.topology import noc_kind
from .simulator import _sweep_batched, as_config, as_workload

AXIS_COLUMNS = ("design", "workload", "fidelity")

# Canonical metric columns, grouped-energy columns included.
METRIC_COLUMNS = ("total_cycles", "compute_cycles", "stall_cycles",
                  "dram_bytes", "energy_pj", "utilization",
                  "edp") + ENERGY_GROUP_COLUMNS

_METRIC_ALIASES = {"latency": "total_cycles", "cycles": "total_cycles",
                   "energy": "energy_pj"}


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


def resolve_device(device=None) -> torch.device:
    """The device a study runs on: CUDA unless the caller asks for the CPU.
    Never falls back quietly: without a CUDA device, `None` raises."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this study runs on the GPU by "
            "default. Pass device='cpu' to run the plain PyTorch version "
            "on the CPU.")
    return device


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
    groups: List[BatchGroup]
    per_cell: List[int] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.cells)


# --------------------------------------------------------------------------
# Columnar result frame
# --------------------------------------------------------------------------

class StudyResult:
    """Pandas-free columnar frame: numpy columns + axis metadata.

    Axis columns (`design`, `workload`, `fidelity`) are object arrays of
    labels; metric columns are float64; `batched` is 1.0 for a cell of
    the batched sweep and 0.0 for an evaluator's cell; `cell_status` is
    1.0 for failed cells (an evaluator that raised, or non-finite
    canonical metrics), which `argbest`/`pareto` never pick.
    `meta["engine"]` names the replay engine that ran ("cuda",
    "torch:plain" or "reference") when a fidelity replayed DRAM streams.
    """

    schema_version = RESULT_SCHEMA_VERSION

    def __init__(self, columns: Dict[str, np.ndarray],
                 axes: Dict[str, List[str]], *,
                 claims: Optional[List[Tuple[str, Callable]]] = None):
        self.columns = columns
        self.axes = axes
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
        if "cell_status" not in self.columns:
            return []
        return [int(i) for i in
                np.nonzero(self.columns["cell_status"] == 1.0)[0]]

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


# --------------------------------------------------------------------------
# The Study builder
# --------------------------------------------------------------------------

class Study:
    """Declarative cross-product experiment plan (builder pattern)."""

    def __init__(self, name: str = "study"):
        self.name = name
        self._designs: List[Tuple[str, AcceleratorConfig]] = []
        self._workloads: Dict[str, List[Op]] = {}
        self._fidelities: Tuple[str, ...] = ("fast",)
        self._ert: ERT = DEFAULT_ERT
        self._engine: Optional[str] = None
        self._spec = None
        self._core_index: int = 0
        self._evaluator: Optional[Callable] = None
        self._claims: List[Tuple[str, Callable]] = []

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
    def options(self, *, ert: Optional[ERT] = None,
                engine: Optional[str] = None, trace_spec=None,
                core_index: Optional[int] = None,
                force_fallback: Optional[bool] = None) -> "Study":
        """Execution knobs shared by every cell, with the reference's
        keywords: the energy table, the replay engine
        (`core.replay.ENGINES`), the trace spec and the core a
        heterogeneous mesh is analysed through. `force_fallback=True`
        needs the per-op engine and is refused."""
        from ..core import replay as _rp
        if force_fallback:
            raise NotImplementedError(
                "force_fallback runs every cell through the per-op engine, "
                "which comes with module item 8 of the PyTorch port "
                "(ROADMAP.md)")
        if ert is not None:
            self._ert = ert
        if engine is not None:
            self._engine = _rp.resolve_engine(engine)
        if trace_spec is not None:
            self._spec = trace_spec
        if core_index is not None:
            self._core_index = int(core_index)
        return self

    def evaluator(self, fn: Callable) -> "Study":
        """Custom per-cell evaluator replacing the batched sweep (e.g. the
        multi-core contention study). The port calls it as
        `fn(config, ops, fidelity, device=device)`: the reference's
        `(config, ops, fidelity)` plus the device the study runs on, which
        the port makes explicit. Its cells run one at a time
        (`batched = 0.0`); a cell whose evaluator raises anything but
        `ValueError` becomes a failed cell (`cell_status = 1.0`), while a
        `ValueError` (an invalid configuration) propagates. The reference's
        content-hash cell cache is not ported (module item 8)."""
        self._evaluator = fn
        return self

    def claim(self, name: str, fn: Callable[[StudyResult], bool]) -> "Study":
        """Attach a machine-checkable paper claim, evaluated on the frame
        via `StudyResult.check_claims()`."""
        self._claims.append((name, fn))
        return self

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
        fastest. With an evaluator every cell runs on its own (`per_cell`)
        and no group is formed. Every design of the batched sweep, NoC
        pods included, runs in a group; only `cycle` fidelity without an
        evaluator is refused (NotImplementedError)."""
        if not self._designs:
            raise ValueError("Study has no designs; call .designs(...)")
        if not self._workloads:
            raise ValueError("Study has no workloads; call .workloads(...)")
        if "cycle" in self._fidelities and self._evaluator is None:
            raise NotImplementedError(
                "'cycle' fidelity runs through the per-op engine, which "
                "comes with module item 8 of the PyTorch port (ROADMAP.md)")
        cells: List[StudyCell] = []
        for fid in self._fidelities:
            for wname in self._workloads:
                for label, cfg in self._designs:
                    cells.append(StudyCell(len(cells), label, wname, fid,
                                           cfg))
        if self._evaluator is not None:
            return StudyPlan(cells=cells, groups=[],
                             per_cell=[c.index for c in cells])
        by_key: Dict[tuple, List[int]] = {}
        for c in cells:
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
        return StudyPlan(cells=cells, groups=groups)

    def run(self, *, device=None) -> StudyResult:
        """Execute the plan on `device` (CUDA by default; pass "cpu" for
        the plain PyTorch version) and return the columnar frame."""
        from ..core import replay as _rp
        device = resolve_device(device)
        plan = self.plan()
        results: Dict[int, Dict[str, float]] = {}
        for grp in plan.groups:
            vals = _sweep_batched(
                [plan.cells[i].config for i in grp.cells],
                self._workloads[grp.workload], grp.dataflow, grp.word_bytes,
                self._ert, dram=grp.dram, spec=self._spec_for(grp.fidelity),
                engine=self._engine, device=device,
                core_index=self._core_index)
            vals["edp"] = _edp(vals["energy_pj"], vals["total_cycles"])
            for j, i in enumerate(grp.cells):
                results[i] = {k: float(v[j]) for k, v in vals.items()}
                results[i]["batched"] = 1.0
                _flag_non_finite(results[i])
        for i in plan.per_cell:
            cell = plan.cells[i]
            try:
                m = {k: float(v) for k, v in self._evaluator(
                    cell.config, self._workloads[cell.workload],
                    cell.fidelity, device=device).items()}
            except ValueError:
                raise    # invalid configuration: loud, never a failed cell
            except Exception:  # noqa: BLE001 -- one bad cell, study lives
                m = {"cell_status": 1.0}
            m["batched"] = 0.0
            results[i] = m
            _flag_non_finite(results[i])
        res = self._frame(plan.cells, [results[i]
                                       for i in range(len(plan.cells))])
        if any(f in ("trace", "cycle") for f in self._fidelities):
            res.meta["engine"] = _rp.resolve_engine_runtime(self._engine,
                                                            device)
        res.meta["device"] = str(device)
        return res

    def _frame(self, cells: Sequence[StudyCell],
               results: List[Dict[str, float]]) -> StudyResult:
        metric_names = [m for m in METRIC_COLUMNS
                        if any(m in r for r in results)]
        # an evaluator's own metrics follow the canonical ones, sorted
        metric_names += sorted({k for r in results for k in r}
                               - set(metric_names)
                               - {"batched", "cell_status"})
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
        return StudyResult(cols, axes, claims=self._claims)


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
    return _STUDIES[name](**kw)


def list_studies() -> List[str]:
    return sorted(_STUDIES)


class _StudyNamespace:
    """`studies.edp_array_size(...)` attribute access over the registry."""

    def __getattr__(self, name: str) -> Callable[..., Study]:
        if name in _STUDIES:
            return _STUDIES[name]
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
