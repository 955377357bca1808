"""Accelerator configuration dataclasses for the SCALE-Sim v3 simulation plane.

Mirrors the knobs of the paper's config file: systolic array shape, on-chip
double-buffered SRAM sizes, dataflow, multi-core topology (incl. heterogeneous
cores and shared L2), sparsity section, DRAM (Ramulator-like) section, data
layout section and energy (Accelergy-like) section.

Framework-free: this is the PyTorch port's own copy of
`repro.core.accelerator`, field for field, so `AcceleratorConfig.from_dict`
accepts the JAX package's `to_dict()` output unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

Dataflow = str  # 'ws' | 'is' | 'os'
DATAFLOWS = ("ws", "is", "os")


@dataclasses.dataclass(frozen=True)
class CoreConfig:
    """One tensor core: a systolic array + a SIMD/vector unit.

    Follows TPU naming (Sec. III-C): a TensorCore = MXU(s) + vector unit.
    """
    rows: int = 32
    cols: int = 32
    simd_lanes: int = 128           # vector unit width (elements/cycle)
    simd_latency: float = 1.0       # cycles per vector op per lane-batch
    nop_hops: int = 0               # NoP hops to main memory (Sec. III-D)

    def __post_init__(self):
        if self.rows < 1 or self.cols < 1:
            raise ValueError(
                f"array shape must be >= 1x1, got {self.rows}x{self.cols}")
        if self.nop_hops < 0:
            # a negative hop count silently *reduced* multicore cycles in the
            # theta-equalization split; fail loudly like the int32 address
            # guard in trace/contention.py
            raise ValueError(f"nop_hops must be >= 0, got {self.nop_hops}")

    @property
    def num_pes(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Double-buffered on-chip SRAMs (bytes) + shared L2 (Sec. III-B)."""
    ifmap_sram_bytes: int = 1 << 20      # L1 input operand SRAM per core
    filter_sram_bytes: int = 1 << 20     # L1 weight operand SRAM per core
    ofmap_sram_bytes: int = 1 << 20      # L1 output SRAM per core
    l2_sram_bytes: int = 0               # shared L2 (0 = disabled)
    word_bytes: int = 2                  # element size (bf16 default)


@dataclasses.dataclass(frozen=True)
class DramConfig:
    """Main-memory interface (Sec. V). A Ramulator-like timing model.

    Timings are in accelerator cycles (we fold the DRAM/accel clock ratio in).
    Defaults approximate DDR4-2400 per channel seen from a 1 GHz accelerator.
    """
    channels: int = 2
    banks_per_channel: int = 16
    row_bytes: int = 2048                # row-buffer size
    tRCD: int = 14                       # activate -> column
    tRP: int = 14                        # precharge
    tCAS: int = 14                       # column access
    burst_bytes: int = 64                # bytes per burst transaction
    tBURST: int = 4                      # cycles a burst occupies the bus
    read_queue: int = 128                # finite request queues (Sec. V-A2)
    write_queue: int = 128
    bandwidth_bytes_per_cycle: float = 19.2  # peak per channel (2400MT/s*8B/1GHz)

    def __post_init__(self):
        for field in ("channels", "banks_per_channel", "row_bytes",
                      "burst_bytes", "read_queue", "write_queue"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"dram {field} must be >= 1, "
                    f"got {getattr(self, field)}")
        for field in ("tRCD", "tRP", "tCAS", "tBURST"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"dram timing {field} must be a positive cycle "
                    f"count, got {getattr(self, field)}")
        if self.bandwidth_bytes_per_cycle <= 0:
            raise ValueError(
                "dram bandwidth_bytes_per_cycle must be > 0, got "
                f"{self.bandwidth_bytes_per_cycle}")


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Sparsity section (Sec. IV-B). ratio = N:M on the weight operand."""
    enabled: bool = False
    n: int = 2
    m: int = 4
    row_wise: bool = False               # OptimizedMapping knob
    representation: str = "ellpack_block"  # ellpack_block | csr | csc
    seed: int = 0

    def __post_init__(self):
        if self.enabled:
            if not (1 <= self.n <= self.m):
                raise ValueError(f"invalid N:M = {self.n}:{self.m}")
            if self.row_wise and self.n > self.m // 2:
                raise ValueError(
                    f"row-wise sparsity requires N <= M/2, got {self.n}:{self.m}")
            if self.row_wise and self.m > 128:
                # core.sparsity.ROWWISE_HALF_CAP bounds the expected-max
                # j-grid; beyond it the traced model would silently truncate
                raise ValueError(
                    f"row-wise sparsity supports M <= 128, got M={self.m}")


@dataclasses.dataclass(frozen=True)
class LayoutConfig:
    """On-chip data layout section (Sec. VI)."""
    enabled: bool = False
    num_banks: int = 32
    ports_per_bank: int = 1
    line_bytes: int = 64                 # bandwidth_per_bank * word_bytes
    # nested-loop order steps (intra-line), see layout.py
    c1_step: int = 8
    h1_step: int = 2
    w1_step: int = 4


NOC_TOPOLOGIES = ("mesh", "torus", "ring")


@dataclasses.dataclass(frozen=True)
class NocConfig:
    """Routed NoC/NoP interconnect section (repro.noc).

    When enabled, per-core `nop_hops` are *derived* from dimension-ordered
    routes to the memory controller at core (0, 0) instead of taken from the
    config, and a flit/credit link model adds contention stalls on top of the
    zero-load `hops * nop_cycles_per_hop` latency.  `topology` is a static
    kernel flavor (it fixes the routing tree); the link parameters are traced
    data, so a sweep over link bandwidth / buffer depth stays one kernel.
    """
    enabled: bool = False
    topology: str = "mesh"                     # mesh | torus | ring
    link_bandwidth_bytes_per_cycle: float = 32.0
    flit_bytes: int = 32
    buffer_flits: int = 8                      # credit depth per link buffer

    def __post_init__(self):
        if self.topology not in NOC_TOPOLOGIES:
            raise ValueError(
                f"noc topology must be one of {NOC_TOPOLOGIES}, "
                f"got {self.topology!r}")
        # link parameters are validated even when disabled: a config
        # built with flit_bytes=0 must fail loudly at construction, not
        # divide-by-zero later when someone flips `enabled` on a
        # dataclasses.replace()'d copy
        if self.link_bandwidth_bytes_per_cycle <= 0:
            raise ValueError(
                "link_bandwidth_bytes_per_cycle must be > 0, got "
                f"{self.link_bandwidth_bytes_per_cycle}")
        if self.flit_bytes < 1:
            raise ValueError(f"flit_bytes must be >= 1, got {self.flit_bytes}")
        if self.buffer_flits < 1:
            raise ValueError(
                f"buffer_flits must be >= 1, got {self.buffer_flits}")


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """Top-level config = cores + memories + dram + sparsity + layout."""
    cores: Tuple[CoreConfig, ...] = (CoreConfig(),)
    mesh_rows: int = 1                   # core grid: Pr_max
    mesh_cols: int = 1                   # core grid: Pc_max
    dataflow: Dataflow = "ws"
    memory: MemoryConfig = MemoryConfig()
    dram: DramConfig = DramConfig()
    sparsity: SparsityConfig = SparsityConfig()
    layout: LayoutConfig = LayoutConfig()
    noc: NocConfig = NocConfig()
    clock_ghz: float = 1.0
    nop_cycles_per_hop: float = 2.0      # NoP latency per hop per tile transfer

    def __post_init__(self):
        if self.dataflow not in DATAFLOWS:
            raise ValueError(f"dataflow must be one of {DATAFLOWS}")
        if self.nop_cycles_per_hop < 0:
            raise ValueError(
                f"nop_cycles_per_hop must be >= 0, got {self.nop_cycles_per_hop}")
        n = self.mesh_rows * self.mesh_cols
        if len(self.cores) == 1 and n > 1:
            # homogeneous grid: replicate the single prototype core
            object.__setattr__(self, "cores", tuple(self.cores * n))
        if len(self.cores) != n:
            raise ValueError(
                f"need {n} cores for a {self.mesh_rows}x{self.mesh_cols} grid, "
                f"got {len(self.cores)}")

    @property
    def num_cores(self) -> int:
        return self.mesh_rows * self.mesh_cols

    @property
    def homogeneous(self) -> bool:
        return all(c == self.cores[0] for c in self.cores)

    def with_(self, **kw) -> "AcceleratorConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        """Plain nested-dict form (JSON/YAML-safe). Inverse of `from_dict`."""
        d = dataclasses.asdict(self)
        d["cores"] = list(d["cores"])       # tuple -> list for JSON
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "AcceleratorConfig":
        """Build a config from `to_dict` output (or any compatible mapping;
        missing sections fall back to defaults, unknown keys are an error)."""
        d = dict(d)
        sections = dict(memory=MemoryConfig, dram=DramConfig,
                        sparsity=SparsityConfig, layout=LayoutConfig,
                        noc=NocConfig)
        kw: dict = {}
        cores = d.pop("cores", None)
        if cores is not None:
            kw["cores"] = tuple(
                c if isinstance(c, CoreConfig) else CoreConfig(**c)
                for c in cores)
        for name, typ in sections.items():
            if name in d:
                v = d.pop(name)
                kw[name] = v if isinstance(v, typ) else typ(**v)
        kw.update(d)
        return cls(**kw)


def near_square_grid(cores: int) -> Tuple[int, int]:
    """Factor a core count into the most-square (Pr, Pc) mesh."""
    import math
    if cores < 1:
        raise ValueError(f"core count must be >= 1, got {cores}")
    pr = int(math.sqrt(cores))
    while cores % pr:
        pr -= 1
    return pr, cores // pr


def tpu_like_config(array: int = 128, cores: int = 1, dataflow: str = "ws",
                    sram_mb: float = 8.0) -> AcceleratorConfig:
    """A TPU-like single/multi tensor-core configuration (Sec. V-C1)."""
    pr, pc = near_square_grid(cores)
    sram = int(sram_mb * (1 << 20) / 3)
    return AcceleratorConfig(
        cores=(CoreConfig(rows=array, cols=array),),
        mesh_rows=pr, mesh_cols=pc, dataflow=dataflow,
        memory=MemoryConfig(ifmap_sram_bytes=sram, filter_sram_bytes=sram,
                            ofmap_sram_bytes=sram,
                            l2_sram_bytes=4 * sram if cores > 1 else 0),
    )
