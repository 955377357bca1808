"""Accelerator preset registry: the one way to construct configs.

The PyTorch port's copy of `repro.api.presets` (framework-free): the same
presets under the same names, so a preset's `to_dict()` is equal across
the two packages. `Study.designs` accepts these names.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Union

from ..core.accelerator import (AcceleratorConfig, CoreConfig, MemoryConfig,
                                NocConfig, SparsityConfig, near_square_grid,
                                tpu_like_config)

_PRESETS: Dict[str, Callable[..., AcceleratorConfig]] = {}


def register_preset(name: str):
    """Decorator: register a config factory under `name`. Factories may
    take keyword arguments (forwarded from `get_preset`)."""
    def deco(fn: Callable[..., AcceleratorConfig]):
        if name in _PRESETS:
            raise ValueError(f"preset {name!r} already registered")
        _PRESETS[name] = fn
        return fn
    return deco


def get_preset(name: str, **kw) -> AcceleratorConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; "
                       f"available: {sorted(_PRESETS)}")
    return _PRESETS[name](**kw)


def list_presets() -> List[str]:
    return sorted(_PRESETS)


SparsityLike = Union[None, str, tuple, SparsityConfig]


def as_sparsity(v: SparsityLike) -> SparsityConfig:
    """Sparsity-axis value -> SparsityConfig.

    Accepted forms: None or 'dense' (disabled), 'N:M' (layer-wise),
    'N:M-rw' (row-wise), an (n, m) tuple (layer-wise), an
    (n, m, 'rw') tuple, or a SparsityConfig passed through.
    """
    if v is None or v == "dense":
        return SparsityConfig()
    if isinstance(v, SparsityConfig):
        return v
    if isinstance(v, str):
        row_wise = v.endswith("-rw")
        body = v[:-3] if row_wise else v
        try:
            n, m = (int(x) for x in body.split(":"))
        except ValueError:
            raise ValueError(
                f"cannot parse sparsity {v!r}; expected 'dense', 'N:M' or "
                f"'N:M-rw'") from None
        return SparsityConfig(enabled=True, n=n, m=m, row_wise=row_wise)
    if isinstance(v, tuple):
        if len(v) == 2:
            return SparsityConfig(enabled=True, n=v[0], m=v[1])
        if len(v) == 3 and v[2] == "rw":
            return SparsityConfig(enabled=True, n=v[0], m=v[1],
                                  row_wise=True)
    raise TypeError(f"cannot build SparsityConfig from {v!r}")


def with_cores(cfg: AcceleratorConfig, cores: int) -> AcceleratorConfig:
    """Re-mesh a config onto `cores` cores (near-square grid, the
    prototype core replicated) — the `cores=` axis of `preset_grid`."""
    pr, pc = near_square_grid(cores)
    return cfg.with_(cores=(cfg.cores[0],), mesh_rows=pr, mesh_cols=pc)


def with_pod(cfg: AcceleratorConfig, cores: int,
             topology: str = "mesh") -> AcceleratorConfig:
    """Re-mesh a config onto a `cores`-core pod with the routed NoC plane
    enabled (`repro.noc`) — the `pods=` axis of `preset_grid`. Keeps the
    config's NoC link parameters if the plane is already enabled, else
    enables it with defaults on `topology`."""
    import dataclasses
    noc = (dataclasses.replace(cfg.noc, topology=topology)
           if cfg.noc.enabled
           else NocConfig(enabled=True, topology=topology))
    return with_cores(cfg, cores).with_(noc=noc)


def preset_grid(name: str = "tpu-like", *, preset=None, dataflow=None,
                sparsity=None, cores=None, pods=None,
                **axes) -> List[AcceleratorConfig]:
    """Cartesian product of preset kwargs -> list of configs for
    `Study.designs` / `Simulator.sweep`, e.g.
    `preset_grid(array=[8, 16], sram_mb=[1, 8])`.

    Five first-class axes beyond factory kwargs, so study grids span
    presets, core counts, sparsity regimes and dataflows without manual
    list building:

    - `preset=[...]` crosses preset *names* (outermost axis), replacing
      the single `name`;
    - `cores=[...]` re-meshes the built config onto each core count via
      `with_cores` (near-square grid of the prototype core);
    - `pods=[...]` re-meshes onto each core count like `cores` but with
      the routed NoC plane enabled (`with_pod`; mesh by default) —
      pod-scale interconnect sweeps (256/1024/4096 cores);
    - `sparsity=[...]` applies each `as_sparsity` value ('dense',
      '2:4', '1:4-rw', (n, m) tuples, SparsityConfig) via `with_`;
    - `dataflow=[...]` (innermost axis) is applied to the built config
      via `with_(dataflow=...)`, so it works for every preset whether or
      not its factory takes a dataflow kwarg.
    """
    if cores is not None and pods is not None:
        raise ValueError("pass either cores= or pods=, not both")
    presets = list(preset) if preset is not None else [name]
    dataflows = list(dataflow) if dataflow is not None else [None]
    sparsities = list(sparsity) if sparsity is not None else [None]
    core_counts = list(cores) if cores is not None else [None]
    remesh = with_cores
    if pods is not None:
        core_counts = list(pods)
        remesh = with_pod
    keys = list(axes)
    out = []
    for pname in presets:
        for combo in itertools.product(*(axes[k] for k in keys)):
            cfg0 = get_preset(pname, **dict(zip(keys, combo)))
            for nc in core_counts:
                cfg1 = cfg0 if nc is None else remesh(cfg0, nc)
                for sp in sparsities:
                    cfg2 = (cfg1 if sp is None
                            else cfg1.with_(sparsity=as_sparsity(sp)))
                    for df in dataflows:
                        out.append(cfg2 if df is None
                                   else cfg2.with_(dataflow=df))
    return out


# --- built-ins --------------------------------------------------------------

register_preset("tpu-like")(tpu_like_config)


@register_preset("paper-32")
def _paper_32(**kw) -> AcceleratorConfig:
    """The paper's default single-core 32x32 WS array."""
    return tpu_like_config(array=32, **kw)


@register_preset("paper-64")
def _paper_64(**kw) -> AcceleratorConfig:
    return tpu_like_config(array=64, **kw)


@register_preset("paper-128")
def _paper_128(**kw) -> AcceleratorConfig:
    """TPU-class 128x128 MXU (Table V's big design point)."""
    return tpu_like_config(array=128, **kw)


@register_preset("multicore-16x32")
def _multicore(**kw) -> AcceleratorConfig:
    """Table VI iso-compute partner: 16 cores of 32x32."""
    kw.setdefault("array", 32)
    kw.setdefault("cores", 16)
    return tpu_like_config(**kw)


@register_preset("mcm-4x32")
def _mcm(channels: int = 4, dataflow: str = "ws") -> AcceleratorConfig:
    """MCM-style package for the shared-DRAM contention study: four 32x32
    cores at increasing NoP hop distance from main memory, sharing
    `channels` DRAM channels (channels == cores supports the
    private-channel routing mode of `simulate_multicore_contention`)."""
    from ..core.accelerator import DramConfig
    sram = 128 * 1024
    return AcceleratorConfig(
        cores=tuple(CoreConfig(rows=32, cols=32, nop_hops=h)
                    for h in (0, 1, 1, 2)),
        mesh_rows=2, mesh_cols=2, dataflow=dataflow,
        memory=MemoryConfig(ifmap_sram_bytes=sram, filter_sram_bytes=sram,
                            ofmap_sram_bytes=sram),
        dram=DramConfig(channels=channels))


@register_preset("pod-mesh")
def _pod_mesh(cores: int = 256, topology: str = "mesh", array: int = 32,
              link_bw: float = 32.0, flit_bytes: int = 32,
              buffer_flits: int = 8, channels: int = 8,
              dataflow: str = "ws") -> AcceleratorConfig:
    """Pod-scale package (256/1024/4096 cores) with the routed NoC plane
    enabled: `array`x`array` cores on a near-square `topology` grid, all
    DRAM traffic routed over flit/credit links to the memory controller
    at core (0, 0). `link_bw` is bytes/cycle per link; sweep it (and
    `channels`) to locate the NoP-bound regime (studies.nop_bound)."""
    from ..core.accelerator import DramConfig
    cfg = tpu_like_config(array=array, cores=cores, dataflow=dataflow)
    return cfg.with_(
        noc=NocConfig(enabled=True, topology=topology,
                      link_bandwidth_bytes_per_cycle=link_bw,
                      flit_bytes=flit_bytes, buffer_flits=buffer_flits),
        dram=DramConfig(channels=channels))


@register_preset("ws-64-sparse-2:4")
def _ws64_sparse(n: int = 2, m: int = 4,
                 row_wise: bool = False) -> AcceleratorConfig:
    """Paper Sec. IV SpMM reference design: a 64x64 weight-stationary
    array streaming 2:4 layer-wise compressed weights (the Ampere-class
    ratio); `n`/`m`/`row_wise` kwargs open the full N:M family."""
    return tpu_like_config(array=64, dataflow="ws").with_(
        sparsity=SparsityConfig(enabled=True, n=n, m=m, row_wise=row_wise))


@register_preset("table-v-corner")
def _table_v_corner(array: int = 64, sram_kb: int = 8192,
                    dataflow: str = "ws", channels: int = 2,
                    bandwidth: float = 19.2,
                    layout_banks: int = 0) -> AcceleratorConfig:
    """One cell of the Table-V design-space search (`repro.search`,
    studies.search_edp): a single-core `array`x`array` systolic core with
    `sram_kb` KiB of operand SRAM split evenly across the three operand
    buffers, DRAM capped at paper-class provisioning (`channels` channels
    of `bandwidth` bytes/cycle), optionally the data-layout stage on
    `layout_banks` banks. Defaults are the paper's EdP winner; the
    search space's axes perturb exactly these kwargs."""
    from ..core.accelerator import DramConfig, LayoutConfig
    sram = int(sram_kb) * 1024 // 3
    cfg = AcceleratorConfig(
        cores=(CoreConfig(rows=array, cols=array),),
        dataflow=dataflow,
        memory=MemoryConfig(ifmap_sram_bytes=sram, filter_sram_bytes=sram,
                            ofmap_sram_bytes=sram),
        dram=DramConfig(channels=channels,
                        bandwidth_bytes_per_cycle=bandwidth))
    if layout_banks:
        cfg = cfg.with_(layout=LayoutConfig(enabled=True,
                                            num_banks=layout_banks))
    return cfg


@register_preset("edge-8")
def _edge(dataflow: str = "ws") -> AcceleratorConfig:
    """A small edge-class design: 8x8 array, 192 KiB of operand SRAM."""
    sram = 64 * 1024
    return AcceleratorConfig(
        cores=(CoreConfig(rows=8, cols=8, simd_lanes=32),),
        dataflow=dataflow,
        memory=MemoryConfig(ifmap_sram_bytes=sram, filter_sram_bytes=sram,
                            ofmap_sram_bytes=sram))
