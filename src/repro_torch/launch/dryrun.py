"""Multi-pod dry run: what one step of every (arch x shape x mesh) cell
costs each device of a production mesh, with nothing allocated (the
reference's `repro/launch/dryrun.py`, which lowers and compiles each cell
for 512 placeholder host devices and reads XLA's analyses).

Per cell:
  the cell's step (`ModelBundle.train_step`, `prefill_step` or
  `decode_step` with the mesh context) run once on a dry mesh: rank 0 of
  the unbound 16 x 16 or 2 x 16 x 16 mesh (`backend="dry"`), every input
  a meta tensor of rank 0's block (`param_shardings`, `opt_shardings`,
  `batch_shardings`, `cache_shardings`), every collective an empty meta
  tensor of its result (`dist/collectives.py`)
  -> `OpCounter` (`launch/opcost.py`): FLOPs, HBM bytes on the
     perfect-fusion model, live bytes and their peak, collective traffic
     per chip (ring factors per group size), all per device
  -> roofline terms for an NVIDIA H100 SXM (989 TFLOP/s dense bf16,
     3.35 TB/s HBM, 450 GB/s NVLink 4 per direction: one rate, as the
     reference takes one ICI rate; a group that spans more than one
     8-GPU node would see its network's rate instead)
  -> JSON in experiments/dryrun_torch/.

The reference's JSON keys where the quantity is the same;
`hlo_flops_per_device` and `hlo_bytes_per_device` become
`op_flops_per_device` and `op_bytes_per_device`, `lower_s` and
`compile_s` become `host_s` (the dry step's host seconds), and
`xla_flops_once` / `xla_bytes_once` (XLA's counts of a loop body once)
have no counterpart: eager dispatch runs every iteration.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --jobs 2    # child processes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

import torch

PEAK_FLOPS = 989e12          # dense bf16 per card (H100 SXM data sheet)
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per direction, NVLink 4
# torch.cuda.get_device_properties(0).total_memory of an
# "NVIDIA H100 80GB HBM3" at a 700 W power limit
HBM_BYTES = 85_017_493_504

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def model_flops(cfg, *, seq: int, batch: int, mode: str) -> float:
    n = cfg.active_param_count()
    if mode == "train":
        return 6.0 * n * seq * batch
    if mode == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch           # decode: one token per sequence


def dry_mesh(sizes, axis_names):
    """Rank 0 of a mesh of `sizes` over `axis_names` with no processes
    behind it: its collectives return meta tensors."""
    from ..dist.collectives import DRY
    from ..dist.sharding import Mesh
    return Mesh(tuple(sizes), tuple(axis_names), rank=0, backend=DRY)


def production_dry_mesh(mesh_kind: str):
    from .mesh import make_production_mesh
    m = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    return dry_mesh(tuple(m.shape.values()), m.axis_names)


def _meta_tree(defs, specs, mesh):
    from ..models import params as pm
    from ..models.zoo import local_shape
    return pm.tree_map(lambda d, sp: torch.empty(
        local_shape(d.shape, sp, mesh), dtype=pm.torch_dtype(d.dtype),
        device="meta"), defs, specs)


def _tensors(obj) -> list:
    """The tensors of a step's inputs or outputs (dicts, sequences, named
    tuples); a model stands for its parameter tree."""
    from ..models.transformer import LanguageModel
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, LanguageModel):
        return _tensors(obj.tree)
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _local_rows(t: torch.Tensor, ctx) -> int:
    """The bytes of this process's rows of a global batch input."""
    from ..models.spmd import batch_sharded
    n = t.numel() * t.element_size()
    return n // ctx.dp if batch_sharded(ctx, t.shape[0]) else n


def dry_step(bundle, ctx, *, seq: int, batch: int, mode: str,
             serve_params: bool = False, accum: int = 1):
    """(step, its arguments, the global batch inputs): the cell's step on
    `ctx` and meta inputs of rank 0's blocks (the batch inputs global:
    the steps take the global batch and keep their rows)."""
    from ..models.transformer import LanguageModel
    cfg = bundle.cfg
    serve = serve_params and mode != "train"
    specs = bundle.param_specs(ctx, serve=serve)
    model = LanguageModel(cfg, _meta_tree(bundle.param_defs(ctx, serve=serve),
                                          specs, ctx.mesh),
                          specs=specs, mesh=ctx.mesh)
    if mode == "train":
        data = bundle.batch_specs(seq=seq, batch=batch, mode="train")
        opt = bundle.opt_init(model)
        return (bundle.train_step(ctx, accum=accum), (model, opt, data),
                data)
    if mode == "prefill":
        data = bundle.batch_specs(seq=seq, batch=batch, mode="prefill")
        return bundle.prefill_step(ctx), (model, data), data
    cache = bundle.init_cache(batch=batch, cache_len=seq, device="meta",
                              ctx=ctx)
    token = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    # the new token's position: the cache's last one
    return (bundle.decode_step(ctx), (model, cache, token, seq - 1),
            {"token": token})


def count_step(step, args, ctx, batch_inputs=None, *, mesh=None,
               also_held=()):
    """Run `step(*args)` once under an `OpCounter` and return its totals
    with the memory fields: the arguments (each input's storage, the
    batch inputs at this process's rows, and the tensors of `also_held`),
    the peak live bytes, temp = peak - arguments, and the outputs that
    share no storage with an input. `mesh`: the mesh whose collectives
    are counted."""
    from .opcost import OpCounter
    counter = OpCounter(mesh)
    batch_ids = {id(t) for t in (batch_inputs or {}).values()}
    for t in _tensors(args) + list(also_held):
        if id(t) in batch_ids and ctx is not None:
            counter.hold(t, size=_local_rows(t, ctx))
        else:
            counter.hold(t)
    args_bytes = counter.held
    t0 = time.perf_counter()
    with counter:
        out = step(*args)
    host_s = time.perf_counter() - t0
    seen, out_bytes = set(), 0
    for t in _tensors(out):
        key = t.untyped_storage()._cdata
        if key not in seen and not counter.is_held(t):
            out_bytes += t.untyped_storage().nbytes()
        seen.add(key)
    tot = counter.totals()
    tot.update(arg_bytes=args_bytes, out_bytes=out_bytes, host_s=host_s,
               temp_bytes=tot["peak_bytes"] - args_bytes)
    return tot


def count_cell(cfg, mesh, *, seq: int, batch: int, mode: str,
               serve_params: bool = False, accum: int = 1) -> dict:
    """`count_step` of the cell's step on a dry mesh, inputs on meta."""
    from ..dist.collectives import DRY
    from ..dist.sharding import make_mesh_ctx
    from ..models.zoo import ModelBundle
    if mesh.backend != DRY:
        raise ValueError("the dry run takes a dry mesh (dryrun.dry_mesh)")
    ctx = make_mesh_ctx(mesh)
    bundle = ModelBundle(cfg)
    step, args, data = dry_step(bundle, ctx, seq=seq, batch=batch, mode=mode,
                                serve_params=serve_params, accum=accum)
    off = [t.device for t in _tensors(args) if t.device.type != "meta"]
    if off:
        raise ValueError(f"a dry step takes meta inputs only, not {off[0]}")
    # a decode step's position is a Python int here and a device int32 in
    # the reference's step: counted among the arguments as those 4 bytes
    pos = ((torch.empty((), dtype=torch.int32, device="meta"),)
           if mode == "decode" else ())
    return count_step(step, args, ctx, data, mesh=mesh, also_held=pos)


def roofline(c: dict):
    """(terms, the dominant one, the bound) of `count_step`'s totals on
    one H100: compute, memory and collective seconds per device."""
    terms = dict(
        compute_s=c["flops"] / PEAK_FLOPS,
        memory_s=c["hbm_bytes"] / HBM_BW,
        collective_s=c["collective_bytes"] / LINK_BW,
    )
    dominant = max(terms, key=terms.get)
    return terms, dominant, terms[dominant]


def run_cell(arch: str, shape: str, mesh_kind: str,
             sp_mode: str = "megatron", serve_params: bool = False,
             accum: int = 1, sim_accel: str = "", device=None) -> Dict:
    from ..configs import get_config
    from ..configs.shapes import SHAPES, skip_reason

    cfg = dataclasses.replace(get_config(arch), sp_mode=sp_mode)
    reason = skip_reason(cfg, shape)
    if reason:
        return dict(arch=arch, shape=shape, mesh=mesh_kind, skipped=reason)
    spec = SHAPES[shape]
    seq, batch, mode = spec["seq"], spec["batch"], spec["mode"]
    mesh = production_dry_mesh(mesh_kind)
    chips = mesh.size
    c = count_cell(cfg, mesh, seq=seq, batch=batch, mode=mode,
                   serve_params=serve_params, accum=accum)
    flops_dev = c["flops"]
    bytes_dev = c["hbm_bytes"]
    per_chip_coll = c["collective_bytes"]
    mf = model_flops(cfg, seq=seq, batch=batch, mode=mode)
    terms, dominant, bound = roofline(c)
    result = dict(
        arch=arch, shape=shape, mesh=mesh_kind, chips=chips, mode=mode,
        sp_mode=sp_mode, serve_params=serve_params, accum=accum,
        seq=seq, batch=batch, host_s=round(c["host_s"], 3),
        peak_bytes_per_device=int(c["peak_bytes"]),
        arg_bytes_per_device=int(c["arg_bytes"]),
        temp_bytes_per_device=int(c["temp_bytes"]),
        out_bytes_per_device=int(c["out_bytes"]),
        fits_hbm=bool(c["arg_bytes"] + c["temp_bytes"] < HBM_BYTES),
        op_flops_per_device=flops_dev,
        op_bytes_per_device=bytes_dev,
        collective_bytes_per_chip=per_chip_coll,
        collectives=c["collectives"][:8],
        model_flops=mf,
        useful_flops_ratio=mf / max(flops_dev * chips, 1.0),
        terms=terms, dominant=dominant,
        roofline_bound_s=bound,
        mfu_vs_roofline=terms["compute_s"] / max(bound, 1e-12),
        ok=True,
    )
    if sim_accel:
        # the simulation plane's view of the same cell beside the roofline
        from ..api import Simulator
        sim = Simulator(sim_accel, device=device)
        rep = sim.run_lm(cfg, seq=seq, batch=batch, mode=mode)
        result["sim_accel"] = dict(
            preset=sim_accel,
            device=str(sim.device),
            total_cycles=rep.total_cycles,
            stall_cycles=rep.stall_cycles,
            energy_pj=rep.energy_pj,
            utilization=rep.utilization,
            modeled_s=sim.seconds(rep.total_cycles))
    return result


def cell_list() -> List[Tuple[str, str, str]]:
    from ..configs import get_config, list_archs
    from ..configs.shapes import SHAPES, skip_reason
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES:
            if skip_reason(cfg, shape):
                continue
            for mesh in ("pod", "multipod"):
                cells.append((arch, shape, mesh))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--missing-only", action="store_true")
    ap.add_argument("--sp-mode", default="megatron",
                    choices=["megatron", "weightgather"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--serve-params", action="store_true",
                    help="decode/prefill: TP-resident weights (no FSDP gather)")
    ap.add_argument("--accum", type=int, default=1,
                    help="train: gradient-accumulation microbatches")
    ap.add_argument("--sim-accel", default="",
                    help="accelerator preset (repro_torch.api): attach the "
                         "simulation plane's cost model to each cell")
    ap.add_argument("--device", default="cuda",
                    help="where --sim-accel's simulation runs (default cuda; "
                         "cpu runs the plain versions)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        cells = cell_list()
        if args.missing_only:
            cells = [(a, s, m) for a, s, m in cells if not os.path.exists(
                os.path.join(args.out, f"{a}__{s}__{m}.json"))]
        procs: List = []
        t0 = time.perf_counter()
        for a, s, m in cells:
            while len(procs) >= args.jobs:
                for p in list(procs):
                    if p.poll() is not None:
                        procs.remove(p)
                time.sleep(0.2)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", m, "--out", args.out]
            if args.sim_accel:
                cmd += ["--sim-accel", args.sim_accel, "--device",
                        args.device]
            print("launch:", a, s, m, flush=True)
            procs.append(subprocess.Popen(cmd))
        for p in procs:
            p.wait()
        print(f"all: {len(cells)} cells in {time.perf_counter() - t0:.1f} s "
              f"with {args.jobs} jobs -> {args.out}", flush=True)
        return

    res = run_cell(args.arch, args.shape, args.mesh, sp_mode=args.sp_mode,
                   serve_params=args.serve_params, accum=args.accum,
                   sim_accel=args.sim_accel, device=args.device)
    tag = f"__{args.tag}" if args.tag else ""
    path = os.path.join(args.out,
                        f"{args.arch}__{args.shape}__{args.mesh}{tag}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1, default=float)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("collectives",)}, indent=1, default=float))


if __name__ == "__main__":
    main()
