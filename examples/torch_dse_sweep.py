"""Design-space exploration on the PyTorch port's Study API (the twin of
`examples/dse_sweep.py`): a designs x workload cross-product run as
batched sweeps on the card, reduced to a columnar frame. `--shard` splits
the study's cells over this host's cards, one thread a card, and puts
the frame together as a farm client does.

    PYTHONPATH=src python examples/torch_dse_sweep.py --arch qwen2-1.5b
    PYTHONPATH=src python examples/torch_dse_sweep.py --device cpu
"""
import argparse
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.api import Study, preset_grid
from repro_torch.configs import get_config
from repro_torch.core.workloads import lm_ops, total_macs


def run_sharded(study: Study, device: str):
    """The study's cells split over this host's cards (the CPU is one
    shard), each shard's cells run through `_execute_cells` on its card,
    the frame assembled from the shards' results."""
    dev = torch.device(device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    plan = study.plan()
    cells = list(range(len(plan.cells)))
    parts = [cells[i::len(devices)] for i in range(len(devices))]
    with ThreadPoolExecutor(len(devices)) as pool:
        futs = [pool.submit(study._execute_cells, plan, part,
                            cache_dir=study._cache_dir, device=d)
                for part, d in zip(parts, devices) if part]
        done = [f.result() for f in futs]
    results = {k: v for r, _, _ in done for k, v in r.items()}
    return study.assemble_frame(
        results, executed_cells=sum(e for _, e, _ in done),
        cache_hits=sum(h for _, _, h in done), plan=plan, device=devices[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--sram-mb", type=float, nargs="+", default=[0.5, 2.0, 8.0])
    ap.add_argument("--fidelity", nargs="+", default=["fast"],
                    help="one or more of fast/trace — extra frame rows per level")
    ap.add_argument("--shard", action="store_true",
                    help="split the study's cells over this host's cards")
    ap.add_argument("--cache", help="on-disk cell cache directory")
    ap.add_argument("--device", default="cuda",
                    help="where the sweeps run (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args()

    ops = [o for o in lm_ops(get_config(args.arch), seq=args.seq, batch=1,
                             mode="prefill") if o.kind == "gemm"]
    print(f"{args.arch}: {len(ops)} GEMMs, "
          f"{total_macs(ops) / 1e12:.2f} TMACs per prefill step")

    study = (Study(f"dse-{args.arch}")
             .designs(preset_grid(array=[8, 16, 32, 64, 128],
                                  sram_mb=args.sram_mb))
             .workloads({args.arch: ops})
             .fidelity(*args.fidelity))
    if args.cache:
        study.cache(args.cache)
    res = (run_sharded(study, args.device) if args.shard
           else study.run(device=args.device))

    print(res.summary())
    for obj in ("latency", "energy", "edp"):
        rows = res.best(obj, by="fidelity")
        for fid, row in rows.items():
            print(f"best {obj} @ {fid}: {row['design']} "
                  f"({row['total_cycles']:.3e} cyc, "
                  f"{row['energy_pj'] * 1e-9:.2f} mJ)")
    print("pareto front:",
          [r["design"] for r in res.pareto("total_cycles", "energy_pj").rows()])


if __name__ == "__main__":
    main()
