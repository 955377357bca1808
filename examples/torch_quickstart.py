"""Quickstart on the PyTorch port: simulate one GEMM and one full network
on modeled silicon through the unified `Simulator` facade (the twin of
`examples/quickstart.py`).

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.api import Simulator
from repro_torch.core.accelerator import SparsityConfig
from repro_torch.core.workloads import Op


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the simulation runs (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args()

    # 1. one GEMM on a 32x32 weight-stationary array (the "paper-32" preset)
    sim = Simulator("paper-32", device=args.device)
    r = sim.run_op(Op("gemm", 512, 4096, 1024))
    print("GEMM 512x4096x1024 on 32x32 WS "
          f"(stages: {' -> '.join(sim.stage_names())}):")
    print(f"  compute={r.compute_cycles:.3e} cyc  "
          f"stalls={r.stall_cycles:.3e}  "
          f"util={r.utilization:.2f}  "
          f"dram={r.dram_bytes/1e6:.1f} MB")

    # 2. the same GEMM with 2:4 weight sparsity (swap one stage input,
    #    same pipeline)
    sp = sim.with_(sparsity=SparsityConfig(enabled=True, n=2, m=4))
    r = sp.run_op(Op("gemm24", 512, 4096, 1024))
    print(f"  with 2:4 sparsity: compute={r.compute_cycles:.3e} cyc, "
          f"filter storage {r.sparse_storage['original_bytes']/1e6:.2f} -> "
          f"{r.sparse_storage['total_bytes']/1e6:.2f} MB")

    # 3. a whole network with energy/EdP + per-action breakdown
    rep = sim.run("resnet18")
    print("\nResNet-18 end-to-end on 32x32 WS:")
    print(f"  cycles={rep.total_cycles:.3e} (stalls {rep.stall_cycles:.2e})")
    print(f"  energy={rep.energy_pj*1e-9:.2f} mJ  "
          f"power={rep.avg_power_w:.2f} W  EdP={rep.edp:.3e}")
    top = sorted(rep.energy_breakdown.items(), key=lambda kv: -kv[1])[:3]
    print("  top energy actions: "
          + ", ".join(f"{k}={v*1e-9:.2f}mJ" for k, v in top))

    # 4. cycle-accurate DRAM fidelity: same facade, different pipeline
    cyc = Simulator("paper-32", fidelity="cycle", device=args.device)
    r = cyc.run_op(Op("conv1", 64, 112 * 112, 147))
    print(f"\ncycle-fidelity DRAM: stalls={r.stall_cycles:.3e}, "
          f"row hits={r.dram_stats['row_hits']}")

    # 5. per-layer CSV (now includes the grouped energy breakdown)
    csv = os.path.join(tempfile.gettempdir(), "quickstart_report.csv")
    rep.write_csv(csv)
    print(f"\nper-layer report -> {csv}")


if __name__ == "__main__":
    main()
