"""Time the replay kernel's single-core instance beside another build of
the same kernel on one card, in turns, in one process.

    git show <commit>:src/repro_torch/csrc/replay_megakernel.cu > build/a.cu
    python3 tools/replay_ab.py build/a.cu

The other source's C entry point takes the arguments of this one's
except `grouped` (the single-core entry point before the multi-core mode
came). Both run the vit_base trace group of
the dense sweep (the ws designs of `preset_grid(array=[16, 32, 64, 128],
sram_mb=[0.25, 0.5, 1, 2, 4, 8])`, 1,776 streams of 4,096 requests,
chunk 64): first each output is held equal to the other's, bit for bit,
then each is timed twice by CUDA events around a host loop of 20
launches and by CUDA-graph replays (`chip_smoke.py`'s `timed_cuda` and
`timed_graph`), the other source's launches direct through ctypes and
this one's direct (no id check), through its wrapper, and in its
multi-core form at one core. Prints the card's name and power limit and
one JSON line of milliseconds.
"""
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(other: str) -> int:
    if not torch.cuda.is_available():
        print("replay_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import timed_cuda, timed_graph
    from repro_torch.api import simulator as sim
    from repro_torch.api.presets import preset_grid
    from repro_torch.core.accelerator import DramConfig
    from repro_torch.core.workloads import vit_base
    from repro_torch.kernels._build import CudaLibrary
    from repro_torch.kernels.replay import megakernel as mk
    from repro_torch.trace.generator import DEFAULT_SPEC

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = CudaLibrary(str(pathlib.Path(other).resolve()),
                      "replay_megakernel_launch",
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                      + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    other_fn = lib.load()
    dev = torch.device("cuda")
    cfg = DramConfig()
    grid = preset_grid(array=[16, 32, 64, 128],
                       sram_mb=[0.25, 0.5, 1, 2, 4, 8], dataflow=["ws"])
    strm, _, _ = sim.decoded_streams(grid, vit_base(), "ws", 2, cfg,
                                     DEFAULT_SPEC, dev)
    ins = mk.prepare(*strm, 64)
    S, npad = ins[0].shape
    kw = dict(cfg=cfg, busy=64 / 19.2, C=64, max_passes=None, tol=0.25)

    def run_other():
        done = torch.empty((S, npad), device=dev)
        shift = torch.empty((S, 1), device=dev)
        cnt = torch.empty((S, 4), dtype=torch.int32, device=dev)
        err = other_fn(
            *(x.data_ptr() for x in ins), done.data_ptr(), shift.data_ptr(),
            cnt.data_ptr(), S, npad // 64, 64, cfg.channels,
            cfg.banks_per_channel, cfg.tRCD, cfg.tRP, cfg.tCAS,
            cfg.read_queue, cfg.write_queue, 1, 1, -1,
            ctypes.c_float(kw["busy"]), ctypes.c_float(kw["tol"]),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the other kernel's launch failed: {err}")
        return done, shift, cnt

    def run_direct():
        return mk.launch_cuda(ins, check_ids=False, **kw)

    same = all(torch.equal(a, b) for a, b in zip(run_other(), run_direct()))
    times = {}
    for _ in range(2):
        for name, fn in (("other", run_other), ("this", run_direct),
                         ("this_wrapper", lambda: mk.launch_cuda(ins, **kw)),
                         ("this_multi_core_form", lambda: mk.launch_cuda(
                             ins, check_ids=False, grouped=True, **kw))):
            times.setdefault(name, {}).setdefault("events_ms", []).append(
                timed_cuda(fn, 20))
        for name, fn in (("other", run_other), ("this", run_direct)):
            times[name].setdefault("graph_ms", []).append(timed_graph(fn))
    print(json.dumps(dict(streams=S, requests_per_stream=npad,
                          bit_for_bit=same, times=times)))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
