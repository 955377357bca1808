"""The private-channel decomposition gap of 16 cores at 4,096 requests a
core, in the JAX reference and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/private_channel_gap.py

With one core per channel (`multicore-16x32`, 16 channels, private
routing) the merged shared-DRAM replay should decompose into the 16
isolated replays: the contract is a per-core relative gap of at most
1e-6 between the shared and the isolated stalls. `chip_smoke.py` builds
these streams (GEMM 512 x 2048 x 1024, cap 4,096) and holds the CUDA
kernel and its plain version to 1e-4. This script runs the same study
through the reference's `multicore_contention` with its per-request scan
(`engine="reference"`, exact sequential arithmetic) and its chunked
fixed-point replay (`engine="xla"`, chunk 64, `max_passes=64`, `tol=0`),
and through the port's per-request scan and its plain version (the
chunked replay the CUDA kernel mirrors) on the CPU, and prints one JSON
line: each engine's largest per-core gap, whether it meets 1e-6, its
makespans and its wall seconds.
"""
import dataclasses
import functools
import json
import time

import repro.trace.contention as rcont
from repro.api import get_preset as rpreset
from repro.core.accelerator import DramConfig as RDram
from repro_torch.api import get_preset as tpreset
from repro_torch.core.accelerator import DramConfig as TDram
from repro_torch.trace.contention import multicore_contention as tcontention

M, N, K = 512, 2048, 1024
CONTRACT = 1e-6


def gap(res) -> float:
    return max(abs(s - i) / i for s, i in zip(res.per_core_stall_shared,
                                               res.per_core_stall_isolated))


def run(name, fn):
    t0 = time.perf_counter()
    res = fn()
    g = gap(res)
    return name, dict(gap=g, meets_contract=g <= CONTRACT,
                      wall_s=time.perf_counter() - t0,
                      makespan_shared=float(res.makespan_shared),
                      makespan_isolated=float(res.makespan_isolated))


def main():
    rcfg = dataclasses.replace(rpreset("multicore-16x32"),
                               dram=RDram(channels=16))
    tcfg = dataclasses.replace(tpreset("multicore-16x32"),
                               dram=TDram(channels=16))
    scan = functools.partial(rcont.multicore_contention, rcfg, M, N, K,
                             private_channels=True)
    out = dict([run("reference_per_request_scan",
                    lambda: scan(engine="reference"))])
    # the chunked replay at the phase's settings: multicore_contention runs
    # it at tol=0, with the passes capped at 64
    inner = rcont.simulate_shared_dram
    rcont.simulate_shared_dram = functools.partial(inner, max_passes=64)
    try:
        out.update([run("reference_chunked_xla",
                        lambda: scan(engine="xla"))])
    finally:
        rcont.simulate_shared_dram = inner
    tscan = functools.partial(tcontention, tcfg, M, N, K,
                              private_channels=True, device="cpu")
    out.update([run("port_per_request_scan_cpu",
                    lambda: tscan(engine="reference")),
                run("port_plain_cpu", tscan)])
    print(json.dumps(dict(cores=16, channels=16, requests_per_core=4096,
                          gemm=[M, N, K], contract=CONTRACT, engines=out)))


if __name__ == "__main__":
    main()
