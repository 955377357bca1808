"""Simulation core of the PyTorch port: configs, workloads, the dataflow
and energy models, the trace-fidelity DRAM timing model, and the
multi-core partition with its shared-DRAM contention path."""
from .multicore import (contention_summary, simulate_multicore,
                        simulate_multicore_contention)

__all__ = ["contention_summary", "simulate_multicore",
           "simulate_multicore_contention"]
