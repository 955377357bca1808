"""Simulation core of the PyTorch port: configs, workloads, the dataflow
and energy models, the trace-fidelity DRAM timing model."""
