"""Dataflow-aware DRAM demand-trace generation (PyTorch port)."""
