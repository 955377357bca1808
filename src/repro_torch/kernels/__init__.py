"""Hand-written GPU kernels of the PyTorch port, each beside its plain
PyTorch version."""
