"""The workload plane's model zoo in PyTorch: configs, parameters, the
blocks of the 10 assigned architectures, prefill and decode.

The JAX package's `repro.models` is the reference; this package keeps its
layouts (parameter trees stacked over layers, caches stacked the same way)
at its public functions so that the two can be held against each other.
"""
