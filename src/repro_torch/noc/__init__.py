"""The NoC/NoP interconnect plane (PyTorch port of `repro.noc`), in part:
only the arrival-skew feed of the shared-DRAM contention queues, NoC
disabled. The routed plane (topology, router, traffic, `NocStage`) comes
with module item 7 of the port (ROADMAP.md)."""
from .stage import noc_arrival_skew

__all__ = ["noc_arrival_skew"]
