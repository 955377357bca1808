"""Routed NoC/NoP interconnect plane; PyTorch port of `repro.noc`.

  topology.py  static coordinate maps + dimension-ordered routing trees
               (numpy, order-only precompute)
  router.py    flit/credit link model on tensors (scatter-add loads,
               closed-form max-plus backpressure closure, credit-limited
               service intervals), the eager numpy twin and a windowed
               reference simulation for invariant tests
  traffic.py   injection synthesis from the tile schedule: memory-bound NoP
               flits per core, halo exchange, ring all-reduce makespans
  stage.py     the arrival-skew feed into trace/contention.py's
               shared-DRAM queues

Config lives in `repro_torch.core.accelerator.NocConfig`. The reference's
`NocStage` comes with the per-op engine (module item 8, ROADMAP.md).
"""
from ..core.accelerator import NOC_TOPOLOGIES, NocConfig
from .router import (eager_noc_delay, link_loads, noc_delay_model,
                     service_interval, windowed_link_sim)
from .stage import noc_arrival_skew
from .topology import (parent_links, route_pairs, routed_hop_counts,
                       subtree_sizes)
from .traffic import allreduce_cycles, halo_exchange_cycles, memory_flits

__all__ = [
    "NOC_TOPOLOGIES", "NocConfig", "allreduce_cycles",
    "eager_noc_delay", "halo_exchange_cycles", "link_loads", "memory_flits",
    "noc_arrival_skew", "noc_delay_model", "parent_links", "route_pairs",
    "routed_hop_counts", "service_interval", "subtree_sizes",
    "windowed_link_sim",
]
