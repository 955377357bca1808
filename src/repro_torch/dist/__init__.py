"""Distributed substrates the run-farm leans on: straggler detection and
elastic remesh planning (framework-free copies of `repro.dist.straggler`
and `repro.dist.elastic`; the broker sizes shards with them).

The reference's `sharding.MeshCtx` (logical-axis sharding rules for the
model stack) belongs to the workload plane and is not part of this
package yet.
"""
from .elastic import ElasticPlan, plan_elastic_remesh
from .straggler import StragglerDetector

__all__ = ["ElasticPlan", "StragglerDetector", "plan_elastic_remesh"]
