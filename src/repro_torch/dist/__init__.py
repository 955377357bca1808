"""Distributed substrates: the mesh context and logical-axis sharding
rules of the model stack (`sharding`), collectives over named mesh axes
(`collectives`), straggler detection and elastic remesh planning
(framework-free copies of `repro.dist.straggler` and `repro.dist.elastic`;
the broker sizes shards with them).
"""
from .elastic import ElasticPlan, plan_elastic_remesh
from .sharding import MeshCtx, logical_to_spec, make_mesh_ctx
from .straggler import StragglerDetector

__all__ = [
    "ElasticPlan", "MeshCtx", "StragglerDetector", "logical_to_spec",
    "make_mesh_ctx", "plan_elastic_remesh",
]
