"""Elastic remesh planning: map a (possibly shrunken) device fleet to a
mesh shape + per-device batch + gradient accumulation that preserves the
global batch size.

Policy (paper-scale training): keep tensor parallelism as wide as the fleet
allows (shrink TP last, halving), spread the rest over data parallelism,
and absorb lost data parallelism with gradient accumulation so the global
batch -- and therefore the training trajectory -- is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    dp: int
    tp: int
    per_device_batch: int
    grad_accum: int

    @property
    def global_batch(self) -> int:
        return self.per_device_batch * self.dp * self.grad_accum


def plan_elastic_remesh(n_devices: int, *, global_batch: int, tp: int = 1,
                        prefer_pod: Optional[int] = None,
                        max_per_device_batch: int = 8) -> ElasticPlan:
    """Plan a mesh for `n_devices` that keeps `global_batch` intact.

    prefer_pod: split the data axis into (pod, data) when the pod count
    divides the data parallelism (multi-pod meshes).
    """
    if n_devices < 1:
        raise ValueError("need at least one device")
    tp_eff = max(1, min(int(tp), n_devices))
    while n_devices % tp_eff:
        tp_eff //= 2
    dp = n_devices // tp_eff

    per_seq = max(1, -(-global_batch // dp))       # batch rows per DP rank
    accum = max(1, -(-per_seq // max_per_device_batch))
    pdb = max(1, -(-per_seq // accum))

    if prefer_pod and prefer_pod > 1 and dp % prefer_pod == 0 \
            and dp > prefer_pod:
        shape: Tuple[int, ...] = (prefer_pod, dp // prefer_pod, tp_eff)
        axes: Tuple[str, ...] = ("pod", "data", "model")
    else:
        shape = (dp, tp_eff)
        axes = ("data", "model")
    return ElasticPlan(mesh_shape=shape, mesh_axes=axes, dp=dp, tp=tp_eff,
                       per_device_batch=pdb, grad_accum=accum)
