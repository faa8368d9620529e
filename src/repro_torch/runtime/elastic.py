"""Elastic re-scaling: re-plan any checkpoint onto any mesh, and grow or
shrink the offload cluster at checkpoint boundaries.

The twin of ``src/repro/runtime/elastic.py``.  Checkpoints store full
logical tensors (:mod:`repro_torch.checkpoint`), so scaling a job from N
to M pods is: build the new mesh and recompute the specs for the same
param tree (``replan``).  ``replan`` also rescales the data-parallel batch
splitting: the global batch is invariant; hosts' local batches change.

``resize_cluster`` is the PMCA-cluster half of the same story: at a
checkpoint boundary the
:class:`~repro_torch.core.hero.HeroCluster` grows by appending cold devices
or shrinks by draining the removed lanes — in-flight launches reschedule
through the active scheduler and pinned
:class:`~repro_torch.core.hero.DeviceHandle` s homed on removed devices are
re-staged onto keepers over the same host-copy path the
:class:`~repro_torch.runtime.fault_tolerance.ClusterSupervisor` uses on
device loss (every move recorded on the new lane's trace).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.sharding import named, opt_pspecs, param_pspecs

__all__ = ["ElasticPlan", "ResizeEvent", "replan", "resize_cluster"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh: object
    param_shardings: object
    opt_shardings: Optional[object]
    global_batch: int
    local_batch: int
    num_hosts: int


def replan(
    mesh,
    param_shapes,
    opt_shapes=None,
    *,
    global_batch: int,
    num_hosts: int,
) -> ElasticPlan:
    if global_batch % num_hosts:
        raise ValueError(
            f"global batch {global_batch} not divisible by {num_hosts} hosts"
        )
    p_shard = named(mesh, param_pspecs(param_shapes, mesh))
    o_shard = (
        named(mesh, opt_pspecs(opt_shapes, mesh)) if opt_shapes is not None
        else None
    )
    return ElasticPlan(
        mesh=mesh,
        param_shardings=p_shard,
        opt_shardings=o_shard,
        global_batch=global_batch,
        local_batch=global_batch // num_hosts,
        num_hosts=num_hosts,
    )


@dataclasses.dataclass(frozen=True)
class ResizeEvent:
    """One cluster grow/shrink at a checkpoint boundary."""

    before: int
    after: int
    # Handles re-staged off removed devices: (handle name, new device id).
    restaged: Tuple[Tuple[str, int], ...] = ()


def resize_cluster(cluster, num_devices: int, *, supervisor=None) -> ResizeEvent:
    """Grow/shrink a :class:`HeroCluster` at a checkpoint boundary.

    Thin policy wrapper over :meth:`HeroCluster.resize`: grow appends cold
    devices (existing queues, residency and pinned handles untouched);
    shrink reschedules the removed lanes' in-flight work and re-stages
    their pinned handles onto keepers via the existing supervisor path.
    Pass the watching :class:`ClusterSupervisor` so its heartbeat table
    follows the new topology.
    """
    before = cluster.num_devices
    moves = cluster.resize(num_devices)
    if supervisor is not None:
        supervisor.resync()
    return ResizeEvent(
        before=before, after=cluster.num_devices, restaged=tuple(moves)
    )
