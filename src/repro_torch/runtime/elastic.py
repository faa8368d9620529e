"""Elastic re-scaling of the offload cluster at checkpoint boundaries.

``resize_cluster`` is the PMCA-cluster half of the reference's
``runtime/elastic.py``: at a checkpoint boundary the
:class:`~repro_torch.core.hero.HeroCluster` grows by appending cold devices
or shrinks by draining the removed lanes — in-flight launches reschedule
through the active scheduler and pinned
:class:`~repro_torch.core.hero.DeviceHandle` s homed on removed devices are
re-staged onto keepers over the same host-copy path the
:class:`~repro_torch.runtime.fault_tolerance.ClusterSupervisor` uses on
device loss (every move recorded on the new lane's trace).

The mesh half (``replan`` / ``ElasticPlan``: recomputing sharding specs for
a new mesh) reads the sharding layer and arrives with the distributed slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ResizeEvent", "resize_cluster"]


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
