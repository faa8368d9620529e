"""repro_torch.runtime — fault tolerance, stragglers, elastic cluster resize.

The mesh half of elastic scaling (``replan`` / ``ElasticPlan``) reads
sharding specs and arrives with the distributed slice.
"""

from repro_torch.runtime.elastic import ResizeEvent, resize_cluster
from repro_torch.runtime.fault_tolerance import (
    ClusterSupervisor,
    DeviceLossEvent,
    HeartbeatMonitor,
    StragglerMonitor,
    WorkerFailure,
    run_with_recovery,
)

__all__ = [
    "ClusterSupervisor",
    "DeviceLossEvent",
    "ResizeEvent",
    "resize_cluster",
    "HeartbeatMonitor",
    "StragglerMonitor",
    "WorkerFailure",
    "run_with_recovery",
]
