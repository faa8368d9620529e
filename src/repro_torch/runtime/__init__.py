"""repro_torch.runtime — fault tolerance, stragglers, elastic scaling."""

from repro_torch.runtime.elastic import (ElasticPlan, ResizeEvent, replan,
                                         resize_cluster)
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
    "ElasticPlan",
    "ResizeEvent",
    "replan",
    "resize_cluster",
    "HeartbeatMonitor",
    "StragglerMonitor",
    "WorkerFailure",
    "run_with_recovery",
]
