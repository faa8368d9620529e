"""repro_torch.core — the paper's contribution: a heterogeneous BLAS offload seam.

Layers (mirroring the paper's Fig. 2):
  platform    — analytic hardware models (heSoC from the paper, TPU v5e,
                H100 SXM)
  cost_model  — three-region offload cost model (copy / fork-join / compute)
  hero        — offload cluster: N virtual PMCAs, residency ledgers,
                device-resident handles, pluggable scheduler, launch records
  dispatch    — declarative op registry: OffloadOp descriptors + the single
                cost -> plan -> launch -> lower dispatch path
  blas        — the BLAS API every model layer calls (thin wrappers over
                registered descriptors)
  accounting  — per-call offload trace (the paper's Fig. 3 instrumentation,
                with per-device rollups and an overlap timeline)
"""

from repro_torch.core import blas
from repro_torch.core.accounting import (
    DeviceAggregate,
    DeviceTimeline,
    OffloadRecord,
    OffloadTrace,
    offload_trace,
)
from repro_torch.core.cost_model import (
    OpCost,
    PipelinedBreakdown,
    RegionBreakdown,
    attention_cost,
    breakdown,
    crossover_size,
    decide_offload,
    gemm_cost,
    gemv_cost,
    pipeline_makespan,
    pipelined_breakdown,
    staging_legs,
    syrk_cost,
)
from repro_torch.core import dispatch
from repro_torch.core.dispatch import OffloadOp, registered_ops
from repro_torch.core.hero import (
    SCHEDULERS,
    DeviceHandle,
    HeroCluster,
    LaunchResult,
    LaunchTicket,
    OffloadPolicy,
    VirtualDevice,
    engine,
    offload_policy,
)
from repro_torch.core.platform import (
    CPU_HOST,
    H100_SXM,
    HESOC_VCU128,
    TPU_V5E,
    Platform,
    get_platform,
)

__all__ = [
    "blas",
    "dispatch",
    "DeviceHandle",
    "OffloadOp",
    "registered_ops",
    "OffloadRecord",
    "OffloadTrace",
    "offload_trace",
    "OpCost",
    "PipelinedBreakdown",
    "RegionBreakdown",
    "attention_cost",
    "breakdown",
    "crossover_size",
    "decide_offload",
    "gemm_cost",
    "gemv_cost",
    "pipeline_makespan",
    "pipelined_breakdown",
    "staging_legs",
    "syrk_cost",
    "DeviceAggregate",
    "DeviceTimeline",
    "HeroCluster",
    "LaunchResult",
    "LaunchTicket",
    "OffloadPolicy",
    "SCHEDULERS",
    "VirtualDevice",
    "engine",
    "offload_policy",
    "CPU_HOST",
    "H100_SXM",
    "HESOC_VCU128",
    "TPU_V5E",
    "Platform",
    "get_platform",
]
