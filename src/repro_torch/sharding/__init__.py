"""repro_torch.sharding — logical-axis partitioning rules, and the mesh
they run on (:mod:`repro_torch.sharding.spmd`)."""

from repro_torch.sharding.partition import (
    batch_pspecs,
    cache_pspecs,
    dp_axes,
    named,
    opt_pspecs,
    param_pspecs,
)

__all__ = [
    "batch_pspecs",
    "cache_pspecs",
    "dp_axes",
    "named",
    "opt_pspecs",
    "param_pspecs",
]
