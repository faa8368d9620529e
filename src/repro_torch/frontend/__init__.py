"""repro_torch.frontend — graph capture layer between user code and the
cluster.

``repro_torch.hnp`` (the public face of this package) is a lazy NumPy-like
namespace: operations build an expression graph instead of executing, and a
graph scheduler lowers whole graphs onto the declarative offload registry —
fusing elementwise chains, batching independent GEMMs across cluster lanes,
and keeping device-resident intermediates on device.

Modules:
  lazy      — LazyArray + expression-graph nodes (meta-tensor shape
              inference)
  schedule  — the graph scheduler / registry lowering + GraphRegion scoping
  api       — the hnp namespace (re-exported as ``repro_torch.hnp``)
"""

from repro_torch.frontend.lazy import LazyArray, Node  # noqa: F401
from repro_torch.frontend.schedule import (  # noqa: F401
    GraphRegion,
    GraphReport,
    NodeReport,
    evaluate,
    offload_region,
)

__all__ = [
    "GraphRegion",
    "GraphReport",
    "LazyArray",
    "Node",
    "NodeReport",
    "evaluate",
    "offload_region",
]
