"""Mesh-aware sharding constraints usable from mesh-agnostic model code.

The twin of ``src/repro/sharding/annotate.py``.  ``constrain(x, "dp",
None, "model")`` names the layout a tensor should have under the ambient
mesh; the ``"dp"`` token expands to whichever data-parallel axes the mesh
has (``("pod", "data")`` on the multi-pod mesh, ``("data",)`` on one
pod), so model code never hard-codes the topology.

Every shard of the emulated mesh (:mod:`repro_torch.sharding.spmd`) lives
on one device, where a layout is not a placement: ``constrain`` returns
``x`` itself, with or without an ambient mesh.  Under a mesh it still
expands every token as the reference does and rejects a token that names
no axis layout (an entry that is not ``None``, a name or a tuple of names,
or a tuple naming an axis the mesh lacks); a single name the mesh lacks
expands to ``None``, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.sharding.spmd import P
from repro_torch.sharding.spmd import ambient_mesh as _ambient_mesh

__all__ = ["constrain"]


def _expand(token, mesh) -> Optional[Tuple[str, ...]]:
    if token is None:
        return None
    if token == "dp":
        axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        return axes or None
    if isinstance(token, str):
        return token if token in mesh.axis_names else None
    return token


def constrain(x: torch.Tensor, *spec_tokens) -> torch.Tensor:
    """The identity; under an ambient mesh the spec is checked first."""
    mesh = _ambient_mesh()
    if mesh is None:
        return x
    spec = P(*(_expand(t, mesh) for t in spec_tokens))
    if len(spec) > x.ndim:
        raise ValueError(f"constrain: spec {spec!r} for a rank-{x.ndim} "
                         f"tensor")
    for entry in spec:
        mesh.axes_size(entry)
    return x
