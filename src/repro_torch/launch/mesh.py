"""Production and local meshes.

The twin of ``src/repro/launch/mesh.py``, on the emulated mesh of
:mod:`repro_torch.sharding.spmd`: every mesh device's shard lives on one
torch device.  The production meshes (16 × 16 and 2 × 16 × 16) feed the
sharding rules; their threads start only if a ``shard_map`` runs on them.
"""

from __future__ import annotations

import torch

from repro_torch.launch.serve import resolve_device
from repro_torch.sharding.spmd import Mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16x16 = 256 chips per pod; multi_pod adds the scale-out 'pod' axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=resolve_device(device))


def make_local_mesh(device="cuda") -> Mesh:
    """Whatever devices exist locally, as a (data, model) mesh (model=1):
    the card count on the card, one on the CPU."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh((n, 1), ("data", "model"), device=dev)
