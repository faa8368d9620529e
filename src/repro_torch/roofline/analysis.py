"""Roofline terms from a step's counted work; the twin of
``src/repro/roofline/analysis.py``.

  compute term    = FLOPs / (chips × peak_FLOP/s)
  memory term     = bytes / (chips × HBM_bw)
  collective term = collective_bytes / (chips × link_bw)

The reference reads FLOPs and bytes from ``compiled.cost_analysis()`` and
parses the post-SPMD HLO text for the collectives.  Here the work comes
from :mod:`repro_torch.roofline.op_count` (ops dispatched on meta
tensors), and :func:`parse_collectives` reads the books an emulated
:class:`~repro_torch.sharding.spmd.Mesh` keeps of every collective it
ran, under the reference's kind names.  As there, a collective's bytes are
its result's bytes on one device (a ring all-X moves ≈ result bytes per
participating device: the same documented approximation).

One repair: the reference's :meth:`Roofline.fraction_of_roofline` divides
by ``TPU_V5E_HW``'s peak whatever row made the terms; here it divides by
the peak of the row the terms were made with (under ``TPU_V5E_HW`` the
two agree).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.platform import H100_SXM

__all__ = ["H100_SXM_HW", "HW", "TPU_V5E_HW", "parse_collectives",
           "roofline_terms", "Roofline"]

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# The emulated mesh's collectives (sharding/spmd.py) under the reference's
# HLO kind names (pmean books as psum).
KIND_OF = {
    "psum": "all-reduce",
    "pmax": "all-reduce",
    "all_gather": "all-gather",
    "ppermute": "collective-permute",
    "all_to_all": "all-to-all",
}


def _busiest(results: Dict[str, list]) -> int:
    """The mesh device with the most collective result bytes (the lowest
    index on a tie)."""
    size = max((len(v) for v in results.values()), default=1)
    totals = [sum(v[d] for v in results.values()) for d in range(size)]
    return max(range(size), key=lambda d: (totals[d], -d))


def parse_collectives(books) -> Dict[str, Dict[str, float]]:
    """Calls and result bytes per collective kind on the busiest mesh
    device (the most result bytes).

    ``books`` is a :class:`~repro_torch.sharding.spmd.Mesh` or anything
    with its ``collectives`` ({kind: {"calls": [...], ...}}, one entry a
    mesh device) and ``collective_results`` ({kind: [bytes, ...]}).
    Returns the reference's dict: ``{kind: {"count", "bytes"}}`` for its
    five kinds, plus ``"total"``."""
    out: Dict[str, Dict[str, float]] = {
        k: {"count": 0, "bytes": 0.0} for k in _COLLECTIVES
    }
    results = books.collective_results
    device = _busiest(results)
    for kind, book in books.collectives.items():
        ref = KIND_OF[kind]
        out[ref]["count"] += book["calls"][device]
        out[ref]["bytes"] += float(results[kind][device])
    out["total"] = {
        "count": sum(v["count"] for k, v in out.items() if k in _COLLECTIVES),
        "bytes": sum(v["bytes"] for k, v in out.items() if k in _COLLECTIVES),
    }
    return out


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float      # per chip
    hbm_bw: float          # per chip
    link_bw: float         # per link


TPU_V5E_HW = HW("tpu-v5e", 197.0e12, 819.0e9, 50.0e9)
# The port's card, from its platform row: bf16 dense tensor-core peak, HBM3,
# NVLink one direction (data-sheet figures; core/platform.py).
H100_SXM_HW = HW(H100_SXM.name, H100_SXM.dev_flops, H100_SXM.dev_mem_bw,
                 H100_SXM.d2d_bw)


@dataclasses.dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    hw: HW = TPU_V5E_HW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def fraction_of_roofline(self, model_flops: float) -> float:
        """Useful-FLOPs time at this row's peak / modeled step time (≤1)."""
        ideal = model_flops / (self.chips * self.hw.peak_flops)
        return ideal / self.bound_s if self.bound_s > 0 else 0.0


def roofline_terms(
    flops: float,
    bytes_accessed: float,
    collective_bytes: float,
    chips: int,
    hw: HW = TPU_V5E_HW,
) -> Roofline:
    """The three terms of one step.  The inputs are the whole step's
    quantities over ``chips`` chips (pass per-device figures with
    ``chips=1``)."""
    return Roofline(
        compute_s=flops / (chips * hw.peak_flops),
        memory_s=bytes_accessed / (chips * hw.hbm_bw),
        collective_s=collective_bytes / (chips * hw.link_bw),
        flops=flops,
        bytes_accessed=bytes_accessed,
        collective_bytes=collective_bytes,
        chips=chips,
        hw=hw,
    )
