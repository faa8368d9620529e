"""Per-device work of one call, counted from the ops it dispatches: the
twin of ``src/repro/roofline/hlo_parse.py``.

The reference compiles a cell and parses the post-SPMD HLO text: every
computation's dot FLOPs, its operand and result bytes (the HBM-traffic
proxy) and its collectives' result bytes, rolled up through the call graph
with each ``while`` body multiplied by its trip count.  Eager torch has no
HLO to parse.  Here a :class:`OpCounter` (a ``TorchDispatchMode``) sees
every aten op a call dispatches, usually on meta tensors (shapes and
dtypes, no data), and counts

  * dot FLOPs     — ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` / ``mv`` /
                    ``dot`` and SDPA: 2 · m · n · k (a batched product
                    times its batch);
  * traffic bytes — the bytes a step must move through memory.  An op of
                    the offload seam (:mod:`repro_torch.core.dispatch`:
                    GEMM, attention, the SSD scan, …) counts its
                    descriptor's kernel-ideal bytes (``OpCost.
                    touched_bytes``: each operand read and each result
                    written once, as the hand-written kernels stream
                    them), whatever its lowering dispatches; every other
                    op (the glue around the seam) counts its operand and
                    result bytes, except views and metadata ops (the twin
                    of ``_SKIP_TRAFFIC_OPS``).  The glue runs unfused on
                    the card too, so on the kernel path this is what the
                    step moves, not a fused program's traffic.  A
                    tensor-parallel plan's ``shard_map`` bodies call their
                    products directly, and a train step's backward runs
                    outside the lowerings, so their ops count as glue does
                    (an upper bound: the plain products' f32 upcasts
                    included);
  * collectives   — from the books of the emulated mesh the call ran on
                    (:class:`~repro_torch.sharding.spmd.Mesh`), result
                    bytes per device, under the reference's kind names.

Loops need no trip counts: an eager loop dispatches its body once an
iteration, so ``num_whiles`` is 0.

**Per device.**  The mesh runs every mesh device's ``shard_map`` body on a
thread of its own and carries the caller's dispatch modes into it, so the
counter keeps one tally per mesh device (the body's device) and one for
the code outside any body; a collective's own math is left out of both
(the books hold it).  The per-device figure is the largest body tally plus
the outside tally divided by the mesh size: code outside a body runs
unsharded on one device here, where GSPMD would shard it, and the quotient
takes it as sharded evenly (an approximation: a replicated op costs every
device its whole work).  A collective's operand and result bytes count as
traffic of each device it ran on, as the reference's HLO counts an
all-reduce's operands and result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.core import dispatch
from repro_torch.core.cost_model import OpCost
from repro_torch.roofline.analysis import parse_collectives
from repro_torch.sharding import spmd

__all__ = ["ModuleCosts", "OpCounter", "Tally", "count_ops"]

_aten = torch.ops.aten


@dataclasses.dataclass
class ModuleCosts:
    dot_flops: float
    traffic_bytes: float
    collective_bytes: float
    collective_counts: Dict[str, float]
    num_whiles: int


@dataclasses.dataclass
class Tally:
    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    ops: int = 0


def _mm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _sdpa(q, k, v, *_, **__) -> float:
    """QKᵀ and PV of (…, Sq, D) queries against (…, Sk, D) keys."""
    lead = q.numel() // (q.shape[-2] * q.shape[-1])
    return 2.0 * lead * q.shape[-2] * k.shape[-2] * (q.shape[-1]
                                                      + v.shape[-1])


_DOT_FLOPS = {
    _aten.mm.default: lambda a, b: _mm(a, b),
    _aten.addmm.default: lambda c, a, b, **_: _mm(a, b),
    _aten.bmm.default: lambda a, b: _bmm(a, b),
    _aten.baddbmm.default: lambda c, a, b, **_: _bmm(a, b),
    _aten.mv.default: lambda a, v: 2.0 * a.shape[0] * a.shape[1],
    _aten.dot.default: lambda a, b: 2.0 * a.shape[0],
}
for _name in ("_scaled_dot_product_flash_attention",
              "_scaled_dot_product_efficient_attention",
              "_scaled_dot_product_cudnn_attention",
              "_scaled_dot_product_flash_attention_for_cpu"):
    if hasattr(_aten, _name):
        _DOT_FLOPS[getattr(_aten, _name).default] = _sdpa

# Ops that move no bytes of their own (besides views, which alias).
_SKIP_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "lift_fresh", "alias", "_unsafe_view",
    "_reshape_alias", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size",
    "_has_compatible_shallow_copy_type", "resize_", "set_",
})


def _bytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree.leaves(x)
                     if isinstance(t, torch.Tensor)))


def _moves_bytes(func) -> bool:
    return not (func.is_view
                or func.overloadpacket.__name__ in _SKIP_TRAFFIC)


class OpCounter(TorchDispatchMode):
    """Tallies every dispatched op's dot FLOPs and traffic bytes, per mesh
    device (``tallies[dev]``) and outside any body (``tallies[None]``).
    Use :func:`count_ops`, which also takes the mesh's collective books."""

    def __init__(self, mesh: Optional[spmd.Mesh] = None):
        super().__init__()
        self.mesh = mesh
        self.tallies: Dict[Optional[int], Tally] = {}
        self.collectives: Dict[str, Dict[str, list]] = {}
        self.collective_results: Dict[str, list] = {}

    def _tally(self) -> Tally:
        return self.tallies.setdefault(spmd.current_shard(), Tally())

    def _lowering(self, cost: OpCost) -> None:
        """A seam op starts: its kernel-ideal bytes stand for its ops'."""
        if spmd.computing_collective() is None:
            self._tally().traffic_bytes += cost.touched_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if spmd.computing_collective() is not None:
            return out                  # the books count the collective
        t = self._tally()
        t.ops += 1
        dot = _DOT_FLOPS.get(func)
        if dot is not None:
            t.dot_flops += dot(*args, **kwargs)
        if _moves_bytes(func) and not dispatch.in_lowering():
            t.traffic_bytes += _bytes((args, kwargs)) + _bytes(out)
        return out

    # ---- totals ------------------------------------------------------------
    def total(self) -> Tally:
        """Every op's work summed, bodies and outside (the whole mesh's)."""
        out = Tally()
        for t in self.tallies.values():
            out.dot_flops += t.dot_flops
            out.traffic_bytes += t.traffic_bytes
            out.ops += t.ops
        return out

    def _size(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def costs(self) -> ModuleCosts:
        """Per-device work (see the module's note on the approximation);
        the collectives are the busiest device's (:func:`parse_collectives`)."""
        n = self._size()
        outside = self.tallies.get(None, Tally())
        zero = Tally()
        body = [self.tallies.get(d, zero) for d in range(n)]
        coll_traffic = [0.0] * n
        for kind, book in self.collectives.items():
            res = self.collective_results[kind]
            for d in range(n):
                coll_traffic[d] += book["bytes"][d] + res[d]
        parsed = parse_collectives(self)
        collective_counts: Dict[str, float] = {
            k: v["count"] for k, v in parsed.items()
            if k != "total" and v["count"]}
        collective_counts["total"] = parsed["total"]["count"]
        return ModuleCosts(
            dot_flops=max(b.dot_flops for b in body) + outside.dot_flops / n,
            traffic_bytes=max(b.traffic_bytes + c for b, c
                              in zip(body, coll_traffic))
            + outside.traffic_bytes / n,
            collective_bytes=parsed["total"]["bytes"],
            collective_counts=collective_counts,
            num_whiles=0,
        )


def _books(mesh) -> tuple:
    if mesh is None:
        return {}, {}
    return (copy.deepcopy(mesh.collectives),
            copy.deepcopy(mesh.collective_results))


def _diff(after: tuple, before: tuple, size: int) -> tuple:
    (coll_a, res_a), (coll_b, res_b) = after, before
    zeros = [0] * size
    coll = {}
    for kind, book in coll_a.items():
        old = coll_b.get(kind, {"calls": zeros, "bytes": zeros})
        coll[kind] = {f: [x - y for x, y in zip(book[f], old[f])]
                      for f in ("calls", "bytes")}
    res = {kind: [x - y for x, y in zip(v, res_b.get(kind, zeros))]
           for kind, v in res_a.items()}
    return coll, res


@contextlib.contextmanager
def count_ops(mesh: Optional[spmd.Mesh] = None) -> Iterator[OpCounter]:
    """``with count_ops(mesh) as c: step(...)`` counts the step's ops (on
    every mesh device's body too) and the collectives ``mesh`` booked
    meanwhile; then ``c.costs()`` is the per-device :class:`ModuleCosts`
    and ``c.total()`` the whole work."""
    counter = OpCounter(mesh)
    before = _books(mesh)
    with dispatch.observe_lowerings(counter._lowering), counter:
        yield counter
    if mesh is not None:
        counter.collectives, counter.collective_results = _diff(
            _books(mesh), before, mesh.size)
