"""Static verifier for ``hnp`` lazy expression graphs — the twin of the
reference's ``analysis/graph.py``, rule for rule.

The frontend captures whole computations as expression graphs and the
scheduler lowers them onto the offload registry in topological waves,
fusing elementwise chains and stacking independent GEMMs.  Every one of
those transformations assumes invariants: node shapes/dtypes must agree
with the registry host lowerings they will dispatch through, residency
handles must still be alive (and known to the engine) when a node
consuming them is forced, no buffer may be staged onto a device twice, and
the wave schedule must be hazard-free (no stacked launch reading a value
produced inside the same launch, no fused chain overwriting a value a live
consumer still needs).

This module checks all of that *pre-dispatch*, on the captured graph — the
verifier never launches anything.  It is exposed three ways:

* standalone: :func:`verify_graph` / :func:`assert_valid` over graph roots;
* ``hnp.offload_region(..., validate=True)`` — the scheduler calls
  :func:`assert_valid` on every graph forced inside the region;
* ``dispatch_placed(..., validate=True)`` — :func:`verify_call` checks one
  eager registry call (operand shapes against the host lowering, handle
  lifetime) before anything is scheduled or recorded.

Where the reference evaluates a host lowering abstractly with
``jax.eval_shape``, this module runs it on ``device="meta"`` tensors, as
:func:`~repro_torch.frontend.lazy.registry_node` does at capture time:
shapes and dtypes propagate, no data is read, nothing runs on a device.
Node dtypes are torch dtypes; a numpy dtype written onto a node compares
through :func:`~repro_torch.frontend.lazy.torch_dtype`.

Violations carry the reference's rule names (``graph/shape-mismatch``,
``graph/use-after-unstage``, ``graph/raw-hazard``, ...).  The engine loads
lazily inside the checks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.base import AnalysisError, Violation
from repro_torch.frontend.lazy import (
    ELEMENTWISE,
    ELEMENTWISE_BINARY,
    ELEMENTWISE_UNARY,
    REDUCTIONS,
    SHAPE_OPS,
    Node,
    _meta,
    _result_dtype,
    is_heavy,
    rebuild_call,
    torch_dtype,
)
from repro_torch.frontend.schedule import _batch_key, _fusion_chains

__all__ = [
    "GraphVerificationError",
    "WavePlan",
    "assert_call_valid",
    "assert_valid",
    "check_plan",
    "collect_nodes",
    "plan_waves",
    "verify_call",
    "verify_graph",
]


class GraphVerificationError(AnalysisError):
    def __init__(self, violations: Sequence[Violation]) -> None:
        super().__init__(violations, "hnp graph failed pre-dispatch verification")


def _where(node: Node) -> str:
    return f"node#{node.id}({node.op})"


# ---------------------------------------------------------------------------
# Graph walk
# ---------------------------------------------------------------------------

def collect_nodes(roots: Sequence[Node]) -> List[Node]:
    """Postorder over every node reachable from ``roots`` (leaves included,
    evaluated or not — unlike the scheduler's walk, verification wants the
    whole captured graph, since corruption hides in the evaluated parts)."""
    order: List[Node] = []
    seen = set()
    stack: List[Tuple[Node, bool]] = [(r, False) for r in reversed(list(roots))]
    while stack:
        node, expanded = stack.pop()
        if node.id in seen:
            continue
        if expanded:
            seen.add(node.id)
            order.append(node)
            continue
        stack.append((node, True))
        for inp in node.inputs:
            if inp.id not in seen:
                stack.append((inp, False))
    return order


# ---------------------------------------------------------------------------
# Structural rules: shape/dtype consistency, arity, staleness
# ---------------------------------------------------------------------------

def _spec_meta(shape, dtype) -> torch.Tensor:
    """A meta tensor standing in for one operand spec."""
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def _registry_infer(node: Node) -> Tuple[Tuple[int, ...], Any]:
    """Re-infer a registry node's result spec through the op's *host*
    lowering on meta tensors (the same abstract evaluation
    ``registry_node`` used at capture time) — the ground truth the dispatch
    will actually run against."""
    import repro_torch.core.blas  # noqa: F401 — populate the registry
    from repro_torch.core.dispatch import get_op

    op = get_op(node.attrs["name"])
    pos, kw = rebuild_call(node, [_meta(i) for i in node.inputs])
    out = op.host(*pos, **kw)
    return tuple(out.shape), out.dtype


def _expected_spec(node: Node) -> Optional[Tuple[Tuple[int, ...], Any]]:
    """Independently recompute (shape, dtype) for one node, or None when the
    op carries no static contract to check (weak scalar leaves)."""
    ins = node.inputs
    if node.op == "leaf":
        if node.dtype is None:          # weak Python scalar
            return None
        return tuple(np.shape(node.value)) if node.evaluated else node.shape, (
            getattr(node.value, "dtype", node.dtype) if node.evaluated
            else node.dtype
        )
    if node.op in ELEMENTWISE_UNARY:
        (x,) = ins
        return x.shape, x.dtype
    if node.op in ELEMENTWISE_BINARY:
        a, b = ins
        return (
            tuple(np.broadcast_shapes(a.shape, b.shape)),
            _result_dtype(a.dtype, b.dtype),
        )
    if node.op in REDUCTIONS:
        (x,) = ins
        axis = node.attrs.get("axis")
        axes = (
            tuple(range(x.ndim)) if axis is None
            else tuple(
                a % x.ndim
                for a in ((axis,) if isinstance(axis, int) else tuple(axis))
            )
        )
        if node.attrs.get("keepdims"):
            shape = tuple(1 if i in axes else d for i, d in enumerate(x.shape))
        else:
            shape = tuple(d for i, d in enumerate(x.shape) if i not in axes)
        return shape, x.dtype
    if node.op == "reshape":
        return tuple(node.attrs["shape"]), ins[0].dtype
    if node.op == "transpose":
        (x,) = ins
        return tuple(x.shape[a] for a in node.attrs["axes"]), x.dtype
    if node.op == "astype":
        return ins[0].shape, node.attrs["dtype"]
    if is_heavy(node.op):
        return _registry_infer(node)
    return None


_ARITY = {1: ELEMENTWISE_UNARY | REDUCTIONS | SHAPE_OPS, 2: ELEMENTWISE_BINARY}


def _check_structure(order: List[Node]) -> List[Violation]:
    out: List[Violation] = []
    known = ELEMENTWISE | REDUCTIONS | SHAPE_OPS | {"leaf"}
    for n in order:
        if n.op not in known and not is_heavy(n.op):
            out.append(Violation(
                "graph/unknown-op",
                f"node has no lowering: op {n.op!r} is neither a light op "
                "nor a registry:<op> dispatch",
                _where(n),
            ))
            continue
        for arity, ops in _ARITY.items():
            if n.op in ops and len(n.inputs) != arity:
                out.append(Violation(
                    "graph/bad-arity",
                    f"{n.op!r} expects {arity} input(s), found "
                    f"{len(n.inputs)}",
                    _where(n),
                ))
                break
        else:
            if n.evaluated and n.op != "leaf" and any(
                not i.evaluated for i in n.inputs
            ):
                pend = [i.id for i in n.inputs if not i.evaluated]
                out.append(Violation(
                    "graph/stale-value",
                    "node carries a cached value while producer input(s) "
                    f"{pend} are still pending — a consumer would read a "
                    "stale buffer (RAW on the value cache)",
                    _where(n),
                ))
                continue
            try:
                spec = _expected_spec(n)
            except KeyError as e:
                out.append(Violation(
                    "graph/unknown-op",
                    f"registry lookup failed: {e}",
                    _where(n),
                ))
                continue
            except Exception as e:
                out.append(Violation(
                    "graph/shape-mismatch",
                    "host lowering rejected the operand specs: "
                    f"{type(e).__name__}: {e}",
                    _where(n),
                ))
                continue
            if spec is None:
                continue
            shape, dtype = spec
            if tuple(shape) != tuple(n.shape):
                out.append(Violation(
                    "graph/shape-mismatch",
                    f"node claims shape {n.shape} but {n.op!r} over inputs "
                    f"{[i.shape for i in n.inputs]} produces {tuple(shape)}",
                    _where(n),
                ))
            elif dtype is not None and n.dtype is not None and (
                torch_dtype(dtype) != torch_dtype(n.dtype)
            ):
                out.append(Violation(
                    "graph/dtype-mismatch",
                    f"node claims dtype {n.dtype} but {n.op!r} produces "
                    f"{dtype}",
                    _where(n),
                ))
    return out


# ---------------------------------------------------------------------------
# Residency lifetime rules
# ---------------------------------------------------------------------------

def _engine_or_none():
    try:
        from repro_torch.core.hero import engine

        return engine()
    except Exception:  # pragma: no cover — engine import failure
        return None


def _handle_violations(handle, eng, where: str) -> List[Violation]:
    if handle is None or not hasattr(handle, "valid"):
        return []
    if not handle.valid:
        return [Violation(
            "graph/use-after-unstage",
            f"buffer {handle.name!r} is consumed after its handle was "
            "unstaged/evicted — the residency credit it promises is gone",
            where,
        )]
    if eng is not None and eng.handle(handle.name) is not handle:
        return [Violation(
            "graph/handle-escapes-region",
            f"handle {handle.name!r} (device {handle.device_id}) is not in "
            "the engine ledger — it escaped the offload_region/handle_scope "
            "that owned it",
            where,
        )]
    return []


def _check_residency(order: List[Node], region) -> List[Violation]:
    out: List[Violation] = []
    eng = _engine_or_none()
    by_buffer: Dict[int, List[Tuple[Node, Any]]] = {}
    for n in order:
        handles = []
        h = n.attrs.get("handle") if isinstance(n.attrs, dict) else None
        if h is not None:
            handles.append(h)
        if region is not None:
            rh = getattr(region, "residency", {}).get(n.id)
            if rh is not None and rh is not h:
                handles.append(rh)
        for h in handles:
            out.extend(_handle_violations(h, eng, _where(n)))
        if n.evaluated and n.dtype is not None:
            live = [h for h in handles if getattr(h, "valid", False)]
            if live:
                by_buffer.setdefault(id(n.value), []).append((n, live))
    for entries in by_buffer.values():
        names = {h.name for _, hs in entries for h in hs}
        if len(names) > 1:
            nodes = ",".join(_where(n) for n, _ in entries)
            out.append(Violation(
                "graph/double-stage",
                "the same underlying buffer is staged on device under "
                f"{len(names)} distinct handles ({sorted(names)}) — the "
                "copy is paid twice and the residency ledgers disagree",
                nodes,
            ))
    return out


# ---------------------------------------------------------------------------
# Wave-schedule hazards
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WavePlan:
    """The schedule the scheduler *would* run: topological waves over the
    unevaluated subgraph, per-head fused elementwise chains, and stacked
    ``gemm_batched`` groups.  :func:`check_plan` validates a plan — the
    real one from :func:`plan_waves`, or an injected/corrupted one in
    tests — independently of how it was built."""

    order: List[Node]
    waves: List[List[Node]]
    chains: Dict[int, List[Node]]      # head node id -> fused chain
    groups: List[List[Node]]           # members of one stacked launch
    leftover: List[Node]               # unschedulable nodes (cycles)


def plan_waves(roots: Sequence[Node]) -> WavePlan:
    """Dry-run the scheduler's wave construction (no dispatch, no values)."""
    order = [n for n in collect_nodes(roots) if not n.evaluated]
    in_graph = {n.id for n in order}
    by_id = {n.id: n for n in order}
    consumers: Dict[int, List[Node]] = {}
    deps: Dict[int, int] = {}
    for n in order:
        cnt = 0
        for i in n.inputs:
            if i.id in in_graph:
                consumers.setdefault(i.id, []).append(n)
                cnt += 1
        deps[n.id] = cnt
    chains, _fused_into = _fusion_chains(order, consumers)
    waves: List[List[Node]] = []
    groups: List[List[Node]] = []
    ready = sorted(nid for nid, c in deps.items() if c == 0)
    done = set()
    while ready:
        wave = [by_id[i] for i in ready]
        waves.append(wave)
        batch: Dict[Any, List[Node]] = {}
        for n in wave:
            if is_heavy(n.op):
                key = _batch_key(n)
                if key is not None:
                    batch.setdefault(key, []).append(n)
        groups.extend(m for m in batch.values() if len(m) >= 2)
        nxt: List[int] = []
        for n in wave:
            done.add(n.id)
            for c in consumers.get(n.id, []):
                deps[c.id] -= 1
                if deps[c.id] == 0:
                    nxt.append(c.id)
        ready = sorted(nxt)
    leftover = [n for n in order if n.id not in done]
    return WavePlan(order, waves, chains, groups, leftover)


def _reaches(src: Node, dst: Node, in_graph: set) -> bool:
    """True when ``dst`` is reachable from ``src`` through graph inputs."""
    stack, seen = [src], set()
    while stack:
        n = stack.pop()
        if n.id == dst.id:
            return True
        if n.id in seen:
            continue
        seen.add(n.id)
        stack.extend(i for i in n.inputs if i.id in in_graph)
    return False


def check_plan(plan: WavePlan) -> List[Violation]:
    """Validate one wave schedule against the hazard rules."""
    out: List[Violation] = []
    if plan.leftover:
        out.append(Violation(
            "graph/cycle",
            "schedule cannot complete; unschedulable nodes (dependency "
            f"cycle): {[_where(n) for n in plan.leftover]}",
        ))
    in_graph = {n.id for n in plan.order}
    wave_of: Dict[int, int] = {}
    for k, wave in enumerate(plan.waves):
        for n in wave:
            wave_of[n.id] = k
    chain_of: Dict[int, int] = {}      # link id -> head id
    chain_pos: Dict[int, int] = {}     # link id -> position in chain
    for head_id, chain in plan.chains.items():
        for pos, link in enumerate(chain):
            chain_of[link.id] = head_id
            chain_pos[link.id] = pos
            # a fused link executes with its head's launch
            if head_id in wave_of:
                wave_of[link.id] = wave_of[head_id]

    # RAW: every read must happen-after the write that produced it.
    for n in plan.order:
        if n.id not in wave_of:
            continue  # leftover, already reported as a cycle
        for i in n.inputs:
            if i.id not in in_graph or i.id not in wave_of:
                continue
            same_chain = (
                chain_of.get(n.id) is not None
                and (
                    chain_of.get(i.id) == chain_of.get(n.id)
                    and chain_pos[i.id] < chain_pos[n.id]
                    or i.id == chain_of.get(n.id)
                )
            )
            if same_chain:
                continue  # ordered within one fused launch
            if wave_of[i.id] >= wave_of[n.id]:
                out.append(Violation(
                    "graph/raw-hazard",
                    f"{_where(n)} (wave {wave_of[n.id]}) reads "
                    f"{_where(i)} scheduled in wave {wave_of[i.id]} — the "
                    "consumer would launch before its producer's value "
                    "exists",
                    _where(n),
                ))

    # RAW inside one stacked launch: a gemm_batched member must not depend
    # on another member — the single launch would read its own output.
    for members in plan.groups:
        for a in members:
            for b in members:
                if a is not b and _reaches(a, b, in_graph):
                    out.append(Violation(
                        "graph/raw-hazard",
                        f"stacked launch batches {_where(a)} with its own "
                        f"producer {_where(b)} — the batched GEMM would "
                        "read a value it is itself computing",
                        _where(a),
                    ))

    # WAR: a fused chain evaluates link k and moves on; any *other* consumer
    # of link k in the plan reads after the chain has conceptually replaced
    # it — every non-final link must have exactly its successor as consumer.
    consumers: Dict[int, List[Node]] = {}
    for n in plan.order:
        for i in n.inputs:
            if i.id in in_graph:
                consumers.setdefault(i.id, []).append(n)
    for head_id, chain in plan.chains.items():
        prev_id = head_id
        for pos, link in enumerate(chain):
            if prev_id not in {i.id for i in link.inputs}:
                out.append(Violation(
                    "graph/war-hazard",
                    f"fused chain under head node#{head_id} is not linear: "
                    f"{_where(link)} does not consume its predecessor "
                    f"node#{prev_id}",
                    _where(link),
                ))
            if pos < len(chain) - 1:
                cs = consumers.get(link.id, [])
                extra = [c for c in cs if c.id != chain[pos + 1].id]
                if extra:
                    out.append(Violation(
                        "graph/war-hazard",
                        f"fused link {_where(link)} has outside consumer(s) "
                        f"{[_where(c) for c in extra]} — fusing it into "
                        f"node#{head_id}'s launch overwrites a value a live "
                        "reader still needs",
                        _where(link),
                    ))
            prev_id = link.id
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def verify_graph(
    roots: Sequence[Node],
    region=None,
    *,
    check_shapes: bool = True,
    check_waves: bool = True,
) -> List[Violation]:
    """Run every graph rule over the subgraph reachable from ``roots``.

    ``region`` (a :class:`~repro_torch.frontend.schedule.GraphRegion`) supplies
    scheduler-owned residency for the lifetime rules; without it only
    node-attached handles are checked.
    """
    roots = [getattr(r, "node", r) for r in roots]
    order = collect_nodes(roots)
    out: List[Violation] = []
    if check_shapes:
        out.extend(_check_structure(order))
    out.extend(_check_residency(order, region))
    if check_waves:
        out.extend(check_plan(plan_waves(roots)))
    return out


def assert_valid(roots: Sequence[Node], region=None) -> None:
    violations = verify_graph(roots, region)
    if violations:
        raise GraphVerificationError(violations)


def verify_call(
    name: str,
    args: Sequence[Any] = (),
    kwargs: Optional[Dict[str, Any]] = None,
    *,
    handle=None,
) -> List[Violation]:
    """Verify one *eager* registry call pre-dispatch (``dispatch_placed``'s
    ``validate=True``): op known, handle alive and engine-owned, operand
    shapes/dtypes accepted by the host lowering under abstract evaluation.
    """
    kwargs = dict(kwargs or {})
    where = f"dispatch:{name}"
    import repro_torch.core.blas  # noqa: F401 — populate the registry
    from repro_torch.core.dispatch import get_op

    try:
        op = get_op(name)
    except KeyError as e:
        return [Violation("graph/unknown-op", str(e), where)]
    out = _handle_violations(handle, _engine_or_none(), where)

    def _is_array(v) -> bool:
        return hasattr(v, "shape") and hasattr(v, "dtype")

    specs = [a for a in (*args, *kwargs.values()) if _is_array(a)]
    try:
        pos = [_spec_meta(a.shape, a.dtype) if _is_array(a) else a
               for a in args]
        kw = {k: (_spec_meta(v.shape, v.dtype) if _is_array(v) else v)
              for k, v in kwargs.items()}
        op.host(*pos, **kw)
    except Exception as e:
        out.append(Violation(
            "graph/shape-mismatch",
            "host lowering rejected the operand specs "
            f"{[(tuple(s.shape), str(s.dtype)) for s in specs]}: "
            f"{type(e).__name__}: {e}",
            where,
        ))
    return out


def assert_call_valid(
    name: str,
    args: Sequence[Any] = (),
    kwargs: Optional[Dict[str, Any]] = None,
    *,
    handle=None,
) -> None:
    violations = verify_call(name, args, kwargs, handle=handle)
    if violations:
        raise GraphVerificationError(violations)
