"""Graph scheduler — lowers a lazy ``hnp`` expression graph onto the
offload registry.

Where eager ``repro_torch.core.blas`` calls pay host<->device staging per op and
the cluster scheduler never sees more than one call ahead, this module sees
the *shape of the whole computation* (Pirova et al.) and exploits it:

* **topological waves** — independent ops surface together, so the cluster
  scheduler can spread them across lanes;
* **elementwise fusion** — a single-consumer elementwise chain (bias add,
  ``tanh``, ``silu`` ...) folds into its producer's lowering: no extra
  dispatch record, no staging for the chain's intermediates;
* **GEMM batching** — same-shape independent 2-D GEMMs in one wave stack
  into a single ``gemm_batched`` launch (one fork/join instead of N);
* **residency threading** — the key win: an intermediate produced on a
  device *stays* device-resident for its consumers instead of round-tripping
  through host DRAM.  Each heavy node dispatches with the exact fraction of
  its operand/result bytes already (or staying) on device, and cross-device
  consumption is charged over the d2d link (``migrate_handle``), riding the
  DMA stream in the overlap timeline.

The offload seam is imported inside functions, so importing the frontend
stays cheap.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.frontend.lazy import (
    ELEMENTWISE,
    Node,
    is_heavy,
    rebuild_call,
)
from repro_torch.obs import spans as _obs

__all__ = [
    "GraphReport",
    "GraphRegion",
    "NodeReport",
    "current_region",
    "evaluate",
    "evaluate_many",
    "offload_region",
]

_REGION_IDS = itertools.count()

# Registry ops whose independent same-shape 2-D instances can stack into one
# gemm_batched launch.
_BATCHABLE = frozenset({"registry:matmul", "registry:gemm"})


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeReport:
    """Accounting view of one heavy (registry-dispatched) graph node."""

    node_id: int
    op: str
    backend: str
    device_id: int
    resident_fraction: float
    staged_in_bytes: float      # host->device bytes paid for operands
    readback_bytes: float       # device->host bytes paid for the result
    fused: Tuple[str, ...] = ()  # elementwise ops folded into this launch
    batched: bool = False        # member of a stacked gemm_batched launch


@dataclasses.dataclass
class GraphReport:
    """Rollup of every dispatch the scheduler issued for one graph scope."""

    name: str
    launches: List[NodeReport] = dataclasses.field(default_factory=list)
    # Nodes removed before scheduling: duplicate subtrees collapsed by
    # common-subexpression elimination plus the dead nodes only they fed.
    nodes_eliminated: int = 0
    # Bytes staged ahead of their consumer by cross-wave prefetch: wave k+1
    # operand copies issued while wave k computes, riding the DMA stream
    # under compute.  Not part of ``staged_bytes`` — the consumer's launch
    # takes the residency credit instead of paying the copy region.
    prefetched_bytes: float = 0.0

    @property
    def staged_in_bytes(self) -> float:
        return sum(r.staged_in_bytes for r in self.launches)

    @property
    def readback_bytes(self) -> float:
        return sum(r.readback_bytes for r in self.launches)

    @property
    def staged_bytes(self) -> float:
        return self.staged_in_bytes + self.readback_bytes

    @property
    def fused_ops(self) -> int:
        return sum(len(r.fused) for r in self.launches)

    @property
    def batched_launches(self) -> int:
        return sum(1 for r in self.launches if r.batched)

    def summary(self) -> str:
        s = (
            f"graph {self.name!r}: {len(self.launches)} launches, "
            f"{self.fused_ops} fused elementwise ops, "
            f"{self.batched_launches} batched GEMMs, "
            f"{self.nodes_eliminated} nodes CSE/DCE-eliminated, "
            f"staged_in={self.staged_in_bytes:.0f}B "
            f"readback={self.readback_bytes:.0f}B"
        )
        if self.prefetched_bytes > 0:
            s += f" prefetched={self.prefetched_bytes:.0f}B"
        return s


# ---------------------------------------------------------------------------
# Graph regions — scope residency + handle lifetimes over many evaluations
# ---------------------------------------------------------------------------

class GraphRegion:
    """Scope for one logical graph: shared residency map, owned handles,
    accumulated report.

    Used directly as the ``hnp.offload_region()`` context manager.  All
    evaluations inside share intermediate residency (an intermediate forced
    by one ``asnumpy`` stays device-resident for the next expression), and
    every handle the scheduler pinned is released when the region closes —
    the multi-op handle-lifetime contract on :class:`HeroCluster`.
    """

    def __init__(
        self, name: Optional[str] = None, *, validate: bool = False
    ) -> None:
        self.name = name or f"hnp-graph-{next(_REGION_IDS)}"
        self.residency: Dict[int, Any] = {}   # node id -> DeviceHandle
        self.owned: set = set()               # handle names we pinned
        self.report = GraphReport(self.name)
        # validate=True (the reference's analysis.graph checks before
        # anything dispatches) waits for the port of analysis/
        self.validate = bool(validate)

    # -- residency ----------------------------------------------------------
    def handle_for(self, node: Node):
        """Valid residency handle for a node's value, if any (scheduler-owned
        intermediates, or user-pinned leaves via ``hnp.array(pin=True)``)."""
        h = self.residency.get(node.id)
        if h is None:
            h = node.attrs.get("handle")
        if h is not None and getattr(h, "valid", False):
            return h
        return None

    def pin(self, node: Node, device_id: int) -> None:
        from repro_torch.core.hero import engine

        h = engine().pin_handle(
            f"{self.name}:n{node.id}", node.nbytes, device_id=device_id
        )
        self.residency[node.id] = h
        self.owned.add(h.name)

    def prefetch(self, node: Node, device_id: int) -> None:
        """Stage an evaluated operand onto ``device_id`` ahead of its
        consumer (cross-wave DMA prefetch).  The copy is charged now — on
        the lane's DMA stream, under the current wave's compute — and the
        owned handle carries the residency credit the consumer's launch
        picks up."""
        from repro_torch.core.hero import engine

        h = engine().prefetch_stage(
            f"{self.name}:n{node.id}", node.nbytes, device_id=device_id
        )
        self.residency[node.id] = h
        self.owned.add(h.name)
        self.report.prefetched_bytes += node.nbytes

    def release(self) -> None:
        from repro_torch.core.hero import engine

        eng = engine()
        for name in sorted(self.owned):
            h = eng.handle(name)
            if h is not None:
                eng.release_handle(h)
        self.owned.clear()
        self.residency.clear()

    # -- context manager ------------------------------------------------------
    def __enter__(self) -> "GraphRegion":
        _REGION_STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _REGION_STACK.pop()
        self.release()


_REGION_STACK: List[GraphRegion] = []


def current_region() -> Optional[GraphRegion]:
    return _REGION_STACK[-1] if _REGION_STACK else None


# Public alias: ``with hnp.offload_region("step") as region: ...``
offload_region = GraphRegion


# ---------------------------------------------------------------------------
# Light-op lowering (elementwise / reductions / shape ops via torch)
# ---------------------------------------------------------------------------

def _tensor(v, like):
    """A Python scalar as a 0-d tensor beside ``like`` (0-d tensors do not
    widen a dimensioned operand's dtype, like the reference's weak
    scalars)."""
    if isinstance(like, torch.Tensor) and not isinstance(v, torch.Tensor):
        return torch.as_tensor(v, device=like.device)
    return v


def _binary_pair(vals):
    a, b = vals
    return _tensor(a, b), _tensor(b, a)


def _reduce(fn, x, attrs):
    axis = attrs.get("axis")
    dims = tuple(range(x.ndim)) if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    return fn(x, dim=dims, keepdim=bool(attrs.get("keepdims", False)))


_LIGHT = {
    "add": lambda a, v: v[0] + v[1],
    "sub": lambda a, v: v[0] - v[1],
    "mul": lambda a, v: v[0] * v[1],
    "div": lambda a, v: v[0] / v[1],
    "pow": lambda a, v: v[0] ** v[1],
    "maximum": lambda a, v: torch.maximum(*_binary_pair(v)),
    "minimum": lambda a, v: torch.minimum(*_binary_pair(v)),
    "neg": lambda a, v: -v[0],
    "abs": lambda a, v: torch.abs(v[0]),
    "tanh": lambda a, v: torch.tanh(v[0]),
    "exp": lambda a, v: torch.exp(v[0]),
    "sqrt": lambda a, v: torch.sqrt(v[0]),
    "relu": lambda a, v: torch.relu(v[0]),
    "silu": lambda a, v: F.silu(v[0]),
    # the reference's gelu is the tanh approximation
    "gelu": lambda a, v: F.gelu(v[0], approximate="tanh"),
    "sigmoid": lambda a, v: torch.sigmoid(v[0]),
    "sum": lambda a, v: _reduce(torch.sum, v[0], a),
    "mean": lambda a, v: _reduce(torch.mean, v[0], a),
    "max": lambda a, v: _reduce(torch.amax, v[0], a),
    "min": lambda a, v: _reduce(torch.amin, v[0], a),
    "reshape": lambda a, v: torch.reshape(v[0], a["shape"]),
    "transpose": lambda a, v: torch.permute(v[0], a["axes"]),
    "astype": lambda a, v: torch.as_tensor(v[0]).to(a["dtype"]),
}


def _lower_light(op: str, attrs: Dict[str, Any], vals: Sequence[Any]):
    fn = _LIGHT.get(op)
    if fn is None:
        raise NotImplementedError(f"no lowering for light op {op!r}")
    return fn(attrs, vals)


# ---------------------------------------------------------------------------
# Fusion analysis
# ---------------------------------------------------------------------------

def _fusion_chains(
    order: List[Node],
    consumers: Dict[int, List[Node]],
) -> Tuple[Dict[int, List[Node]], Dict[int, int]]:
    """Maximal single-consumer elementwise chains hanging off heavy nodes.

    A node fuses into its producer's launch when it is elementwise, it is the
    producer's only consumer in the forced subgraph, and every *other*
    operand is already available (a leaf or previously-evaluated node — the
    bias-add case).  Returns ``(chains, fused_into)``: per-head fused chain
    in application order, and a membership map.
    """
    chains: Dict[int, List[Node]] = {}
    fused_into: Dict[int, int] = {}
    for head in order:
        if not is_heavy(head.op):
            continue
        chain: List[Node] = []
        tail = head
        while True:
            cs = consumers.get(tail.id, [])
            if len(cs) != 1:
                break
            e = cs[0]
            if e.op not in ELEMENTWISE or e.id in fused_into:
                break
            side = [i for i in e.inputs if i is not tail]
            if any(not s.evaluated for s in side):
                break
            chain.append(e)
            fused_into[e.id] = head.id
            tail = e
        if chain:
            chains[head.id] = chain
    return chains, fused_into


def _apply_chain(head_value, chain: List[Node], prev: Node):
    """Run a fused elementwise chain on the producer's value, caching each
    link's value (shared-subgraph coherence)."""
    value = head_value
    tail = prev
    for e in chain:
        vals = [value if i is tail else i.value for i in e.inputs]
        value = _lower_light(e.op, e.attrs, vals)
        e.set_value(value)
        tail = e
    return value


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------

def _collect(roots: Sequence[Node]) -> List[Node]:
    """Postorder over the unevaluated subgraph reachable from ``roots``."""
    order: List[Node] = []
    seen = set()
    stack: List[Tuple[Node, bool]] = [(r, False) for r in reversed(roots)]
    while stack:
        node, expanded = stack.pop()
        if node.id in seen:
            continue
        if node.evaluated:
            seen.add(node.id)
            continue
        if expanded:
            seen.add(node.id)
            order.append(node)
            continue
        stack.append((node, True))
        for inp in node.inputs:
            if not inp.evaluated and inp.id not in seen:
                stack.append((inp, False))
    return order


def _freeze(v):
    """Hashable view of a node-attrs value (best effort: repr fallback)."""
    if isinstance(v, (tuple, list)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


def _eliminate(
    order: List[Node], roots: Sequence[Node]
) -> Tuple[List[Node], List[Tuple[Node, Node]], int]:
    """Common-subexpression + dead-node elimination before scheduling.

    Structurally identical nodes — same op, same (representative) inputs,
    same static params — collapse onto their first occurrence; consumers
    are rewired to the representative.  Nodes made unreachable from the
    forced roots by the collapse (the duplicate subtrees) are dropped from
    the schedule entirely.  Returns ``(live_order, aliases, eliminated)``;
    each alias ``(dup, rep)`` has its value copied from ``rep`` after the
    schedule runs, so outside references to the duplicate stay valid.
    Leaves are identity-keyed (two equal-shaped arrays are not assumed
    equal); evaluated nodes are already values and never collapse.
    """
    rep: Dict[int, Node] = {}
    by_val: Dict[int, Node] = {}   # evaluated-node unification by buffer id
    seen: Dict[Any, Node] = {}
    aliases: List[Tuple[Node, Node]] = []

    def rep_of(i: Node) -> Node:
        r = rep.get(i.id)
        if r is not None:
            return r
        if i.evaluated:
            # Leaves (and pre-forced nodes) unify on the underlying buffer:
            # the same array lifted twice is the same graph input.
            return by_val.setdefault(i.value_key(), i)
        return i

    for n in order:
        key = (
            n.op,
            tuple(rep_of(i).id for i in n.inputs),
            _freeze(n.attrs),
        )
        r = seen.get(key)
        if r is None:
            seen[key] = n
            rep[n.id] = n
        else:
            rep[n.id] = r
            aliases.append((n, r))
    if not aliases:
        return order, [], 0
    for n in order:
        n.inputs = tuple(rep_of(i) for i in n.inputs)
    # Dead-node elimination: only what the rewired roots still reach runs.
    live: set = set()
    stack = [rep.get(r.id, r) for r in roots]
    while stack:
        n = stack.pop()
        if n.id in live or n.evaluated:
            continue
        live.add(n.id)
        stack.extend(n.inputs)
    kept = [n for n in order if n.id in live]
    return kept, aliases, len(order) - len(kept)


def _array_inputs(node: Node) -> List[Node]:
    return [i for i in node.inputs if i.dtype is not None]


def _residency_split(node: Node, region: GraphRegion):
    """(resident_bytes, total_in_bytes, best_handle) over a node's operands."""
    resident = 0.0
    total = 0.0
    best = None
    best_bytes = -1.0
    for inp in _array_inputs(node):
        total += inp.nbytes
        h = region.handle_for(inp)
        if h is not None:
            resident += inp.nbytes
            if inp.nbytes > best_bytes:
                best, best_bytes = h, inp.nbytes
    return resident, total, best


def _migrate_inputs(node: Node, device_id: int, region: GraphRegion) -> None:
    """Bring scheduler-owned resident inputs to the consuming device.

    Charged as ``d2d_copy`` records on the destination's DMA stream — the
    modeled price of consuming an intermediate on a different lane than the
    one that produced it.  User-pinned leaves are never moved (their home is
    the user's contract); affinity scheduling is what keeps work near them.
    """
    from repro_torch.core.hero import engine

    for inp in _array_inputs(node):
        h = region.handle_for(inp)
        if (
            h is not None
            and h.device_id != device_id
            and h.name in region.owned
        ):
            engine().migrate_handle(h, device_id)


def _run_heavy(
    node: Node,
    chains: Dict[int, List[Node]],
    roots: set,
    region: GraphRegion,
) -> None:
    """Dispatch one heavy node (plus its fused chain) through the registry."""
    from repro_torch.core.dispatch import dispatch_placed

    chain = chains.get(node.id, [])
    tail = chain[-1] if chain else node
    vals = [i.value for i in node.inputs]
    resident_in, in_total, aff = _residency_split(node, region)
    out_nbytes = tail.nbytes
    keep_out = tail.id not in roots
    total = in_total + out_nbytes
    rf = ((resident_in + (out_nbytes if keep_out else 0.0)) / total
          if total > 0 else 0.0)

    args, kwargs = rebuild_call(node, vals)
    opname = node.op.split(":", 1)[1]
    value, launch = dispatch_placed(
        opname, *args, resident_fraction=rf, handle=aff, **kwargs
    )
    node.set_value(value)
    offloaded = launch.backend.startswith("device")
    if offloaded:
        _migrate_inputs(node, launch.device_id, region)
    final = _apply_chain(value, chain, node) if chain else value
    tail.set_value(final)
    if offloaded:
        # Forcing a root reads a *copy* back to host — the device buffer
        # stays valid for later consumers in the same region, so pin
        # unconditionally (rf already excluded the root's readback bytes).
        region.pin(tail, launch.device_id)
    region.report.launches.append(NodeReport(
        node_id=node.id,
        op=opname,
        backend=launch.backend,
        device_id=launch.device_id,
        resident_fraction=rf,
        staged_in_bytes=(in_total - resident_in) if offloaded else 0.0,
        readback_bytes=out_nbytes if (offloaded and not keep_out) else 0.0,
        fused=tuple(e.op for e in chain),
        batched=False,
    ))


def _batch_key(node: Node):
    """Stacking key for independent same-shape 2-D GEMMs (None = unbatchable)."""
    if node.op not in _BATCHABLE or len(node.inputs) != 2:
        return None
    if node.attrs["kw_inputs"]:
        return None
    if any(kind != "in" for kind, _ in node.attrs["template"]):
        return None
    if any(bool(v) for v in node.attrs["kwargs"].values()):
        return None  # transposes / tp_mode / explicit out_dtype opt out
    a, b = node.inputs
    if a.ndim != 2 or b.ndim != 2:
        return None
    return (a.shape, b.shape, str(a.dtype), str(b.dtype))


def _run_batched(
    members: List[Node],
    chains: Dict[int, List[Node]],
    roots: set,
    region: GraphRegion,
) -> None:
    """Stack N independent same-shape GEMMs into one gemm_batched launch."""
    from repro_torch.core.dispatch import dispatch_placed

    resident_in = in_total = out_total = keep_bytes = 0.0
    aff = None
    aff_bytes = -1.0
    tails = []
    splits = []
    for n in members:
        chain = chains.get(n.id, [])
        tail = chain[-1] if chain else n
        tails.append(tail)
        r, t, h = _residency_split(n, region)
        splits.append((r, t))
        resident_in += r
        in_total += t
        out_total += tail.nbytes
        if tail.id not in roots:
            keep_bytes += tail.nbytes
        if h is not None and h.nbytes > aff_bytes:
            aff, aff_bytes = h, h.nbytes
    total = in_total + out_total
    rf = (resident_in + keep_bytes) / total if total > 0 else 0.0

    # Stacked by copy, as the reference does (passing the members' batch
    # strides to the kernel instead is later work).
    a_stack = torch.stack([n.inputs[0].value for n in members])
    b_stack = torch.stack([n.inputs[1].value for n in members])
    out, launch = dispatch_placed(
        "gemm_batched", a_stack, b_stack, resident_fraction=rf, handle=aff
    )
    offloaded = launch.backend.startswith("device")
    for i, (n, tail) in enumerate(zip(members, tails)):
        chain = chains.get(n.id, [])
        value = out[i]
        n.set_value(value)
        if offloaded:
            _migrate_inputs(n, launch.device_id, region)
        final = _apply_chain(value, chain, n) if chain else value
        tail.set_value(final)
        keep = tail.id not in roots
        if offloaded:
            region.pin(tail, launch.device_id)
        r, t = splits[i]
        region.report.launches.append(NodeReport(
            node_id=n.id,
            op=n.op.split(":", 1)[1],
            backend=launch.backend,
            device_id=launch.device_id,
            resident_fraction=rf,
            staged_in_bytes=(t - r) if offloaded else 0.0,
            readback_bytes=tail.nbytes if (offloaded and not keep) else 0.0,
            fused=tuple(e.op for e in chain),
            batched=True,
        ))


def _run_light_node(node: Node, region: GraphRegion) -> None:
    """Evaluate a light node; inherit device residency when all its array
    operands already live on one device (the elementwise runs there, so its
    result does too — a free pin, no staging charged either way, matching
    the unmodeled torch elementwise ops of the eager path)."""
    vals = [i.value for i in node.inputs]
    value = _lower_light(node.op, node.attrs, vals)
    node.set_value(value)
    arrays = _array_inputs(node)
    if not arrays:
        return
    handles = [region.handle_for(i) for i in arrays]
    devs = {h.device_id for h in handles if h is not None}
    if len(devs) == 1 and all(h is not None for h in handles):
        region.pin(node, devs.pop())


def evaluate(root: Node):
    """Force one graph root: lower the whole captured subgraph onto the
    offload registry and return the root's value.

    Runs inside the ambient :class:`GraphRegion` if one is open (sharing
    residency and handle lifetimes with sibling evaluations), else under an
    ephemeral region whose intermediate handles are released on return.
    """
    return evaluate_many([root])[0]


def evaluate_many(roots: Sequence[Node]):
    """Force several graph roots in ONE scheduling pass.

    Independent roots surface in the same topological waves, so same-shape
    GEMMs *across* roots batch into one ``gemm_batched`` launch and shared
    subgraphs (post-CSE) run once — the multi-output form of
    :func:`evaluate` (``hnp.block_all``).
    """
    pending = [r for r in roots if not r.evaluated]
    if pending:
        from repro_torch.core import accounting

        region = current_region()
        ephemeral = region is None
        if ephemeral:
            region = GraphRegion()
        try:
            with accounting.graph_region(region.name):
                _schedule(pending, region)
        finally:
            if ephemeral:
                region.release()
    return [r.value for r in roots]


def _prefetch_next_wave(
    next_ids: List[int], by_id: Dict[int, Node], region: GraphRegion
) -> None:
    """Issue wave k+1's staging while wave k's compute is still in flight.

    For each heavy node in the upcoming wave that already has a device
    affinity (some operand resident on a lane), stage its *other* evaluated,
    unresident array operands onto that lane now.  The copies land on the
    DMA stream behind the current wave's launches — i.e. under compute —
    and the consumer's ``resident_fraction`` then credits them.  Opt-in via
    ``OffloadPolicy.prefetch_staging``.
    """
    from repro_torch.core.hero import engine

    eng = engine()
    pol = eng.policy
    if not pol.prefetch_staging or pol.mode == "host":
        return
    for nid in sorted(next_ids):
        n = by_id.get(nid)
        if n is None or n.evaluated or not is_heavy(n.op):
            continue
        dev = None
        for inp in _array_inputs(n):
            h = region.handle_for(inp)
            if h is not None:
                dev = h.device_id
                break
        if dev is None:
            continue  # no affinity yet — placement unknown, don't guess
        for inp in _array_inputs(n):
            if not inp.evaluated or inp.nbytes <= 0:
                continue  # in-flight intermediates ride residency threading
            if region.handle_for(inp) is not None:
                continue  # already device-resident
            region.prefetch(inp, dev)


def _schedule(roots: Sequence[Node], region: GraphRegion) -> None:
    if region.validate:
        raise NotImplementedError(
            "offload_region(validate=True) needs repro_torch.analysis, which "
            "is not ported yet")
    order = _collect(roots)
    if not order:
        return
    order, aliases, eliminated = _eliminate(order, roots)
    region.report.nodes_eliminated += eliminated
    in_graph = {n.id for n in order}
    consumers: Dict[int, List[Node]] = {}
    deps: Dict[int, int] = {}
    for n in order:
        cnt = 0
        for i in n.inputs:
            if i.id in in_graph and not i.evaluated:
                consumers.setdefault(i.id, []).append(n)
                cnt += 1
        deps[n.id] = cnt
    chains, fused_into = _fusion_chains(order, consumers)
    alias_of = {d.id: r for d, r in aliases}
    root_ids = {alias_of.get(r.id, r).id for r in roots}

    by_id = {n.id: n for n in order}
    ready = sorted(
        (nid for nid, c in deps.items() if c == 0), key=lambda i: i
    )
    done = set()

    def complete(n: Node, frontier: List[int]) -> None:
        done.add(n.id)
        for c in consumers.get(n.id, []):
            deps[c.id] -= 1
            if deps[c.id] == 0:
                frontier.append(c.id)

    tr = _obs.current_tracer()
    graph_span = None
    if tr is not None:
        graph_span = tr.begin(
            f"graph:{region.name}", cat="graph", lane="host",
            t0=_obs.modeled_now(),
            attrs={"nodes": len(order), "eliminated": eliminated,
                   "fused_chains": len(chains)},
        )
    wave_idx = 0
    while ready:
        wave = [by_id[i] for i in sorted(ready)]
        wave_span = None
        if tr is not None:
            wave_span = tr.begin(
                f"wave{wave_idx}", cat="graph", lane="host",
                t0=_obs.modeled_now(), attrs={"nodes": len(wave)},
            )
            wave_idx += 1
        ready = []
        # nodes fused into an earlier head arrive here already evaluated
        pending_heavy: List[Node] = []
        for n in wave:
            if n.evaluated:
                complete(n, ready)
            elif is_heavy(n.op):
                pending_heavy.append(n)
            else:
                _run_light_node(n, region)
                complete(n, ready)
        # batch same-shape independent GEMMs; dispatch the rest singly
        groups: Dict[Any, List[Node]] = {}
        singles: List[Node] = []
        for n in pending_heavy:
            key = _batch_key(n)
            if key is None:
                singles.append(n)
            else:
                groups.setdefault(key, []).append(n)
        for key, members in groups.items():
            if len(members) < 2:
                singles.extend(members)
        for n in sorted(singles, key=lambda n: n.id):
            if tr is not None and chains.get(n.id):
                tr.instant("fuse", cat="graph", lane="host",
                           t=_obs.modeled_now(),
                           attrs={"head": n.op,
                                  "fused": len(chains[n.id]) + 1})
            _run_heavy(n, chains, root_ids, region)
            complete(n, ready)
        for key, members in groups.items():
            if len(members) >= 2:
                members = sorted(members, key=lambda n: n.id)
                if tr is not None:
                    tr.instant("gemm-batch", cat="graph", lane="host",
                               t=_obs.modeled_now(),
                               attrs={"members": len(members)})
                _run_batched(members, chains, root_ids, region)
                for n in members:
                    complete(n, ready)
        # wave k just dispatched; `ready` is wave k+1 — issue its staging
        # now so the copies shingle under wave k's modeled compute
        if ready:
            _prefetch_next_wave(ready, by_id, region)
        if tr is not None:
            tr.end(wave_span, _obs.modeled_now())
    if tr is not None:
        tr.end(graph_span, _obs.modeled_now())

    leftover = [n for n in order if n.id not in done and not n.evaluated]
    if leftover:  # cycles cannot happen by construction; guard anyway
        raise RuntimeError(f"scheduler failed to evaluate nodes: {leftover}")
    # CSE aliases: outside references to a collapsed duplicate stay valid —
    # it carries its representative's value without ever launching.
    for dup, rep in aliases:
        if not dup.evaluated and rep.evaluated:
            dup.set_value(rep.value)
