"""Declarative offload-op registry — one dispatch path for every BLAS op.

The paper's architecture is a *single* stable seam (OpenBLAS behind
``#pragma omp target``) where all offload decisions live.  Before this
module, each op in ``repro_torch.core.blas`` hand-rolled the same ritual —
score the call, ask the engine for a backend, branch to a lowering,
record the trace — and the copies had drifted (some dropped the device
placement, some never could reach a kernel).  Here the ritual exists once:

* an :class:`OffloadOp` *describes* an op — how to cost it, how to lower
  it as plain torch (the host and plain device path), how to lower it
  through the hand-written CUDA kernels, when the kernel form is legal,
  and whether the op is host-only (the paper compiles ``syrk.c`` for the
  host alone);
* :func:`register` puts the descriptor in the process-wide table;
* :func:`dispatch` is the engine: it resolves routing (explicit-TP plan
  -> kernel -> host) *before* recording, threads the chosen ``device_id``
  into every trace record via :meth:`HeroCluster.launch`, and runs the
  winning lowering.

Adding an op to the seam is now declarative: write its lowerings, build
an ``OffloadOp``, ``register`` it — no new dispatch code.  Callers that
hold a :class:`~repro_torch.core.hero.DeviceHandle` (a device-residency token,
e.g. a pinned KV cache) pass it through ``dispatch(..., handle=...)`` so
placement-affine schedulers route the work to the data.

Shape keys and record dtypes use the reference's dtype names
(``float32``, not ``torch.float32``) so traces compare one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.cost_model import OpCost
from repro_torch.core.hero import DeviceHandle, engine
from repro_torch.obs import spans as _spans

__all__ = [
    "DeviceHandle",
    "OffloadOp",
    "dispatch",
    "dispatch_placed",
    "dtype_name",
    "get_op",
    "register",
    "registered_ops",
]


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the reference's dtype spelling."""
    return str(dtype).removeprefix("torch.")


def shape_key(*arrs) -> str:
    """Canonical static-shape signature of the operands (ledger key)."""
    return ";".join(
        "x".join(map(str, a.shape)) + f":{dtype_name(a.dtype)}" for a in arrs
    )


@dataclasses.dataclass(frozen=True)
class OffloadOp:
    """Descriptor for one op behind the offload seam.

    ``cost``, ``eligible`` and ``plan`` see the op's full call signature
    (``(*args, **kwargs)``) and must be pure shape-level functions — they
    never read tensor data.  ``cost`` also owns operand validation, so a
    bad call fails before anything is scheduled or recorded.

    host       — plain torch lowering on the operands' own device; also
                 serves the plain "device" backend (residency/accounting
                 distinction, same math).
    kernel     — hand-written CUDA kernel lowering.  None => op never
                 takes the kernel path.
    eligible   — shape/dtype legality gate for ``kernel``.
    plan       — optional pre-route inspection (explicit tensor-parallel
                 applicability); a non-None plan wins over the kernel and
                 is lowered by ``plan_lower(plan, *args, **kwargs)``.
    host_only  — never offloaded (recorded with the host backend).

    Graph capture (:mod:`repro_torch.frontend.lazy`) runs ``host`` on meta
    tensors to learn an op's output, so a host lowering reads shapes and
    dtypes, never values.
    """

    name: str
    cost: Callable[..., OpCost]
    host: Callable[..., Any]
    kernel: Optional[Callable[..., Any]] = None
    eligible: Optional[Callable[..., bool]] = None
    plan: Optional[Callable[..., Any]] = None
    plan_lower: Optional[Callable[..., Any]] = None
    host_only: bool = False
    note: str = ""


_REGISTRY: Dict[str, OffloadOp] = {}


def _descriptor_sig(op: OffloadOp) -> tuple:
    """Source-level identity of a descriptor (stable across module reloads,
    where re-executed ``def``s produce fresh function objects)."""

    def fsig(f):
        if f is None:
            return None
        # module + qualname alone would collapse all module-level lambdas to
        # ('<mod>', '<lambda>'); the code location keeps *different* lambdas
        # distinct while staying stable across importlib reloads (re-executed
        # defs keep their file and line).
        code = getattr(f, "__code__", None)
        loc = (code.co_filename, code.co_firstlineno) if code else None
        return (
            getattr(f, "__module__", None),
            getattr(f, "__qualname__", None),
            loc,
        )

    return (
        op.name, op.host_only, op.note,
        fsig(op.cost), fsig(op.host), fsig(op.kernel),
        fsig(op.eligible), fsig(op.plan), fsig(op.plan_lower),
    )


def register(op: OffloadOp) -> OffloadOp:
    """Add a descriptor to the op table.

    Idempotent for the same descriptor, including across ``importlib``
    reloads of the defining module (functions are compared by
    module + qualname, not object identity); registering a *different*
    descriptor under a taken name raises.
    """
    prev = _REGISTRY.get(op.name)
    if (
        prev is not None
        and prev != op
        and _descriptor_sig(prev) != _descriptor_sig(op)
    ):
        raise ValueError(f"op {op.name!r} already registered")
    _REGISTRY[op.name] = op
    return op


def get_op(name: str) -> OffloadOp:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown offload op {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def registered_ops() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def dispatch(
    name: str,
    *args,
    handle: Optional[DeviceHandle] = None,
    resident_fraction: Optional[float] = None,
    validate: bool = False,
    **kwargs,
):
    """Route one registered op through the offload seam and execute it.

    The single cost -> plan -> launch -> lower path every op shares:

    1. ``op.cost(*args, **kwargs)`` validates operands and scores the call;
    2. ``op.plan`` (if any) resolves special routing *before* the record is
       written — the trace must name the path that actually runs;
    3. ``engine().launch`` picks backend + device, records the
       :class:`~repro_torch.core.accounting.OffloadRecord` (always carrying
       the placement) and queues the modeled ticket;
    4. the winning lowering runs: plan > kernel > host.
    """
    out, _ = dispatch_placed(
        name, *args, handle=handle, resident_fraction=resident_fraction,
        validate=validate, **kwargs,
    )
    return out


def dispatch_placed(
    name: str,
    *args,
    handle: Optional[DeviceHandle] = None,
    resident_fraction: Optional[float] = None,
    validate: bool = False,
    placement: Optional[Any] = None,
    **kwargs,
):
    """Graph-aware dispatch entry: like :func:`dispatch`, but returns
    ``(result, launch)`` where ``launch`` is the
    :class:`~repro_torch.core.hero.LaunchResult` naming the backend and
    device the call landed on.

    The ``hnp`` graph scheduler lowers whole expression graphs through this
    entry: it threads the exact per-node ``resident_fraction`` and reads the
    placement back, so the produced intermediate is pinned where it lives
    and its consumers are routed (or d2d-migrated) to the data.

    ``placement`` (an
    :class:`~repro_torch.core.placement.ExpertDispatchPlan`) fans the
    accounting out into one pre-placed sub-launch per expert copy
    (:meth:`~repro_torch.core.hero.HeroCluster.launch_fanout`) under this
    one dispatch; the lowering is the unplaced call's — the kernel when the
    policy enables it and the op is eligible — so the placed result equals
    the unplaced one bit for bit.  ``validate=True`` (the reference's
    pre-dispatch graph checks) raises ``NotImplementedError``: it waits
    for the port of ``analysis/``.
    """
    if validate:
        raise NotImplementedError(
            "dispatch(validate=True) needs repro_torch.analysis, which is "
            "not ported yet"
        )
    tr = _spans.current_tracer()
    if tr is None:
        return _dispatch_impl(name, args, kwargs, handle, resident_fraction,
                              None, placement)
    with tr.span(f"dispatch:{name}", cat="dispatch", lane="host"):
        return _dispatch_impl(name, args, kwargs, handle, resident_fraction,
                              tr, placement)


def _dispatch_impl(
    name: str,
    args: tuple,
    kwargs: dict,
    handle: Optional[DeviceHandle],
    resident_fraction: Optional[float],
    tr: Optional["_spans.SpanTracer"],
    placement: Optional[Any] = None,
):
    """The cost -> plan -> launch -> lower pipeline, with optional phase
    markers (``tr`` is the active tracer or None — never looked up here,
    so the traced and untraced paths run the same code)."""
    op = get_op(name)
    cost = op.cost(*args, **kwargs)
    if tr is not None:
        tr.instant("cost", cat="dispatch", lane="host",
                   t=_spans.modeled_now(),
                   attrs={"op": name, "flops": cost.flops,
                          "staged_bytes": cost.staged_bytes})
    arrays = [a for a in args if hasattr(a, "shape") and hasattr(a, "dtype")]
    # Array-valued keyword operands (fused biases, masks) are part of the
    # call's static signature too — key the ledger on them, in name order.
    arrays += [
        v for _, v in sorted(kwargs.items())
        if hasattr(v, "shape") and hasattr(v, "dtype")
    ]
    plan = None
    if op.plan is not None:
        plan = op.plan(*args, **kwargs)
    eligible = (
        plan is None
        and op.kernel is not None
        and not op.host_only
        and (op.eligible is None or bool(op.eligible(*args, **kwargs)))
    )
    if tr is not None:
        tr.instant("plan", cat="dispatch", lane="host",
                   t=_spans.modeled_now(),
                   attrs={"op": name, "planned": plan is not None,
                          "kernel_eligible": eligible})
    fanout = (
        placement is not None
        and getattr(placement, "sub_launches", ())
        and not op.host_only
        and engine().policy.mode != "host"
    )
    if fanout:
        # Per-expert sub-launch fan-out under this one dispatch: the plan
        # pre-placed each expert's token block on its handle's lane;
        # accounting fans out, the lowering below stays the unplaced one.
        launch = engine().launch_fanout(
            placement.sub_launches,
            dtype=dtype_name(arrays[0].dtype) if arrays else "",
            note=f"expert-placed:{name}",
            kernel_eligible=eligible,
        )
    else:
        launch = engine().launch(
            cost,
            dtype=dtype_name(arrays[0].dtype) if arrays else "",
            shape_key=shape_key(*arrays),
            kernel_eligible=eligible,
            force_host=op.host_only,
            note="tp-plan" if plan is not None else op.note,
            handle=handle,
            resident_fraction=resident_fraction,
        )
    if tr is not None:
        tr.instant("launch", cat="dispatch", lane="host",
                   t=_spans.modeled_now(),
                   attrs={"op": name, "backend": str(launch),
                          "device_id": launch.device_id},
                   device_id=launch.device_id)
    if plan is not None:
        out = op.plan_lower(plan, *args, **kwargs)
        lowering = "plan"
    elif launch.backend == "device-kernel":
        out = op.kernel(*args, **kwargs)
        lowering = "kernel"
    else:
        out = op.host(*args, **kwargs)
        lowering = "host"
    if tr is not None:
        tr.instant("lower", cat="dispatch", lane="host",
                   t=_spans.modeled_now(),
                   attrs={"op": name, "lowering": lowering})
    return out, launch
