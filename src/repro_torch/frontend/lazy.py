"""Lazy expression graph behind ``repro_torch.hnp``.

The paper's value proposition is *transparency*: a plain NumPy program gets
accelerated because the library underneath makes the offload decisions.
This module is the capture half of that story — array operations build an
expression graph of :class:`Node` s instead of executing, so the scheduler
(:mod:`repro_torch.frontend.schedule`) can lower the *whole* computation
onto the offload registry: fuse elementwise epilogues into their producer,
batch independent GEMMs, and keep device-resident intermediates on device.

Node kinds:

* ``leaf``             — a concrete tensor (or Python scalar) fed into the
                         graph by :func:`repro_torch.hnp.array` / operator
                         lifting;
* ``registry:<op>``    — a *heavy* node lowered through the declarative op
                         registry (``core/dispatch.py``); any registered
                         ``OffloadOp`` appears in ``hnp`` for free;
* elementwise / reduction / shape nodes — light ops executed with torch
                         during evaluation; single-consumer elementwise
                         chains are fused into their producer's lowering.

Where the reference infers a registry node's output with
``jax.eval_shape`` over the op's host lowering, this module runs the host
lowering on ``device="meta"`` tensors: shapes and dtypes propagate, no
data is read or computed.  A host lowering therefore reads shapes, never
values (``int`` slot bounds of ``decode_attention`` are Python ints, and a
tensor bound stays a tensor).

Leaves live on a device.  A numpy operand becomes a tensor on the device
of the graph it joins, or, for a graph's first leaf, on the card unless
``hnp.array(x, device="cpu")`` says otherwise.  Nothing stays on the host
silently.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import tensor_from_numpy

__all__ = [
    "ELEMENTWISE",
    "ELEMENTWISE_BINARY",
    "ELEMENTWISE_UNARY",
    "LazyArray",
    "Node",
    "REDUCTIONS",
    "SHAPE_OPS",
    "is_heavy",
    "leaf",
    "lift",
    "registry_node",
    "to_numpy",
    "torch_dtype",
]

_IDS = itertools.count()

ELEMENTWISE_UNARY = frozenset({
    "tanh", "exp", "sqrt", "abs", "neg", "relu", "silu", "gelu", "sigmoid",
})
ELEMENTWISE_BINARY = frozenset({
    "add", "sub", "mul", "div", "maximum", "minimum", "pow",
})
ELEMENTWISE = ELEMENTWISE_UNARY | ELEMENTWISE_BINARY
REDUCTIONS = frozenset({"sum", "mean", "max", "min"})
SHAPE_OPS = frozenset({"reshape", "transpose", "astype"})

_UNSET = object()


def is_heavy(op: str) -> bool:
    """Heavy nodes lower through the offload registry (one dispatch each)."""
    return op.startswith("registry:")


# ---------------------------------------------------------------------------
# Devices and dtypes
# ---------------------------------------------------------------------------

DEFAULT_DEVICE = "cuda"


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"hnp: device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"hnp: no torch dtype for {dtype!r}")
    return dt


def _result_dtype(*dtypes) -> torch.dtype:
    """Promotion over the array operands (Python scalars are weak: they
    never widen an array dtype).  Torch's rule; for float32 / bfloat16
    operands it gives the reference's ``jnp.result_type``, elsewhere the
    two can differ (see ROADMAP Queue 3)."""
    dts = [d for d in dtypes if d is not None]
    if not dts:
        return torch.float32
    out = dts[0]
    for d in dts[1:]:
        out = torch.promote_types(out, d)
    return out


def to_numpy(value) -> np.ndarray:
    """A host numpy copy of a tensor value.  numpy has no bfloat16, so a
    bf16 tensor comes back as float32 values (exact: every bf16 value is a
    float32); the reference returns an ``ml_dtypes`` bfloat16 array."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


class Node:
    """One vertex of the expression graph.

    ``attrs`` holds the static (non-array) part of the call.  For registry
    nodes it carries a call template so the scheduler can rebuild the exact
    positional/keyword signature around the evaluated inputs.  ``value``
    caches the evaluated result so shared subgraphs execute once.
    ``source`` keeps the numpy array a leaf was made from: the same array
    lifted twice is the same graph input (CSE keys leaves on it).
    """

    __slots__ = ("id", "op", "inputs", "attrs", "shape", "dtype", "device",
                 "source", "_value")

    def __init__(
        self,
        op: str,
        inputs: Sequence["Node"],
        attrs: Optional[Dict[str, Any]],
        shape: Tuple[int, ...],
        dtype,
        device: Optional[torch.device] = None,
    ) -> None:
        self.id = next(_IDS)
        self.op = op
        self.inputs = tuple(inputs)
        self.attrs = attrs or {}
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        if device is None:
            device = next((i.device for i in self.inputs
                           if i.device is not None), None)
        self.device = device
        self.source = None
        self._value = _UNSET

    # ---- cached evaluation ------------------------------------------------
    @property
    def evaluated(self) -> bool:
        return self._value is not _UNSET

    @property
    def value(self):
        if self._value is _UNSET:
            raise RuntimeError(f"node {self.id} ({self.op}) not evaluated")
        return self._value

    def set_value(self, v) -> None:
        self._value = v

    def value_key(self) -> int:
        """Identity of an evaluated node's buffer (CSE unification)."""
        return id(self.source if self.source is not None else self._value)

    # ---- derived ----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> float:
        if self.dtype is None:
            return 0.0
        return float(self.size) * self.dtype.itemsize

    def __repr__(self) -> str:
        return (
            f"Node(id={self.id}, op={self.op!r}, shape={self.shape}, "
            f"dtype={self.dtype})"
        )


def _is_array(x) -> bool:
    return isinstance(x, (LazyArray, Node, torch.Tensor)) or (
        hasattr(x, "shape") and hasattr(x, "dtype"))


def _graph_device(nodes: Sequence[Node]) -> Optional[torch.device]:
    return next((n.device for n in nodes if n.device is not None), None)


def leaf(x, dtype=None, *, device=None) -> Node:
    """Wrap a concrete tensor, numpy array or Python scalar as a graph input.

    A tensor keeps its device unless ``device`` is given; a numpy array
    goes to ``device``, else to the card."""
    if isinstance(x, LazyArray):
        return x.node
    if isinstance(x, Node):
        return x
    if isinstance(x, (bool, int, float, complex)):
        n = Node("leaf", (), {"weak": True}, (), None)
        n.set_value(x)
        return n
    source = None
    if not isinstance(x, torch.Tensor):
        source = x
        x = tensor_from_numpy(x).to(_resolve(
            device if device is not None else DEFAULT_DEVICE))
    elif device is not None:
        x = x.to(_resolve(device))
    if dtype is not None and x.dtype != torch_dtype(dtype):
        x = x.to(torch_dtype(dtype))
    n = Node("leaf", (), {}, tuple(x.shape), x.dtype, device=x.device)
    n.source = source
    n.set_value(x)
    return n


def lift(x, *, near: Sequence[Node] = ()) -> Node:
    """A graph node for ``x``; a numpy operand lands on the device of the
    graph nodes it joins (``near``)."""
    if isinstance(x, (LazyArray, Node, bool, int, float, complex)):
        return leaf(x)
    dev = _graph_device(near)
    if isinstance(x, torch.Tensor) and (dev is None or x.device == dev):
        return leaf(x)
    return leaf(x, device=dev)


# ---------------------------------------------------------------------------
# Node constructors
# ---------------------------------------------------------------------------

def _elementwise_unary(op: str, x: Node) -> Node:
    return Node(op, (x,), {}, x.shape, x.dtype)


def _elementwise_binary(op: str, a: Node, b: Node) -> Node:
    shape = np.broadcast_shapes(a.shape, b.shape)
    dtype = _result_dtype(a.dtype, b.dtype)
    return Node(op, (a, b), {}, shape, dtype)


def _graph_nodes(values) -> list:
    """The graph nodes among ``values`` (lazy arrays and nodes)."""
    return [v.node if isinstance(v, LazyArray) else v
            for v in values if isinstance(v, (LazyArray, Node))]


def _binary_nodes(a, b) -> Tuple[Node, Node]:
    """Lift two operands, each numpy one onto the other's device."""
    near = _graph_nodes((a, b))
    return lift(a, near=near), lift(b, near=near)


def _reduction(op: str, x: Node, axis=None, keepdims: bool = False) -> Node:
    if axis is None:
        axes = tuple(range(x.ndim))
    else:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        axes = tuple(a % x.ndim for a in axes)
    if keepdims:
        shape = tuple(1 if i in axes else d for i, d in enumerate(x.shape))
    else:
        shape = tuple(d for i, d in enumerate(x.shape) if i not in axes)
    return Node(op, (x,), {"axis": axis, "keepdims": keepdims}, shape, x.dtype)


def _meta(node: Node):
    """Stand-in for abstract evaluation: a meta tensor of the node's spec,
    or a weak scalar's own value."""
    if node.dtype is None:
        return node.value
    return torch.empty(node.shape, dtype=node.dtype, device="meta")


def registry_node(opname: str, args: Sequence[Any], kwargs: Dict[str, Any]) -> Node:
    """Build a heavy node for one registered ``OffloadOp``.

    Array-like operands (lazy or concrete) become graph inputs; everything
    else stays static in the call template.  Shape/dtype are inferred by
    running the op's host lowering on meta tensors, so every registered op
    — present and future — gets graph capture without frontend changes:
    *register once, appear in ``hnp`` for free*.
    """
    import repro_torch.core.blas  # noqa: F401 — populate the registry
    from repro_torch.core.dispatch import get_op

    op = get_op(opname)  # raises KeyError for unknown ops, eagerly

    lazy = _graph_nodes((*args, *kwargs.values()))
    inputs = []
    template = []  # per positional slot: ("in", input_index) | ("static", v)
    kw_inputs = {}  # kw name -> input index
    static_kwargs = {}
    for a in args:
        if _is_array(a):
            template.append(("in", len(inputs)))
            inputs.append(lift(a, near=lazy))
        else:
            template.append(("static", a))
    for k, v in kwargs.items():
        if _is_array(v):
            kw_inputs[k] = len(inputs)
            inputs.append(lift(v, near=lazy))
        else:
            static_kwargs[k] = v

    def _rebuild(vals):
        pos = [vals[idx] if kind == "in" else idx for kind, idx in template]
        kw = dict(static_kwargs)
        for k, idx in kw_inputs.items():
            kw[k] = vals[idx]
        return pos, kw

    pos, kw = _rebuild([_meta(n) for n in inputs])
    out = op.host(*pos, **kw)
    if not isinstance(out, torch.Tensor):
        raise TypeError(
            f"registry op {opname!r} host lowering returned a non-tensor; "
            "cannot capture it in an hnp graph"
        )
    attrs = {
        "name": opname,
        "template": tuple(template),
        "kw_inputs": dict(kw_inputs),
        "kwargs": dict(static_kwargs),
    }
    return Node(f"registry:{opname}", inputs, attrs, tuple(out.shape),
                out.dtype)


def rebuild_call(node: Node, values: Sequence[Any]):
    """Reconstruct (args, kwargs) of a registry node around input values."""
    pos = [
        values[idx] if kind == "in" else idx
        for kind, idx in node.attrs["template"]
    ]
    kw = dict(node.attrs["kwargs"])
    for k, idx in node.attrs["kw_inputs"].items():
        kw[k] = values[idx]
    return pos, kw


# ---------------------------------------------------------------------------
# LazyArray — the user-facing ndarray stand-in
# ---------------------------------------------------------------------------

class LazyArray:
    """NumPy-like array whose operations build an expression graph.

    Nothing executes until the array is forced — ``hnp.asnumpy(x)``,
    ``x.block()``, ``np.asarray(x)`` or ``float(x)`` — at which point the
    scheduler lowers the whole captured graph onto the offload registry.
    """

    __slots__ = ("node",)

    # win over np.ndarray in mixed binary ops (ndarray op LazyArray)
    __array_priority__ = 1000

    def __init__(self, node: Node) -> None:
        self.node = node

    # ---- metadata ---------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.node.shape

    @property
    def dtype(self):
        return self.node.dtype

    @property
    def device(self):
        return self.node.device

    @property
    def ndim(self) -> int:
        return self.node.ndim

    @property
    def size(self) -> int:
        return self.node.size

    @property
    def nbytes(self) -> float:
        return self.node.nbytes

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of unsized LazyArray")
        return self.shape[0]

    def __repr__(self) -> str:
        state = "evaluated" if self.node.evaluated else "lazy"
        return (
            f"LazyArray(shape={self.shape}, dtype={self.dtype}, "
            f"op={self.node.op!r}, {state})"
        )

    # ---- forcing ----------------------------------------------------------
    def block(self) -> "LazyArray":
        """Force evaluation of the captured graph (result cached)."""
        from repro_torch.frontend import schedule

        schedule.evaluate(self.node)
        return self

    def __array__(self, dtype=None, copy=None):
        out = to_numpy(self.block().node.value)
        return out.astype(dtype) if dtype is not None else out

    def __float__(self) -> float:
        return float(np.asarray(self))

    def __int__(self) -> int:
        return int(np.asarray(self))

    def __bool__(self) -> bool:
        return bool(np.asarray(self))

    # ---- graph-building operators -----------------------------------------
    def _binary(self, op: str, other, reflected: bool = False) -> "LazyArray":
        a, b = _binary_nodes(self, other)
        if reflected:
            a, b = b, a
        return LazyArray(_elementwise_binary(op, a, b))

    def __add__(self, o):
        return self._binary("add", o)

    def __radd__(self, o):
        return self._binary("add", o, reflected=True)

    def __sub__(self, o):
        return self._binary("sub", o)

    def __rsub__(self, o):
        return self._binary("sub", o, reflected=True)

    def __mul__(self, o):
        return self._binary("mul", o)

    def __rmul__(self, o):
        return self._binary("mul", o, reflected=True)

    def __truediv__(self, o):
        return self._binary("div", o)

    def __rtruediv__(self, o):
        return self._binary("div", o, reflected=True)

    def __pow__(self, o):
        return self._binary("pow", o)

    def __neg__(self):
        return LazyArray(_elementwise_unary("neg", self.node))

    def __abs__(self):
        return LazyArray(_elementwise_unary("abs", self.node))

    def __matmul__(self, other) -> "LazyArray":
        return LazyArray(registry_node("matmul", (self, other), {}))

    def __rmatmul__(self, other) -> "LazyArray":
        return LazyArray(registry_node("matmul", (other, self), {}))

    # ---- shape ops ---------------------------------------------------------
    def reshape(self, *shape) -> "LazyArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        n = self.size
        shape = tuple(int(d) for d in shape)
        if -1 in shape:
            rest = 1
            for d in shape:
                if d != -1:
                    rest *= d
            shape = tuple(n // rest if d == -1 else d for d in shape)
        node = Node(
            "reshape", (self.node,), {"shape": shape}, shape, self.dtype
        )
        return LazyArray(node)

    def transpose(self, *axes) -> "LazyArray":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        if not axes:
            axes = tuple(reversed(range(self.ndim)))
        shape = tuple(self.shape[a] for a in axes)
        node = Node(
            "transpose", (self.node,), {"axes": tuple(axes)}, shape,
            self.dtype
        )
        return LazyArray(node)

    @property
    def T(self) -> "LazyArray":
        return self.transpose()

    def astype(self, dtype) -> "LazyArray":
        dt = torch_dtype(dtype)
        node = Node("astype", (self.node,), {"dtype": dt}, self.shape, dt)
        return LazyArray(node)

    # ---- reductions --------------------------------------------------------
    def sum(self, axis=None, keepdims: bool = False) -> "LazyArray":
        return LazyArray(_reduction("sum", self.node, axis, keepdims))

    def mean(self, axis=None, keepdims: bool = False) -> "LazyArray":
        return LazyArray(_reduction("mean", self.node, axis, keepdims))

    def max(self, axis=None, keepdims: bool = False) -> "LazyArray":
        return LazyArray(_reduction("max", self.node, axis, keepdims))

    def min(self, axis=None, keepdims: bool = False) -> "LazyArray":
        return LazyArray(_reduction("min", self.node, axis, keepdims))
