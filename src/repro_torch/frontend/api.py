"""``repro_torch.hnp`` — a lazy NumPy-like namespace over the offload
registry.

The paper's user story, reproduced at graph granularity: write plain
array code, and the library underneath decides what runs where ::

    import repro_torch.hnp as hnp

    x = hnp.array(x_np)           # a leaf on the card (device="cpu" to stay)
    h = hnp.tanh(x @ w1)          # nothing executes yet
    y = hnp.linear(h, w2, bias)   # ... the graph just grows
    out = hnp.asnumpy(y)          # whole graph lowers onto the cluster

Operations build a lazy expression graph (:mod:`repro_torch.frontend.lazy`);
the scheduler (:mod:`repro_torch.frontend.schedule`) lowers it onto
``dispatch()`` —
fusing elementwise epilogues, batching independent GEMMs and keeping
device-resident intermediates on device.

**Seam contract**: any op registered in :mod:`repro_torch.core.dispatch`
appears here for free — ``hnp.gemm``, ``hnp.attention``, ``hnp.syrk`` ...
are generated from the registry via module ``__getattr__``, with
shape/dtype inferred from the op's host lowering run on meta tensors.
Registering a new ``OffloadOp`` is the *only* step to make it
graph-capturable.

Leaves land on the card unless ``device="cpu"`` is given; :func:`asnumpy`
returns a host copy, with bf16
results as float32 values (numpy has no bfloat16).  The offload seam is
loaded on first use, not at import.
"""

from __future__ import annotations

import builtins
from typing import Optional

import numpy as np

from repro_torch.frontend.lazy import (
    LazyArray,
    leaf,
    lift,
    registry_node,
    to_numpy,
)
from repro_torch.frontend.lazy import (
    _binary_nodes,
    _elementwise_binary,
    _elementwise_unary,
)
from repro_torch.frontend.schedule import (
    GraphRegion,
    GraphReport,
    NodeReport,
    current_region,
    evaluate,
    evaluate_many,
    offload_region,
)

__all__ = [
    "GraphRegion",
    "GraphReport",
    "LazyArray",
    "NodeReport",
    "abs",
    "add",
    "array",
    "asarray",
    "asnumpy",
    "block",
    "block_all",
    "current_region",
    "divide",
    "exp",
    "gelu",
    "linear",
    "matmul",
    "max",
    "maximum",
    "mean",
    "min",
    "minimum",
    "multiply",
    "offload_region",
    "power",
    "registry_ops",
    "relu",
    "sigmoid",
    "silu",
    "sqrt",
    "subtract",
    "sum",
    "tanh",
]


# ---------------------------------------------------------------------------
# Array construction / forcing
# ---------------------------------------------------------------------------

def array(obj, dtype=None, *, pin: bool = False, device=None) -> LazyArray:
    """Wrap a concrete array (numpy or torch) as a graph leaf.

    A numpy array lands on ``device`` (default: the card); a tensor stays
    where it is unless ``device`` is given.  Asking for the card where there is none raises.

    ``pin=True`` homes the buffer on a (modeled) device up front (weights
    that many graph nodes will consume): the scheduler credits it as
    resident in every launch that touches it and placement-affine
    scheduling is drawn to it.
    """
    if isinstance(obj, LazyArray):
        return obj.astype(dtype) if dtype is not None else obj
    node = leaf(obj, dtype=dtype, device=device)
    if pin and node.dtype is not None:
        from repro_torch.core.hero import engine

        node.attrs["handle"] = engine().pin_handle(
            f"hnp-leaf-{node.id}", node.nbytes
        )
    return LazyArray(node)


def asarray(obj, dtype=None, *, device=None) -> LazyArray:
    return array(obj, dtype=dtype, device=device)


def asnumpy(x) -> np.ndarray:
    """Force evaluation (lower the captured graph) and return a host numpy
    array (bf16 as float32 values).

    ``LazyArray.__array__`` does the forcing, so plain ``np.asarray`` covers
    lazy and concrete inputs alike."""
    if isinstance(x, LazyArray):
        return np.asarray(x)
    return to_numpy(x)


def block(x: LazyArray) -> LazyArray:
    """Force evaluation of a lazy array in place (returns it)."""
    if isinstance(x, LazyArray):
        return x.block()
    return x


def block_all(*arrays):
    """Force several lazy arrays in ONE scheduling pass (returns them).

    Independent expressions surface in the same topological waves, so
    same-shape GEMMs *across* the forced roots batch into a single
    ``gemm_batched`` launch and CSE-shared subgraphs run once — this is how
    the graph model forward forces a block's independent projections
    together."""
    evaluate_many([a.node for a in arrays if isinstance(a, LazyArray)])
    return arrays


# ---------------------------------------------------------------------------
# Linear algebra sugar (everything heavy goes through the registry)
# ---------------------------------------------------------------------------

def matmul(a, b, *, out_dtype=None) -> LazyArray:
    return LazyArray(registry_node("matmul", (a, b), {"out_dtype": out_dtype}))


def linear(x, w, b=None, *, out_dtype=None) -> LazyArray:
    """y = x @ w (+ b).  The bias add is an elementwise consumer of the
    matmul, so the scheduler fuses it into the GEMM launch."""
    y = matmul(x, w, out_dtype=out_dtype)
    if b is not None:
        y = y + (b if isinstance(b, LazyArray)
                 else LazyArray(lift(b, near=[y.node])))
    return y


# ---------------------------------------------------------------------------
# Elementwise / reductions
# ---------------------------------------------------------------------------

def _unary(op):
    def fn(x) -> LazyArray:
        return LazyArray(_elementwise_unary(op, lift(x)))

    fn.__name__ = op
    fn.__doc__ = f"Lazy elementwise {op} (fusible into its producer)."
    return fn


def _binary(op):
    def fn(a, b) -> LazyArray:
        return LazyArray(_elementwise_binary(op, *_binary_nodes(a, b)))

    fn.__name__ = op
    fn.__doc__ = f"Lazy elementwise {op} (fusible into its producer)."
    return fn


tanh = _unary("tanh")
exp = _unary("exp")
sqrt = _unary("sqrt")
abs = _unary("abs")  # noqa: A001 — numpy-style namespace shadows builtins
relu = _unary("relu")
silu = _unary("silu")
gelu = _unary("gelu")
sigmoid = _unary("sigmoid")

add = _binary("add")
subtract = _binary("sub")
multiply = _binary("mul")
divide = _binary("div")
maximum = _binary("maximum")
minimum = _binary("minimum")
power = _binary("pow")


def _reduction(op):
    def fn(x, axis=None, keepdims: bool = False) -> LazyArray:
        return getattr(array(x), op)(axis=axis, keepdims=keepdims)

    fn.__name__ = op
    fn.__doc__ = f"Lazy {op} reduction."
    return fn


sum = _reduction("sum")  # noqa: A001 — numpy-style namespace shadows builtins
mean = _reduction("mean")
max = _reduction("max")  # noqa: A001
min = _reduction("min")  # noqa: A001


# ---------------------------------------------------------------------------
# Registry passthrough: every registered OffloadOp appears in hnp for free
# ---------------------------------------------------------------------------

def registry_ops() -> tuple:
    """Names of the registered ops reachable through this namespace."""
    import repro_torch.core.blas  # noqa: F401 — populate the registry
    from repro_torch.core.dispatch import registered_ops

    return registered_ops()


def __getattr__(name: str):
    """PEP-562 fallback: resolve unknown attributes against the op registry.

    ``hnp.<op>(*args, **kwargs)`` builds a heavy graph node for any
    registered :class:`~repro_torch.core.dispatch.OffloadOp` — new descriptors
    appear here with zero frontend changes.
    """
    if name.startswith("_"):
        raise AttributeError(name)
    try:
        ops = registry_ops()
    except Exception as e:  # pragma: no cover — registry import failure
        raise AttributeError(f"{name} (registry unavailable: {e})") from None
    if name not in ops:
        raise AttributeError(
            f"module 'repro_torch.hnp' has no attribute {name!r} "
            f"(registered ops: {', '.join(builtins.sorted(ops))})"
        )

    def op_fn(*args, **kwargs) -> LazyArray:
        return LazyArray(registry_node(name, args, kwargs))

    op_fn.__name__ = name
    op_fn.__qualname__ = name
    op_fn.__doc__ = (
        f"Lazy graph capture of registered offload op {name!r} "
        "(see repro_torch.core.dispatch)."
    )
    globals()[name] = op_fn  # cache for subsequent lookups
    return op_fn
