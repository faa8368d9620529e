"""Logical-axis partitioning rules: param / optimizer / batch / cache trees
-> partition specs.

The twin of ``src/repro/sharding/partition.py``, its rules kept rule for
rule.  Parallelism map (mesh axes: optional ``pod`` × ``data`` ×
``model``):

  DP  — batch over (``pod``, ``data``).
  TP  — Megatron col→row: qkv/up projections column-sharded over ``model``,
        o/down projections row-sharded; vocab/lm-head sharded over ``model``.
  EP  — MoE expert dim over ``model``.
  SP  — long-context decode caches sequence-sharded (over ``model``, plus
        ``data`` when the batch can't use it).

Rules are name-keyed (leaf names are unique across the zoo) with a
divisibility guard: a dim is only sharded if the mesh axis divides it
(mamba2's 50280 vocab stays replicated).  A rule reads only ``shape`` and
``axis_names`` of the mesh (a :class:`~repro_torch.sharding.spmd.Mesh`, or
any object with both) and only ``shape`` of a leaf (meta tensors do).

**One leaf a layer.**  The port's parameter and optimizer trees hold one
leaf a layer (``stack/0/mixer/wq``: :mod:`repro_torch.tree`), where the
reference stacks the layers on a leading axis.  A leaf under ``stack``
takes the reference's spec of the stacked leaf — the rule run on the
shape ``(layers, *leaf.shape)`` — without its leading layer entry, so
every ``_guard`` and ``_apply_fsdp`` dim index sits one to the right of
the reference's.  Where the reference's FSDP rule shards the layer axis
itself over ``data`` (the first free dim that divides), the per-layer
leaf has no such dim and stays replicated over ``data``.  Caches keep the
layer axis in both packages, so their specs are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch.sharding.spmd import P

__all__ = [
    "NamedSharding",
    "param_pspecs",
    "batch_pspecs",
    "opt_pspecs",
    "cache_pspecs",
    "named",
    "dp_axes",
]


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _guard(mesh, dim: int, axes):
    """Shard ``dim`` over ``axes`` only if divisible; else replicate."""
    return axes if dim % _axis_size(mesh, axes) == 0 else None


# ---------------------------------------------------------------------------
# walking a tree with the reference's path keys
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(x, rule, path=(), layers=0):
    """``x`` with each leaf (an object with ``shape``) replaced by
    ``rule(path, shape)``.  ``path`` is a tuple of ``(kind, key)``, kind
    ``"dict"``, ``"attr"`` (a named tuple's field) or ``"seq"``, as the
    reference's ``DictKey`` / ``GetAttrKey`` / ``SequenceKey``.  Under a
    ``stack`` list a leaf's rule sees its stacked shape and its spec loses
    the leading layer entry."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _walk(v, rule, path + (("dict", k),), layers)
                for k, v in x.items()}
    if _is_namedtuple(x):
        return type(x)(*(_walk(v, rule, path + (("attr", f),), layers)
                         for f, v in zip(x._fields, x)))
    if isinstance(x, (list, tuple)):
        if path and path[-1] == ("dict", "stack") and isinstance(x, list):
            layers = len(x)
        return type(x)(_walk(v, rule, path + (("seq", i),), layers)
                       for i, v in enumerate(x))
    shape = tuple(x.shape)
    if layers:
        return P(*rule(path, (layers, *shape))[1:])
    return rule(path, shape)


def _path_leaf_name(path) -> str:
    for kind, key in reversed(path):
        if kind in ("dict", "attr"):
            return str(key)
    return ""


# ---------------------------------------------------------------------------
# parameter rules (matched on the final dict key of the path)
# ---------------------------------------------------------------------------

_FSDP_MIN_ELEMS = 1 << 20


def _apply_fsdp(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """ZeRO-3 style: also shard the first free, divisible dim over 'data'."""
    n = 1
    for d in shape:
        n *= d
    if n < _FSDP_MIN_ELEMS:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    dsz = mesh.shape["data"]
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and dim % dsz == 0 and dim >= dsz:
            entries[i] = "data"
            return P(*entries)
    return spec


def _param_rule(name: str, shape: Tuple[int, ...], mesh, fsdp: bool = False) -> P:
    nd = len(shape)
    m = "model"

    def spec(*tail):
        """Pad with leading Nones to the leaf's rank (stacked-layer axes)."""
        pad = (None,) * (nd - len(tail))
        out = P(*pad, *tail)
        return _apply_fsdp(out, shape, mesh) if fsdp else out

    if name == "embed":          # (V, D)
        out = P(_guard(mesh, shape[0], m), None)
        return _apply_fsdp(out, shape, mesh) if fsdp else out
    if name == "head":           # (D, V)
        out = P(None, _guard(mesh, shape[1], m))
        return _apply_fsdp(out, shape, mesh) if fsdp else out
    if name in ("we_gate", "we_up", "we_down"):
        # MoE expert weights (…, E, D, F): EP over the expert dim
        out = P(*((None,) * (nd - 3)), _guard(mesh, shape[-3], m), None, None)
        return _apply_fsdp(out, shape, mesh) if fsdp else out
    if name in ("wk", "wv", "bk", "bv"):
        # kv projections: replicated (fewer kv heads than the model axis;
        # the TP attention block wants whole kv heads per device).
        return spec(*((None,) * min(nd, 2)))
    if name in ("wq", "wz", "wx", "wdt", "w_gate", "w_up"):
        return spec(None, _guard(mesh, shape[-1], m))
    if name in ("bq", "b_up"):
        return spec(_guard(mesh, shape[-1], m))
    if name in ("wo", "w_down"):
        return spec(_guard(mesh, shape[-2], m), None)
    if name in ("b_down",):
        return spec(None)
    if name == "router":         # (…, D, E) — replicated
        return spec(None, None)
    if name in ("dt_bias", "a_log", "d_skip"):
        return spec(_guard(mesh, shape[-1], m))
    # conv weights, norms, biases, everything else: replicated
    return P(*((None,) * nd))


def param_pspecs(param_shapes, mesh, *, fsdp: bool = False):
    """A spec tree matching a params tree (tensors, meta tensors, or any
    leaves with ``shape``)."""

    def rule(path, shape):
        return _param_rule(_path_leaf_name(path), shape, mesh, fsdp=fsdp)

    return _walk(param_shapes, rule)


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------

def opt_pspecs(opt_shapes, mesh, *, fsdp: bool = False):
    """OptState: step replicated; mu/nu follow the param rules (QTensor
    int8 payloads keep the param spec; their scales are axis-aligned, so
    leading sharded dims coincide)."""

    def rule(path, shape):
        name = _path_leaf_name(path)
        if name == "step" or len(shape) == 0:
            return P()
        kind, key = path[-1]
        if (kind == "attr" and key in ("q", "scale")) or kind == "seq":
            name = _path_leaf_name(path[:-1])
        return _param_rule(name, shape, mesh, fsdp=fsdp)

    return _walk(opt_shapes, rule)


# ---------------------------------------------------------------------------
# batch / cache
# ---------------------------------------------------------------------------

def batch_pspecs(batch_shapes, mesh):
    dp = dp_axes(mesh)

    def rule(path, shape):
        name = _path_leaf_name(path)
        if name == "positions" and len(shape) == 3:  # (3, B, S)
            return P(None, _guard(mesh, shape[1], dp), None)
        if len(shape) >= 1:
            b_ax = _guard(mesh, shape[0], dp)
            return P(b_ax, *((None,) * (len(shape) - 1)))
        return P()

    return _walk(batch_shapes, rule)


def cache_pspecs(cache_shapes, mesh):
    """Decode caches. KV: (L, B, Hkv, S, hd) — batch over DP when divisible,
    sequence over ``model`` (SP), and over (``data``+``model``) when the
    batch is too small to use DP.  SSM state (L, B, H, N, P): heads over
    ``model``."""
    dp = dp_axes(mesh)

    def rule(path, shape):
        name = _path_leaf_name(path)
        if name in ("k", "v") and len(shape) == 5:
            b_ax = _guard(mesh, shape[1], dp)
            seq_axes = "model" if b_ax is not None else tuple(dp) + ("model",)
            return P(None, b_ax, None, _guard(mesh, shape[3], seq_axes), None)
        if name == "ssm" and len(shape) >= 5:
            # (L, [sub,] B, H, N, P): batch over DP, heads over model
            nd = len(shape)
            out = [None] * nd
            h_idx, b_idx = nd - 3, nd - 4
            out[b_idx] = _guard(mesh, shape[b_idx], dp)
            out[h_idx] = _guard(mesh, shape[h_idx], "model")
            return P(*out)
        return P(*((None,) * len(shape)))

    return _walk(cache_shapes, rule)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P


def named(mesh, pspec_tree):
    """Each spec of ``pspec_tree`` as a :class:`NamedSharding` on ``mesh``."""
    if isinstance(pspec_tree, P):
        return NamedSharding(mesh, pspec_tree)
    if isinstance(pspec_tree, dict):
        return {k: named(mesh, v) for k, v in pspec_tree.items()}
    if _is_namedtuple(pspec_tree):
        return type(pspec_tree)(*(named(mesh, v) for v in pspec_tree))
    if isinstance(pspec_tree, (list, tuple)):
        return type(pspec_tree)(named(mesh, v) for v in pspec_tree)
    return pspec_tree
