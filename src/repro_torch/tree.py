"""Nested containers of tensors ("trees"), walked in the reference's order.

The reference flattens its parameter and optimizer pytrees with
``jax.tree_util``: dicts in sorted key order, lists and tuples in order,
named tuples by field, ``None`` an empty subtree.  The port keeps its
params as plain dicts and lists of tensors and walks them in that same
order, so a global gradient norm sums its leaves in the reference's order
and a checkpoint names each leaf by its path (``"stack/0/mixer/wq"``).
Every other object is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["leaves", "leaves_with_paths", "tree_map", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x) -> List[Tuple[str, Any]]:
    """(path key, child) of a container node in walk order; [] for a leaf
    or ``None``."""
    if isinstance(x, dict):
        return [(str(k), x[k]) for k in sorted(x)]
    if _is_namedtuple(x):
        return list(zip(x._fields, x))
    if isinstance(x, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(x)]
    return []


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def leaves_with_paths(tree, is_leaf: Callable[[Any], bool] = None,
                      prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in walk order; ``is_leaf`` stops the walk at a
    node (the 8-bit optimizer's quantized moments)."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        yield prefix, tree
        return
    for key, child in _children(tree):
        yield from leaves_with_paths(child, is_leaf,
                                     f"{prefix}/{key}" if prefix else key)


def leaves(tree, is_leaf: Callable[[Any], bool] = None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf)]


_END = object()


def unflatten(template, values, is_leaf: Callable[[Any], bool] = None):
    """``template``'s structure with its leaves replaced, in walk order, by
    ``values`` (any iterable, consumed exactly)."""
    it = iter(values)

    def build(x):
        if (is_leaf is not None and is_leaf(x)) or not _is_node(x):
            return next(it)
        if x is None:
            return None
        if isinstance(x, dict):
            rebuilt = {k: build(x[k]) for k in sorted(x)}
            return {k: rebuilt[k] for k in x}     # the template's key order
        items = [build(v) for v in x]
        if _is_namedtuple(x):
            return type(x)(*items)
        return type(x)(items)

    out = build(template)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more values than the template has leaves")
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure)."""
    flat = [leaves(t, is_leaf) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError(f"tree_map: trees with {[len(f) for f in flat]} leaves")
    return unflatten(tree, (fn(*xs) for xs in zip(*flat)), is_leaf)
