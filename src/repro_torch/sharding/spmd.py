"""A device mesh emulated on one torch device: specs, ``shard_map`` and the
collectives its bodies call.

The reference runs its tensor-, expert- and pipeline-parallel bodies with
``jax.shard_map`` over a ``jax.sharding.Mesh`` and exchanges data with the
``lax`` collectives.  This module stands in for all three on one device
(one card, or the CPU), so those bodies carry over statement for
statement; it has no twin in the reference, as
:mod:`repro_torch.kernels.autograd` has none.

* :class:`P` is a partition spec: one entry a dimension, ``None``, an axis
  name or a tuple of names, normalized as the reference's
  ``PartitionSpec`` is (a one-name tuple is the name, an empty one
  ``None``), so the two compare element for element.
* :class:`Mesh` holds the axis names, ``shape`` (a dict, as the sharding
  rules read it) and the one ``torch.device`` on which every mesh
  device's shard lives; ``with mesh:`` makes it the ambient mesh of the
  calling thread.  Mesh devices are numbered row-major over the axes.
* :func:`shard_map` splits each input by its spec (a split is a view:
  ``narrow`` along each sharded dimension; a replicated input is the same
  tensor on every shard), runs the body once per mesh device and
  assembles the outputs by their specs (``torch.cat`` over the sharded
  dimensions; a replicated output is mesh device 0's of its group).
* :func:`psum`, :func:`pmean`, :func:`pmax`, :func:`all_gather`,
  :func:`ppermute`, :func:`all_to_all`, :func:`axis_index` and
  :func:`axis_size` are called from a body.  Each is exact: a sum or max
  is taken in device order along the axis by ordinary torch ops, so every
  run gives the same bits.

Mechanism.  Each mesh device's body runs on a thread of its own, one of
``mesh.size`` threads the mesh starts at its first call and reuses
afterwards (daemon threads; :meth:`Mesh.close` stops them).  The threads
run one at a time, in device order, and hand a baton round the ring: a
body runs until its next collective, leaves its operand and passes the
baton on; the last device computes the collective for every group and
passes the baton back to device 0.  So

* autograd sees one graph across all shards: a collective is torch ops on
  the gathered operands, and its backward is theirs (the transpose of
  ``ppermute`` is the reverse copy, of ``psum`` the broadcast), with no
  collective of its own;
* no two bodies ever run at once: the kernels' launch counters, the
  module-level policy and trace stacks of :mod:`repro_torch.core` and the
  records a body's dispatches write see one thread at a time, in device
  order; on the card every launch goes to the calling thread's stream;
* each body runs under the caller's grad mode, inference mode, torch
  dispatch modes (a ``TorchDispatchMode`` is thread-local: a counter the
  caller entered sees every body's ops and each collective's) and, on the
  card, the caller's current stream.

A body must call the same collectives in the same order on every device
(SPMD), and must not enter a policy or trace context that stays open
across a collective.  A body that raises aborts the call: the other
bodies stop at their next collective and :func:`shard_map` re-raises the
first error.  A body runs with no ambient mesh (its axes are manual), so
the descriptors it reaches take no plan of their own, and it may not call
:func:`shard_map` itself.

Each mesh counts every collective's calls and operand bytes per mesh
device (:attr:`Mesh.collectives`) and its result bytes
(:attr:`Mesh.collective_results`: an all-gather's result is its group's
size times its operand).  While the last device computes a collective,
:func:`computing_collective` names it, so a counter can tell the
collective's math from the body's.  On one card a collective is a copy
inside one memory: it says nothing of a wire between chips.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch import tree

__all__ = ["Mesh", "P", "all_gather", "all_to_all", "ambient_mesh",
           "axis_index", "axis_size", "computing_collective",
           "current_shard", "pmax", "pmean", "ppermute", "psum",
           "shard_map"]


def _norm_entry(entry):
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry
    names = tuple(entry)
    if not all(isinstance(a, str) for a in names):
        raise TypeError(f"P: a spec entry is None, an axis name or a tuple "
                        f"of names, not {entry!r}")
    if not names:
        return None
    return names[0] if len(names) == 1 else names


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("data", "model"),)``.
    Entries past the spec's length are ``None`` (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_norm_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


_LOCAL = threading.local()     # .meshes (ambient stack), .shard (in a body),
                               # .collective (while computing one)


def ambient_mesh() -> Optional["Mesh"]:
    """The calling thread's innermost ``with mesh:``, or None (also inside
    a ``shard_map`` body, whose axes are manual)."""
    meshes = getattr(_LOCAL, "meshes", None)
    return meshes[-1] if meshes else None


def current_shard() -> Optional[int]:
    """The mesh device whose body the calling thread runs, or None."""
    ctx = getattr(_LOCAL, "shard", None)
    return None if ctx is None else ctx[2]


def computing_collective() -> Optional[str]:
    """The collective the calling thread is computing for its mesh (the
    last device's thread, between the bodies' turns), or None."""
    return getattr(_LOCAL, "collective", None)


class _Aborted(BaseException):
    """Unwinds a body whose call another body aborted (a BaseException, so
    a body's ``except Exception`` does not swallow it)."""


class Mesh:
    """``shape`` (a sequence of ints) over ``axis_names``, every mesh
    device's shard on ``device`` (default: the CPU)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None):
        shape = tuple(int(n) for n in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
            raise ValueError(f"Mesh: shape {shape} against axes {axis_names}")
        if any(n < 1 for n in shape):
            raise ValueError(f"Mesh: axis sizes must be >= 1, got {shape}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.device = torch.device(device if device is not None else "cpu")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._coords = [self._unravel(i) for i in range(self.size)]
        self.collectives: Dict[str, Dict[str, List[int]]] = {}
        self.collective_results: Dict[str, List[int]] = {}
        self.shard_map_calls = 0
        self._pool: Optional[_Pool] = None
        self._group_cache: Dict[Any, List[List[int]]] = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, device={self.device}, "
                f"{self.size} emulated devices)")

    # ---- geometry ----------------------------------------------------------
    def _unravel(self, i: int) -> Dict[str, int]:
        coords = {}
        for a in reversed(self.axis_names):
            coords[a] = i % self.shape[a]
            i //= self.shape[a]
        return coords

    def axes_size(self, entry) -> int:
        """Devices along a spec entry (an axis, a tuple of axes, None)."""
        out = 1
        for a in _axes(entry):
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in mesh axes "
                                 f"{self.axis_names}")
            out *= self.shape[a]
        return out

    def _index(self, dev: int, entry) -> int:
        """Row-major position of ``dev`` along the entry's axes."""
        idx = 0
        for a in _axes(entry):
            idx = idx * self.shape[a] + self._coords[dev][a]
        return idx

    def _groups(self, axis) -> List[List[int]]:
        """The devices that meet in a collective over ``axis``: one list a
        group, each in its position order along ``axis``."""
        if axis in self._group_cache:
            return self._group_cache[axis]
        names = _axes(axis)
        self.axes_size(axis)
        groups: Dict[tuple, list] = {}
        for dev in range(self.size):
            key = tuple(self._coords[dev][a] for a in self.axis_names
                        if a not in names)
            groups.setdefault(key, []).append(dev)
        out = [sorted(g, key=lambda d: self._index(d, names))
               for g in groups.values()]
        self._group_cache[axis] = out
        return out

    # ---- ambient mesh ------------------------------------------------------
    def __enter__(self) -> "Mesh":
        if getattr(_LOCAL, "meshes", None) is None:
            _LOCAL.meshes = []
        _LOCAL.meshes.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _LOCAL.meshes.pop()

    # ---- books ---------------------------------------------------------------
    def _count(self, kind: str, devs, nbytes, rbytes) -> None:
        book = self.collectives.setdefault(
            kind, {"calls": [0] * self.size, "bytes": [0] * self.size})
        res = self.collective_results.setdefault(kind, [0] * self.size)
        for dev, nb, rb in zip(devs, nbytes, rbytes):
            book["calls"][dev] += 1
            book["bytes"][dev] += int(nb)
            res[dev] += int(rb)

    def reset_collectives(self) -> None:
        self.collectives = {}
        self.collective_results = {}
        self.shard_map_calls = 0

    def collective_totals(self) -> Dict[str, Dict[str, int]]:
        """Each collective's calls and operand bytes summed over devices."""
        return {k: {"calls": sum(v["calls"]), "bytes": sum(v["bytes"])}
                for k, v in self.collectives.items()}

    # ---- threads -------------------------------------------------------------
    def _run(self, fn: Callable, local_args: List[tuple]) -> List[Any]:
        if self._pool is None:
            self._pool = _Pool(self.size)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        call = _Call(self, fn, local_args, torch.is_grad_enabled(),
                     torch.is_inference_mode_enabled(), stream,
                     _get_current_dispatch_mode_stack())
        return self._pool.run(call)

    def close(self) -> None:
        """Stop the mesh's threads (they are daemons: exit never waits)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None


class _Call:
    """One ``shard_map`` call's rendezvous state; guarded by the pool's
    lock, except what the baton's holder alone touches."""

    def __init__(self, mesh, fn, local_args, grad, inference, stream, modes):
        n = mesh.size
        self.mesh, self.fn, self.local_args = mesh, fn, local_args
        self.grad, self.inference, self.stream = grad, inference, stream
        self.modes = modes                      # the caller's, outermost first
        self.turn = 0
        self.slots: List[Any] = [None] * n      # the meeting's operands
        self.results: List[Any] = [None] * n    # the last meeting's results
        self.outputs: List[Any] = [None] * n
        self.error: Optional[BaseException] = None
        self.released = 0


class _Pool:
    """``n`` worker threads, worker i running mesh device i's body."""

    def __init__(self, n: int):
        self.n = n
        self.lock = threading.Lock()
        self.conds = [threading.Condition(self.lock) for _ in range(n)]
        self.main = threading.Condition(self.lock)
        self.calls: List[Optional[_Call]] = [None] * n
        self.stop = False
        self.threads = [threading.Thread(target=self._loop, args=(i,),
                                         name=f"spmd-{i}", daemon=True)
                        for i in range(n)]
        for t in self.threads:
            t.start()

    # -- held under self.lock --
    def _give(self, call: _Call, dev: int) -> None:
        call.turn = dev
        self.conds[dev].notify()

    def _abort(self, call: _Call, err: BaseException) -> None:
        if call.error is None:
            call.error = err
        for c in self.conds:
            c.notify_all()

    def _release(self, call: _Call, dev: int) -> None:
        self.calls[dev] = None
        call.released += 1
        if call.released == self.n:
            self.main.notify()

    # -- main thread --
    def run(self, call: _Call) -> List[Any]:
        with self.lock:
            if self.stop:
                raise RuntimeError("shard_map on a closed mesh")
            if any(c is not None for c in self.calls):
                raise RuntimeError("shard_map: the mesh is running another "
                                   "call")
            self.calls = [call] * self.n
            self._give(call, 0)
            while call.released < self.n:
                self.main.wait()
        if call.error is not None:
            raise call.error
        return call.outputs

    def close(self) -> None:
        with self.lock:
            self.stop = True
            for c in self.conds:
                c.notify_all()
        for t in self.threads:
            t.join(timeout=10)

    # -- worker threads --
    def _loop(self, dev: int) -> None:
        while True:
            with self.lock:
                while not self.stop and (
                        self.calls[dev] is None
                        or (self.calls[dev].turn != dev
                            and self.calls[dev].error is None)):
                    self.conds[dev].wait()
                if self.stop:
                    return
                call = self.calls[dev]
                if call.error is not None:      # aborted before it started
                    self._release(call, dev)
                    continue
            self._shard(call, dev)

    def _shard(self, call: _Call, dev: int) -> None:
        _LOCAL.shard = (self, call, dev)
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.set_grad_enabled(call.grad))
                if call.inference:
                    stack.enter_context(torch.inference_mode())
                if call.stream is not None:
                    stack.enter_context(torch.cuda.stream(call.stream))
                for mode in call.modes:
                    stack.enter_context(mode)
                out = call.fn(*call.local_args[dev])
            self.meet(call, dev, "end", out, None)
        except _Aborted:
            pass
        except BaseException as err:            # noqa: BLE001 - re-raised by run
            with self.lock:
                self._abort(call, err)
        finally:
            _LOCAL.shard = None
            with self.lock:
                self._release(call, dev)

    def meet(self, call: _Call, dev: int, kind: str, payload, spec):
        """Leave this device's operand at the current meeting and pass the
        baton; the last device computes the meeting.  Returns this
        device's result (nothing for the closing ``"end"``)."""
        last = dev == self.n - 1
        with self.lock:
            if call.error is not None:
                raise _Aborted
            call.slots[dev] = (kind, spec, payload)
            if not last:
                self._give(call, dev + 1)
        if last:
            _LOCAL.collective = kind
            try:
                results = _compute(call)
            except BaseException as err:        # noqa: BLE001 - re-raised by run
                with self.lock:
                    self._abort(call, err)
                raise _Aborted from None
            finally:
                _LOCAL.collective = None
            with self.lock:
                if kind == "end":
                    call.outputs = results
                    return None
                call.results = results
                self._give(call, 0)
        if kind == "end":
            return None
        with self.lock:
            while call.turn != dev and call.error is None:
                self.conds[dev].wait()
            if call.error is not None:
                raise _Aborted
            return call.results[dev]


def _compute(call: _Call) -> List[Any]:
    """The meeting every device has reached: the bodies' outputs (``end``)
    or one collective's results, one a device."""
    mesh = call.mesh
    kinds = {(s[0], s[1]) for s in call.slots}
    if len(kinds) != 1:
        raise RuntimeError(
            f"shard_map: the mesh devices disagree on their next collective: "
            f"{sorted(map(str, kinds))}")
    (kind, spec), = kinds
    payloads = [s[2] for s in call.slots]
    if kind == "end":
        return payloads
    axis, extra = spec
    out: List[Any] = [None] * mesh.size
    for group in mesh._groups(axis):
        vals = [payloads[d] for d in group]
        res = _COLLECTIVES[kind](vals, *extra)
        mesh._count(kind, group, [_nbytes(v) for v in vals],
                    [_nbytes(r) for r in res])
        for d, r in zip(group, res):
            out[d] = r
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the collectives' math over one group's operands, in position order
# ---------------------------------------------------------------------------

def _c_psum(vals):
    tot = functools.reduce(lambda a, b: a + b, vals)
    return [tot] * len(vals)


def _c_pmax(vals):
    top = functools.reduce(torch.maximum, vals)
    return [top] * len(vals)


def _c_all_gather(vals, dim):
    full = torch.cat(vals, dim=dim)
    return [full] * len(vals)


def _c_ppermute(vals, perm):
    out = [None] * len(vals)
    for src, dst in perm:
        out[dst] = vals[src]
    return [v if v is not None else torch.zeros_like(vals[i])
            for i, v in enumerate(out)]


def _c_all_to_all(vals, split_axis, concat_axis):
    return [torch.stack([v.select(split_axis, j) for v in vals],
                        dim=concat_axis) for j in range(len(vals))]


_COLLECTIVES = {"psum": _c_psum, "pmax": _c_pmax,
                "all_gather": _c_all_gather, "ppermute": _c_ppermute,
                "all_to_all": _c_all_to_all}


# ---------------------------------------------------------------------------
# the body's API
# ---------------------------------------------------------------------------

def _shard_ctx():
    ctx = getattr(_LOCAL, "shard", None)
    if ctx is None:
        raise RuntimeError("a collective runs only inside a shard_map body")
    return ctx


def _collective(kind: str, x, axis, *extra):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{kind} takes a tensor, got {type(x).__name__}")
    pool, call, dev = _shard_ctx()
    return pool.meet(call, dev, kind, x, (_norm_entry(axis), extra))


def axis_index(axis) -> int:
    """This mesh device's position along ``axis`` (a name or a tuple)."""
    _, call, dev = _shard_ctx()
    return call.mesh._index(dev, _norm_entry(axis))


def axis_size(axis) -> int:
    _, call, _ = _shard_ctx()
    return call.mesh.axes_size(_norm_entry(axis))


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over ``axis``, added in position order, in x's dtype."""
    return _collective("psum", x, axis)


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    return psum(x, axis) / axis_size(axis)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    return _collective("pmax", x, axis)


def all_gather(x: torch.Tensor, axis, *, dim: int = 0) -> torch.Tensor:
    """Every position's ``x`` concatenated along ``dim`` in position order:
    ``lax.all_gather(x, axis, axis=dim, tiled=True)``, the form the
    reference's bodies call."""
    return _collective("all_gather", x, axis, dim % x.ndim)


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    """Position ``dst`` receives ``src``'s x for each ``(src, dst)`` of
    ``perm``; a position no pair names receives zeros."""
    n = axis_size(axis)
    perm = tuple((int(s), int(d)) for s, d in perm)
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts) or not all(
            0 <= i < n for pair in perm for i in pair):
        raise ValueError(f"ppermute: bad permutation {perm} over {n}")
    return _collective("ppermute", x, axis, perm)


def all_to_all(x: torch.Tensor, axis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all`` (untiled): ``split_axis`` has the group's size;
    position j receives index j along it from every position, stacked in
    position order on a new ``concat_axis``."""
    n = axis_size(axis)
    if x.shape[split_axis] != n:
        raise ValueError(f"all_to_all: split dim {x.shape[split_axis]} "
                         f"over {n} devices")
    return _collective("all_to_all", x, axis, split_axis, concat_axis)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, P)


def _pairs(spec, value, what: str):
    """``(spec, leaf)`` for every leaf of ``value``, ``spec`` a P for the
    whole subtree (a prefix, as the reference's specs are) or a container
    of the value's structure."""
    if _is_spec(spec):
        return [(spec, leaf) for leaf in tree.leaves(value)]
    if isinstance(spec, dict) and isinstance(value, dict) \
            and sorted(spec) == sorted(value):
        return [pair for k in sorted(value)
                for pair in _pairs(spec[k], value[k], what)]
    if isinstance(spec, (list, tuple)) and isinstance(value, (list, tuple)) \
            and len(spec) == len(value):
        return [pair for s, v in zip(spec, value)
                for pair in _pairs(s, v, what)]
    raise ValueError(f"shard_map: {what} spec {spec!r} does not match the "
                     f"structure of {type(value).__name__}")


def _split(mesh: Mesh, spec: P, x, dev: int):
    if not isinstance(x, torch.Tensor):
        if any(spec):
            raise TypeError(f"shard_map: cannot split a "
                            f"{type(x).__name__} by {spec!r}")
        return x
    if len(spec) > x.ndim:
        raise ValueError(f"shard_map: spec {spec!r} for a rank-{x.ndim} "
                         f"operand")
    for dim, entry in enumerate(spec):
        n = mesh.axes_size(entry)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"shard_map: dim {dim} of {tuple(x.shape)} "
                             f"does not split {n} ways ({spec!r})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh._index(dev, entry) * size, size)
    return x


def _assemble(mesh: Mesh, spec: P, outs: List[Any]):
    sharded = [(dim, e) for dim, e in enumerate(spec)
               if e is not None and mesh.axes_size(e) > 1]
    if not sharded:
        return outs[0]
    if not isinstance(outs[0], torch.Tensor) or len(spec) > outs[0].ndim:
        raise ValueError(f"shard_map: out spec {spec!r} for "
                         f"{type(outs[0]).__name__}")
    named = {a for _, e in sharded for a in _axes(e)}
    blocks = {}
    for dev in range(mesh.size):
        if any(mesh._coords[dev][a] for a in mesh.axis_names
               if a not in named):
            continue                      # a replica of another device's
        blocks[tuple(mesh._index(dev, e) for _, e in sharded)] = outs[dev]

    def build(key, level):
        if level == len(sharded):
            return blocks[key]
        dim, entry = sharded[level]
        return torch.cat([build(key + (j,), level + 1)
                          for j in range(mesh.axes_size(entry))], dim=dim)

    return build((), 0)


def shard_map(fn: Callable, *, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``fn`` run once per mesh device on its shards of the inputs, the
    outputs assembled by ``out_specs``; ``in_specs`` has one entry per
    positional argument, each a P or a container of the argument's
    structure."""
    if not isinstance(in_specs, (tuple, list)) or _is_spec(in_specs):
        raise TypeError("shard_map: in_specs is a tuple, one entry an "
                        "argument")

    @functools.wraps(fn)
    def run(*args):
        if getattr(_LOCAL, "shard", None) is not None:
            raise RuntimeError("shard_map inside a shard_map body")
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map: {len(args)} arguments for "
                            f"{len(in_specs)} in_specs")
        flat = [_pairs(s, a, "in") for s, a in zip(in_specs, args)]
        for pairs in flat:
            for _, leaf in pairs:
                if isinstance(leaf, torch.Tensor) and \
                        leaf.device != mesh.device:
                    raise ValueError(f"shard_map: an operand on "
                                     f"{leaf.device}, the mesh on "
                                     f"{mesh.device}")
        local = [tuple(tree.unflatten(a, (_split(mesh, s, x, dev)
                                          for s, x in pairs))
                       for a, pairs in zip(args, flat))
                 for dev in range(mesh.size)]
        mesh.shard_map_calls += 1
        outs = mesh._run(fn, local)
        per_dev = [_pairs(out_specs, o, "out") for o in outs]
        values = [_assemble(mesh, spec, [p[i][1] for p in per_dev])
                  for i, (spec, _) in enumerate(per_dev[0])]
        return tree.unflatten(outs[0], values)

    return run
