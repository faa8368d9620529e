"""The program's own ranges in a traced run, for the readers of
``metrics/`` and for the breakdown of the step's idle time.

The program opens ``record_function`` ranges named ``<kind>:<name>``
(``repro_torch.obs.spans.measured``) while the profiler records: one
``step:prefill`` a call of the prefill step, ``layer:<attn|mamba>`` a
block, ``glue:rope`` around RoPE, ``dispatch:<op>`` a call of the offload
seam, ``lower:<kernel|host|plan>`` its lowering, and
``kernel:<module>.<route>`` a kernel wrapper's card path once its route is
known: the operand checks, the output, the plan, the launch and its count.  They lie in :attr:`portbench.trace.Trace.host_ranges`
beside the harness's phases, torch's ``aten::`` ops and the CUDA runtime's
calls, on one clock with the device's operations.

A trace without a ``step:prefill`` range (a program that opens none) gives
every reader here nothing to read: they return None.

Run as a program, it prints the split of the step's idle time that
``PERF.md`` quotes, from a traced run of a cell (``portbench/run.py``'s
arguments; the run's own result line comes first) or from a trace that
such a run kept with ``--save``::

    python3 -m portbench.spans --workload yi-6b.prefill-4k --seed 7 \\
        --seconds 40 --save trace.json.gz
    python3 -m portbench.spans --load trace.json.gz
"""

from __future__ import annotations

import argparse
import gzip
import heapq
import json
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["KINDS", "SYNCS", "STEP", "host_syncs", "idle_by_range",
           "innermost", "per_step", "program_ranges", "report",
           "step_ranges", "time_under"]

Span = Tuple[str, float, float]

KINDS = ("step", "layer", "glue", "dispatch", "lower", "kernel")
STEP = "step:prefill"
# CUDA runtime calls that hold the host until the card catches up.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def program_ranges(ranges: Iterable[Span],
                   kinds: Sequence[str] = KINDS) -> List[Span]:
    """The ranges named ``<kind>:...`` for one of ``kinds``."""
    prefixes = tuple(f"{k}:" for k in kinds)
    return [r for r in ranges if r[0].startswith(prefixes)]


def step_ranges(trace) -> List[Span]:
    """The trace's ``step:prefill`` ranges, by start (none without a
    trace)."""
    if trace is None:
        return []
    return sorted((r for r in trace.host_ranges if r[0] == STEP),
                  key=lambda r: r[1])


def innermost(ranges: Iterable[Span]) -> List[Span]:
    """Disjoint pieces ``(name, start, end)``, by start, of the time some
    range is open, each named by the innermost range open there: the one
    that opened last (of two that open together, the shorter)."""
    ranges = sorted(ranges, key=lambda r: r[1])
    edges = sorted({t for _, s, e in ranges for t in (s, e)})
    # A heap of (-start, end, name): its top is the range opened last.
    heap: List[Tuple[float, float, str]] = []
    out: List[Span] = []
    i = 0
    for t0, t1 in zip(edges, edges[1:]):
        while i < len(ranges) and ranges[i][1] <= t0:
            name, s, e = ranges[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        # A closed range under an open one waits until it reaches the top.
        while heap and heap[0][1] <= t0:
            heapq.heappop(heap)
        if not heap:
            continue
        name = heap[0][2]
        if out and out[-1][0] == name and out[-1][2] == t0:
            out[-1] = (name, out[-1][1], t1)
        else:
            out.append((name, t0, t1))
    return out


def _overlap(pieces: Sequence[Tuple[float, float]],
             windows: Sequence[Tuple[float, float]]
             ) -> List[Tuple[int, float, float]]:
    """``(i, start, end)`` for each overlap of ``pieces[i]`` with a window;
    both sorted by start, each disjoint."""
    out, j = [], 0
    for i, (s, e) in enumerate(pieces):
        while j < len(windows) and windows[j][1] <= s:
            j += 1
        k = j
        while k < len(windows) and windows[k][0] < e:
            lo, hi = max(s, windows[k][0]), min(e, windows[k][1])
            if hi > lo:
                out.append((i, lo, hi))
            k += 1
    return out


def per_step(trace, value_of) -> Optional[float]:
    """``value_of(steps)`` over the number of ``step:prefill`` ranges: a
    value a traced forward; None where the trace has no such range."""
    steps = step_ranges(trace)
    if not steps:
        return None
    return value_of(steps) / len(steps)


def time_under(trace, kind: str) -> Optional[float]:
    """Host ms a traced forward, inside ``step:prefill``, in which the
    innermost open range among ``dispatch:``, ``lower:`` and ``kernel:``
    is of ``kind``."""
    def value(steps):
        pieces = [p for p in innermost(program_ranges(
                      trace.host_ranges, ("dispatch", "lower", "kernel")))
                  if p[0].startswith(f"{kind}:")]
        return 1e-3 * sum(e - s for _, s, e in _overlap(
            [(s, e) for _, s, e in pieces], [(s, e) for _, s, e in steps]))
    return per_step(trace, value)


def host_syncs(trace, steps: Sequence[Span]) -> List[Span]:
    """The CUDA runtime's synchronising calls (:data:`SYNCS`) inside
    ``steps``, clipped to them."""
    calls = sorted((r for r in trace.host_ranges if r[0] in SYNCS),
                   key=lambda r: r[1])
    return [(calls[i][0], s, e) for i, s, e in _overlap(
        [(s, e) for _, s, e in calls], [(s, e) for _, s, e in steps])]


def idle_by_range(trace) -> Dict[str, float]:
    """The device's idle seconds inside the ``step:prefill`` ranges, split
    by the innermost program range open on the host at each instant
    (``step:prefill`` itself where none below it is open); largest first.
    The values sum to the steps' time less the device's busy time in
    them.  Empty where the trace has no ``step:prefill`` range."""
    steps = step_ranges(trace)
    if not steps:
        return {}
    idle = []
    busy = trace.busy_intervals()
    for _, s, e in steps:
        t = s
        for bs, be in busy:
            if be <= t or bs >= e:
                continue
            if bs > t:
                idle.append((t, bs))
            t = max(t, be)
        if t < e:
            idle.append((t, e))
    pieces = innermost(program_ranges(trace.host_ranges))
    by: Dict[str, float] = {}
    for i, s, e in _overlap([(s, e) for _, s, e in pieces], idle):
        name = pieces[i][0]
        by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def report(trace) -> Dict:
    """What a traced run's program ranges say, a traced forward: the
    step's time, its idle time both from the device's busy time and as
    :func:`idle_by_range` splits it (ms, and the share with no program
    range open below ``step:prefill``), the four readings and the ranges
    by name.  Empty where the trace has no ``step:prefill`` range."""
    steps = step_ranges(trace)
    if not steps:
        return {}
    n = len(steps)
    busy = sum(max(0.0, min(e, se) - max(s, ss))
               for s, e in trace.busy_intervals() for _, ss, se in steps)
    step_us = sum(e - s for _, s, e in steps)
    by = idle_by_range(trace)
    split = sum(by.values())
    syncs = host_syncs(trace, steps)
    counts: Dict[str, float] = {}
    for name, _, _ in program_ranges(trace.host_ranges):
        counts[name] = counts.get(name, 0.0) + 1.0 / n
    return {
        "forwards": n,
        "step_ms": 1e-3 * step_us / n,
        "step_idle_ms": 1e-3 * (step_us - busy) / n,
        "idle_ms_by_range": {k: 1e3 * v / n for k, v in by.items()},
        "idle_ms_split": 1e3 * split / n,
        "unattributed_share": by.get(STEP, 0.0) / split if split else 0.0,
        "seam_ms": time_under(trace, "dispatch"),
        "wrapper_ms": time_under(trace, "kernel"),
        "host_syncs": len(syncs) / n,
        "host_wait_ms": 1e-3 * sum(e - s for _, s, e in syncs) / n,
        "ranges": dict(sorted(counts.items())),
    }


def _save(trace, path: str) -> None:
    with gzip.open(path, "wt") as f:
        json.dump({"device_ops": trace.device_ops,
                   "host_ranges": trace.host_ranges,
                   "window": trace.window}, f)


def _load(path: str):
    from portbench.trace import Trace

    with gzip.open(path, "rt") as f:
        d = json.load(f)
    return Trace(device_ops=[tuple(x) for x in d["device_ops"]],
                 host_ranges=[tuple(x) for x in d["host_ranges"]],
                 window=tuple(d["window"]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="The step's idle time by program range, from a traced "
                    "run of a cell or a kept trace.")
    ap.add_argument("--load", help="a trace kept by --save")
    ap.add_argument("--save", help="keep the run's trace here (.json.gz)")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    args = ap.parse_args(argv)
    if args.load:
        traces = [_load(args.load)]
    else:
        if None in (args.workload, args.seed, args.seconds):
            ap.error("give --load, or --workload, --seed and --seconds")
        from portbench import run, trace as tr

        traces = []
        from_profiler = tr.from_profiler

        def keep(prof):
            traces.append(from_profiler(prof))
            return traces[-1]

        tr.from_profiler = keep
        try:
            run.main(["--workload", args.workload, "--seed", str(args.seed),
                      "--seconds", str(args.seconds), "--trace", "1"])
        finally:
            tr.from_profiler = from_profiler
        if args.save:
            _save(traces[0], args.save)
    print(json.dumps(report(traces[0])), flush=True)


if __name__ == "__main__":
    sys.exit(main())
