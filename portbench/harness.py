"""One run of one cell: set-up, the measured window, the traced forwards,
the check against the plain reference, and the result line.

The window's entry is the program's prefill step,
``repro_torch.launch.steps.make_prefill_step(model)``, run under
``offload_policy(mode="device", use_kernels=True)`` and ``torch.no_grad()``
in a closed loop with one forward in flight: make a fresh batch of token ids
from the seed, run the step to logits, synchronise, and take the next batch.
Set-up builds (or finds built) the program's kernels, makes the weights on
the card from the seed, and runs the traffic's warm-up forwards at the
window's shape.  A sample of the window's forwards, drawn from the seed, is
kept whole (tokens and logits) and judged against the reference once the
window has closed and the memory peak has been read.

:func:`run` takes the step to time as ``make_step``: the CLI passes the
program's; the calibration and the tests pass the control (the reference in
float8) or a broken program.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import random
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import judge, metrics, trace as tr, work
from portbench.cells import Cell, port_arch
from portbench.weights import layout, make_params, rules

__all__ = ["Readings", "batches", "kernel_sources", "program_step",
           "reference_of", "run", "sub_seed"]

Step = Callable[[torch.Tensor], torch.Tensor]


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use (weights, tokens, the judged sample) of
    the run's ``--seed``."""
    digest = hashlib.sha256(f"{seed}/{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def reference_of(config: Dict):
    """The plain forward of the configuration's family."""
    return importlib.import_module(f"portbench.reference.{config['family']}")


def batches(traffic: Dict, vocab: int, seed: int, device):
    """The traffic's prompts, one batch at a time: (batch, seq_len) token
    ids drawn uniformly from ``[0, vocab)`` by a generator on ``device``
    seeded from ``seed``.  The same seed gives the same batches."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "tokens"))
    shape = (traffic["batch"], traffic["seq_len"])
    while True:
        yield torch.randint(0, vocab, shape, generator=gen, device=device)


def program_step(model, params, cell: Cell) -> Step:
    """The program's prefill step on the benchmark's weights."""
    from repro_torch.launch.steps import make_prefill_step

    step = make_prefill_step(model)
    return lambda tokens: step(params, tokens)


class Readings:
    """What a run measured, for the metric readers (``metrics/``)."""

    def __init__(self, cell: Cell, forward_work: List[Dict]):
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.forward_work = forward_work          # one forward's items
        self.model_flops = work.model_flops(
            cell.config, cell.traffic["batch"], cell.traffic["seq_len"])
        self.setup_s = 0.0
        self.window_s = 0.0
        self.forwards = 0
        self.tokens = 0
        self.enqueue_s: List[float] = []
        self.trace: Optional[tr.Trace] = None
        self.traced_forwards = 0
        self.routes: Dict[str, Dict[str, int]] = {}


def _wrappers(config: Dict):
    """The program's kernel wrappers that the configuration's ``routes``
    name, by key: ``"<module>.<wrapper>"`` under ``repro_torch.kernels``."""
    out = {}
    for key in config["routes"]:
        mod, attr = key.split(".")
        out[key] = getattr(
            importlib.import_module(f"repro_torch.kernels.{mod}"), attr)
    return out


def kernel_sources(config: Dict) -> List[str]:
    """The program's CUDA sources that the configuration's routes run: a
    kernel module's library is built from the source of its own name."""
    return sorted({key.split(".")[0] for key in config["routes"]})


def _read_routes(config: Dict) -> Dict[str, Dict[str, int]]:
    return {key: {r: n for r, n in fn.route_launches.items() if n}
            for key, fn in _wrappers(config).items()}


def _zero_routes(config: Dict) -> None:
    for fn in _wrappers(config).values():
        fn.route_launches.update(dict.fromkeys(fn.route_launches, 0))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device,
        t_start: float, make_step: Callable = program_step,
        log: Callable[[str], None] = lambda s: None) -> Dict:
    """One run; returns the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` with
    ``trace``, and ``checks``: each compared number with its limit)."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model

    device = torch.device(device)
    traffic, config = cell.traffic, cell.config

    def stage(what):
        log(f"set-up {time.perf_counter() - t_start:.3f} s: {what}")

    stage("imports")
    if traffic["kind"] != "closed_prefill":
        raise ValueError(f"traffic kind {traffic['kind']!r} has no loop here")
    bsz, seq = traffic["batch"], traffic["seq_len"]
    if device.type == "cuda":
        from repro_torch.kernels import _build
        built = _build.build_all(kernel_sources(config))
        stage(f"kernels built {sorted(built)}" if built else "kernels found")

    model = build_model(port_arch(config))
    params = make_params(layout(config), sub_seed(seed, "weights"), device,
                         rules(config))
    _sync(device)
    stage("weights made")
    step = make_step(model, params, cell)
    prompts = batches(traffic, config["vocab_size"], seed, device)

    def forward(readings=None):
        with torch.profiler.record_function("make inputs"):
            tokens = next(prompts)
        with torch.profiler.record_function("prefill step"):
            t0 = time.perf_counter()
            logits = step(tokens)
            if readings is not None:
                readings.enqueue_s.append(time.perf_counter() - t0)
        with torch.profiler.record_function("synchronise"):
            _sync(device)
        return tokens, logits

    readings = Readings(cell, work.forward_work(config, bsz, seq))
    k = traffic["judged_forwards"]
    pick = random.Random(sub_seed(seed, "judged"))
    kept: List = []
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        for i in range(traffic["warmup_forwards"]):
            forward()
            stage(f"warm-up forward {i + 1}")
        gc.collect()
        _sync(device)
        t0 = time.perf_counter()
        readings.setup_s = t0 - t_start
        n = 0
        while True:
            item = forward(readings)
            if n < k:
                kept.append(item)
            else:
                j = pick.randrange(n + 1)
                if j < k:
                    kept[j] = item
            del item
            n += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and n >= k:
                break
        readings.window_s, readings.forwards = elapsed, n
        readings.tokens = n * bsz * seq
        if trace:
            _zero_routes(config)
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            readings.traced_forwards = traffic["traced_forwards"]
            with profile(activities=acts) as prof:
                for _ in range(readings.traced_forwards):
                    forward()
            readings.routes = _read_routes(config)
            readings.trace = tr.from_profiler(prof)
            del prof
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    gc.collect()
    t_check = time.perf_counter()
    log(f"window {readings.window_s:.3f} s, {readings.forwards} forwards; "
        f"closed at {t_check - t_start:.3f} s")

    reference = reference_of(config)
    tally = judge.Tally()
    for tokens, logits in kept:
        want = reference.forward(params, tokens, config)
        tally.add(logits, want)
        del want
        log(f"judged a forward at {time.perf_counter() - t_check:.3f} s "
            f"after the window")
    del kept
    numbers = tally.numbers()
    limits = config["limits"]
    correct = judge.verdict(numbers, limits)

    wanted = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in wanted:
        v = metrics.load(m["name"])(readings)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct,
           "attempted": (readings.forwards + readings.traced_forwards) * bsz,
           "failed": 0, "metrics": values, "device": dev}
    if trace and readings.trace is not None:
        dev["busy_s"] = readings.trace.busy_s
        dev["window_s"] = readings.trace.window_s
        out["routes"] = readings.routes
        out["breakdown"] = {"device_ops": readings.trace.top_ops(10),
                            "idle_gaps": readings.trace.idle_gaps(10)}
    out["checks"] = {k_: {"value": numbers[k_], "limit": limits[k_]}
                     for k_ in judge.NUMBERS}
    return out
