"""Run one cell of the benchmark once, on the card of this machine.

    python3 portbench/run.py --workload yi-6b.prefill-4k --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout: the program under test is
``src/repro_torch``.  The cell is looked up by name in ``BENCHMARK.json``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
with ``--trace 1``, ``breakdown``; its last key, ``checks``, holds each
number compared with the plain reference beside its limit, and the same
lines end standard error.  Exits with another code than 0, and prints no
result, when there is no CUDA card or fewer than the cell asks for, when
the program is not beside the benchmark, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def _fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.cells import load_cell
    try:
        cell = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        _fail(f"cannot read the cell: {e!r}", 2)
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail(f"the program is not beside the benchmark "
              f"({ROOT / 'src' / 'repro_torch'})", 3)

    import torch
    # One process with few threads: no CPU thread pool beside the one
    # thread that drives the card.
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: the benchmark runs on a "
              "CUDA card only", 4)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{torch.cuda.device_count()} CUDA card(s), the cell asks for "
              f"{cell.chips}", 4)

    from portbench import harness, judge

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda:0", t_start=T_START, log=log)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        _fail(f"JAX or the JAX package was loaded: {loaded}", 5)
    out["device"]["power_limit"] = _power_limit()
    checks = out.pop("checks")
    out["checks"] = checks
    numbers = {k: v["value"] for k, v in checks.items()}
    limits = {k: v["limit"] for k, v in checks.items()}
    print(json.dumps(out), flush=True)
    for line in judge.lines(numbers, limits):
        print(line, file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
