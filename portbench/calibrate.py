"""Readings that the limits of ``correct`` are set from, in one process.

    python3 portbench/calibrate.py --workload yi-6b.prefill-4k \\
        --seeds 11,12,13 --control-seeds 21,22,23 --fault-seeds 31 \\
        --seconds 1 --out calibrate.jsonl

For each seed, one short run of the cell (the traffic's shapes, its judged
forwards) with the program's step, with the control (the reference in
float8 in the program's place) or with each planted fault
(``faults.FAULTS``), and its compared numbers.  One JSON line a run, to
``--out`` and to standard output.  Not part of the benchmark's runs: it is
how the limits in the configuration files were read.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", type=pathlib.Path, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import faults, harness
    from portbench.cells import load_cell

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA card")
    cell = load_cell(args.workload)
    # The control's forwards are the slow plain ones: no warm-up for them.
    cold = dataclasses.replace(cell, traffic={**cell.traffic,
                                              "warmup_forwards": 0})
    runs = [("program", s, cell, harness.program_step)
            for s in _seeds(args.seeds)]
    runs += [("control", s, cold, faults.control)
             for s in _seeds(args.control_seeds)]
    runs += [(name, s, cell, fn) for s in _seeds(args.fault_seeds)
             for name, fn in faults.FAULTS.items()]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        for kind, seed, c, make_step in runs:
            t0 = time.perf_counter()
            out = harness.run(c, seed, args.seconds, False, device="cuda:0",
                              t_start=t0, make_step=make_step)
            line = json.dumps({
                "workload": cell.name, "kind": kind, "seed": seed,
                "numbers": {k: v["value"] for k, v in out["checks"].items()},
                "forwards": out["attempted"] // cell.traffic["batch"],
                "seconds": time.perf_counter() - t0,
                "card": torch.cuda.get_device_name(0)})
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
            del out
            gc.collect()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
