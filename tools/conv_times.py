#!/usr/bin/env python3
"""Time the Mamba-2 mixer's causal conv + SiLU kernel on the card.

    python3 tools/conv_times.py [--label NAME]

Builds this checkout's ``csrc/ssd_scan.cu`` and times
``kernels/ssd_scan.py::causal_conv_silu`` in bf16 at granite-4.0-h-small's
prefill (4 x 4096 tokens, F 8448) and mamba2-370m's forward (4 x 1024,
F 2304) beside the bytes bound and its plain version (the torch
composition the mixer ran before the kernel), with ``smoke/timing.py``'s
timing code (CUDA events, inputs rotated past L2).  Then traces three
calls of each under ``torch.profiler`` and prints the device time a call
by kernel name, the plain version's ≈ 20 launches included.  Prints JSON
lines, then the card's name and power limit.  Needs a CUDA card; imports
nothing of JAX or of the JAX reference package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def traced_ms(fn, args, calls: int = 3):
    """Device ms a call of ``fn(*args)``, its device operations a call, and
    the ms a call by operation name, from ``torch.profiler`` over
    ``calls`` calls after one warm-up, read through
    ``portbench/trace.py``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.PHASES[1]):
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
    tr = trace.from_profiler(prof)
    by_kernel = {name: 1e3 * s / calls
                 for name, s in tr.top_ops(len(tr.device_ops))}
    return (1e3 * tr.op_seconds() / calls, len(tr.device_ops) / calls,
            by_kernel)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="name printed with the times")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("conv_times: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from smoke import timing
    from repro_torch.kernels.ref import causal_conv_silu_ref
    from repro_torch.kernels.ssd_scan import causal_conv_silu

    gen = torch.Generator(device="cuda").manual_seed(timing.SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rows = timing.time_conv(causal_conv_silu, randn)
    print(json.dumps({"label": args.label, "causal_conv_silu_shapes": rows}),
          flush=True)
    for tag, b, s, di, gn, k, _ in timing.CONV_TIME_SHAPES:
        bf16 = torch.bfloat16
        ops = (randn(b, s, di, dtype=bf16), randn(b, s, gn, dtype=bf16),
               randn(b, s, gn, dtype=bf16),
               (0.2 * randn(k, di + 2 * gn)).to(bf16),
               (0.1 * randn(di + 2 * gn)).to(bf16))
        for name, fn in (("kernel", causal_conv_silu),
                         ("plain", causal_conv_silu_ref)):
            total, launches, by_kernel = traced_ms(fn, ops)
            print(json.dumps({"label": args.label, "shape": tag,
                              "traced": name, "device_ms_a_call": total,
                              "launches_a_call": launches,
                              "by_kernel_ms": by_kernel}), flush=True)
        del ops
        torch.cuda.empty_cache()
    print(timing._card_name_and_power_limit(), flush=True)


if __name__ == "__main__":
    main()
