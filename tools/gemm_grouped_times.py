#!/usr/bin/env python3
"""Time the ragged grouped GEMM on the card at granite-4.0-h's prefill
expert shapes, beside its plain version and two library yardsticks.

    python3 tools/gemm_grouped_times.py [--rows 163840] [--reps 20]

The shapes are the benchmark's ``granite-4.0-h-small.prefill-4k``: 4 x
4096 tokens, 10 of 72 experts each, so R = 163840 routed rows a layer
sorted by expert, through the gate / up (4096 -> 768) and the down (768 ->
4096) products.  The counts come from a uniform draw of 10 distinct experts
a token (what random router weights give).  Each row: ms a launch of

* ``kernel`` — ``kernels/gemm.py::gemm_grouped`` (one launch, the offsets
  read on the card);
* ``plain`` — its plain version ``kernels/ref.py::gemm_grouped_ref``
  (one float32 product an expert, counts read on the host);
* ``torch_loop`` — one bf16 ``torch.matmul`` an expert (cuBLAS);
* ``bmm_padded`` — one bf16 ``torch.bmm`` over every expert padded to the
  largest count (the batched GEMM's shape);
* ``grouped_mm`` — ``torch._grouped_mm`` on the same offsets, where the
  installed PyTorch has it (else null);

with the bound (``work_granitemoehybrid.expert_gemm``: FLOPs over 989
TFLOP/s against the rows, each expert's weights once and the outputs over
3.35 TB/s) and the kernel's TFLOP/s and largest error against the plain
version (of max |plain|).  Times from CUDA events over ``--reps``
back-to-back launches after a warm-up.  The library calls are yardsticks
only; the port never calls them.  Then the card's name and power limit.
Needs a CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
E, K_TOP, D, F = 72, 10, 4096, 768


def _ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4 * 4096 * K_TOP)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from repro_torch.kernels.gemm import gemm_grouped
    from repro_torch.kernels.ref import gemm_grouped_ref
    from portbench.work import ideal_seconds
    from portbench.work_granitemoehybrid import expert_gemm

    if not torch.cuda.is_available():
        sys.exit("gemm_grouped_times: no CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = args.rows // K_TOP
    pick = torch.rand(tokens, E, generator=gen, device="cuda").argsort(-1)
    counts = torch.bincount(pick[:, :K_TOP].reshape(-1), minlength=E)
    offsets = torch.zeros(E + 1, dtype=torch.int32, device="cuda")
    offsets[1:] = torch.cumsum(counts, 0)
    host = [0] + torch.cumsum(counts, 0).tolist()
    r = host[-1]
    rows = []
    for name, k, n in (("gate/up", D, F), ("down", F, D)):
        a = torch.randn(r, k, generator=gen, device="cuda").bfloat16()
        b = (torch.randn(E, k, n, generator=gen, device="cuda")
             * k ** -0.5).bfloat16()
        got = gemm_grouped(a, b, offsets)
        want = gemm_grouped_ref(a, b, offsets, out_dtype=torch.float32)
        err = float((got.float() - want).abs().max() / want.abs().max())
        del want

        def loop():
            for e in range(E):
                torch.matmul(a[host[e]:host[e + 1]], b[e])

        big = int(counts.max())
        padded = torch.zeros(E, big, k, device="cuda", dtype=torch.bfloat16)
        for e in range(E):
            padded[e, :host[e + 1] - host[e]] = a[host[e]:host[e + 1]]
        times = {
            "kernel": _ms(lambda: gemm_grouped(a, b, offsets), args.reps),
            "plain": _ms(lambda: gemm_grouped_ref(a, b, offsets),
                         max(2, args.reps // 10)),
            "torch_loop": _ms(loop, args.reps),
            "bmm_padded": _ms(lambda: torch.bmm(padded, b), args.reps),
            "grouped_mm": None,
        }
        del padded
        grouped_mm = getattr(torch, "_grouped_mm", None)
        if grouped_mm is not None:
            try:
                off = offsets[1:].contiguous()
                times["grouped_mm"] = _ms(
                    lambda: grouped_mm(a, b, offs=off), args.reps)
            except (RuntimeError, TypeError) as e:   # not on this build
                times["grouped_mm_error"] = str(e).splitlines()[0][:200]
        item = expert_gemm(name, r, E, k, n)
        rows.append({
            "gemm": name, "rows": r, "experts": E, "k": k, "n": n,
            "counts_min_max": [int(counts.min()), int(counts.max())],
            "ms": times, "bound_ms": 1e3 * ideal_seconds(item),
            "kernel_tflop_s": item["flops"] / times["kernel"] / 1e9,
            "kernel_roofline_pct": 100 * 1e3 * ideal_seconds(item)
            / times["kernel"],
            "max_abs_err_vs_plain": err})
        print(json.dumps(rows[-1]), flush=True)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = torch.cuda.get_device_name(0)
    print(json.dumps({"card": card}), flush=True)


if __name__ == "__main__":
    main()
