#!/usr/bin/env python3
"""Time one source tree's bf16 GEMM on the card at yi-6b's prefill shapes;
time the wgmma kernel's tile orders.

    python3 tools/gemm_bf16_times.py [--src DIR] [--label NAME]
    python3 tools/gemm_bf16_times.py --orders [--groups 4,8,12,16]

Default: imports ``repro_torch`` from ``DIR`` (default: this checkout's
``src``), builds that tree's ``csrc/gemm.cu``, and times its ``gemm`` on
bf16 operands as its wrapper runs them (route and tile order its own) at
the five GEMMs of a yi-6b layer and head (qkv n 5120, o, gate / up n
11008, down k 11008, head n 64000; B row-major, as the model's weights) at
m 1024 and m 16384 (4 x 4096 tokens, the benchmark's ``yi-6b.prefill-4k``),
beside ``torch.matmul`` (cuBLAS, the baseline only).  To compare two trees
on one card, run both in one command, in turns (e.g. parent, change,
change, parent).

``--orders`` (this checkout only): the wgmma kernel at the same shapes
under each tile order, forced through ``_launch_gemm``: the plain order (a
group of all m tiles), groups of ``--groups`` m tiles, and the group that
``wgmma_plan`` picks; beside ``torch.matmul``.

Each row gives ms a launch (CUDA events over back-to-back launches, B
rotated past the 50 MB L2 where one copy fits in it), TFLOP/s, and the
HBM bytes a launch.  The card's profiler reads no DRAM counters here
(``ncu`` does not run), so ``hbm_bytes`` is null; ``wave_model_bytes`` is
the bytes a model of the order reads: each wave of ``sms`` consecutive
blocks reads the A and B panels of its tiles once from HBM (no reuse
between waves), plus C written once.  Then the card's name and power
limit.  Needs a CUDA card; imports nothing of JAX or of the JAX reference
package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (name, k, n) of yi-6b's GEMMs: d 4096, 32 + 2 x 4 heads of 128, d_ff
# 11008, vocabulary 64000.
SHAPES = [("qkv", 4096, 5120), ("o", 4096, 4096), ("gate/up", 4096, 11008),
          ("down", 11008, 4096), ("head", 4096, 64000)]
MS = (1024, 16384)
BM = 128


def _tile_of(block, m_tiles, n_tiles, group):
    """The wgmma kernel's block -> (m tile, n tile) map (its copy in
    ``kernels/gemm.py::wgmma_block_tile``; kept here so that the model
    also describes a tree that lacks it)."""
    span = group * n_tiles
    first = block // span * group
    rows = min(m_tiles - first, group)
    r = block % span
    return first + r % rows, r // rows


def wave_model_bytes(m, n, k, group, sms):
    """HBM bytes of one launch under the wave model (module docstring)."""
    bn = 64 if n <= 64 else 128
    m_tiles, n_tiles = -(-m // BM), -(-n // bn)
    blocks = m_tiles * n_tiles
    panels = 0
    for w in range(0, blocks, sms):
        tiles = [_tile_of(b, m_tiles, n_tiles, group)
                 for b in range(w, min(w + sms, blocks))]
        panels += (len({i for i, _ in tiles}) * BM
                   + len({j for _, j in tiles}) * bn)
    return 2.0 * (panels * k + m * n)


def _operands(m, k, n):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    copies = max(1, min(4, -(-120_000_000 // (2 * k * n))))
    return [(a, torch.randn(k, n, generator=gen, device="cuda").bfloat16())
            for _ in range(copies)]


def _iters(m, n, k):
    """About 0.2 s of launches at 400 TFLOP/s, 3 to 40."""
    return max(3, min(40, int(0.2 / (2.0 * m * n * k / 400e12))))


def _row(time, ops, m, n, k, sms, fn, group=None):
    ms = time(fn, ops, iters=_iters(m, n, k))
    row = {"m": m, "k": k, "n": n, "ms": ms,
           "TFLOPs": 2.0 * m * n * k / ms / 1e9, "hbm_bytes": None}
    if group is not None:
        row["group"] = group
        row["wave_model_bytes"] = wave_model_bytes(m, n, k, group, sms)
    return row


def run_tree(timing, label, src):
    import torch

    from repro_torch.kernels import gemm as G

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = getattr(G, "wgmma_plan", None)
    for m in MS:
        for name, k, n in SHAPES:
            ops = _operands(m, k, n)
            group = plan(m, n, k, 1, sms) if plan else -(-m // BM)
            before = dict(G.gemm.route_launches)
            kernel = _row(timing._time, ops, m, n, k, sms,
                          lambda t: G.gemm(*t), group)
            kernel["routes"] = {r: c - before[r]
                                for r, c in G.gemm.route_launches.items()
                                if c != before[r]}
            library = _row(timing._time, ops, m, n, k, sms,
                           lambda t: torch.matmul(*t))
            print(json.dumps({"label": label, "src": src, "shape": name,
                              "kernel": kernel, "library": library,
                              "kernel_over_library":
                                  kernel["ms"] / library["ms"]}), flush=True)
            del ops


def run_orders(timing, groups):
    import torch

    from repro_torch.kernels import gemm as G

    sms = G.sm_count(0)
    stream = torch.cuda.current_stream().cuda_stream
    for m in MS:
        for name, k, n in SHAPES:
            ops = _operands(m, k, n)
            c = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            m_tiles = -(-m // BM)
            plan = G.wgmma_plan(m, n, k, 1, sms)
            orders = {"plain": m_tiles, **{str(g): g for g in groups},
                      "plan": plan}
            rows = {}
            for tag, group in orders.items():
                def launch(t, group=group):
                    err = G._launch_gemm(t[0], t[1], c, m, n, k, 1,
                                         (0, k, 1), (0, n, 1), (0, n),
                                         "wgmma", stream, group=group)
                    if err:
                        raise RuntimeError(f"wgmma launch: cudaError {err}")
                rows[tag] = _row(timing._time, ops, m, n, k, sms, launch,
                                 min(group, m_tiles))
            library = _row(timing._time, ops, m, n, k, sms,
                           lambda t: torch.matmul(*t))
            print(json.dumps({"shape": name, "m": m, "k": k, "n": n,
                              "m_tiles": m_tiles, "plan": plan,
                              "orders": rows, "library": library,
                              "plain_over_plan": rows["plain"]["ms"]
                              / rows["plan"]["ms"]}), flush=True)
            del ops, c


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--label", default="", help="name printed with the times")
    ap.add_argument("--orders", action="store_true",
                    help="time the wgmma kernel under each tile order")
    ap.add_argument("--groups", default="4,8,12,16",
                    help="group sizes (m tiles) --orders times besides the "
                    "plain order and the plan's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("gemm_bf16_times: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from smoke import timing

    if args.orders:
        run_orders(timing, [int(g) for g in args.groups.split(",")])
    else:
        run_tree(timing, args.label, args.src)
    print(timing._card_name_and_power_limit(), flush=True)


if __name__ == "__main__":
    main()
