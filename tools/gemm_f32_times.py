#!/usr/bin/env python3
"""Time one source tree's f32 GEMM on the card; measure the tf32x3 plans
and the route's error.

    python3 tools/gemm_f32_times.py [--src DIR] [--label NAME]
    python3 tools/gemm_f32_times.py --plans
    python3 tools/gemm_f32_times.py --precision

Default: imports ``repro_torch`` from ``DIR`` (default: this checkout's
``src``), builds that tree's ``csrc/gemm.cu``, and times its GEMM on f32
operands (m > 16) with ``smoke/timing.py``'s ``time_f32_gemms``: square n
32-4096 and every GEMM of the yi-6b (m 128) and mamba2-370m (m 512) f32
forwards, beside ``torch.matmul`` (TF32 off) and the bytes / 3xTF32 /
CUDA-core fp32 bounds, and per forward the totals.  To compare two trees
on one card, run both in one command, in turns (e.g. parent, change,
change, parent).

``--plans`` (this checkout only): every tf32x3 plan the kernel takes (the
three block tiles, 1-8 k splits) forced at a set of shapes, in ms per
launch beside the plan ``tf32x3_plan`` picks, to measure its choice
(first the card's capacity table, ``tf32x3_capacity``):
PLAN_SHAPES, the shapes the plan's time model was fitted to, and
HELD_OUT_SHAPES, which it never saw; then, for each set, the worst ratio
of the chosen plan's time to the fastest's.

``--precision`` (this checkout only): the tf32x3 kernel's error against
the plain version (cuBLAS fp32) and against an f64 product at yi-6b's f32
forward shapes (k up to 11008) and at square n.

Each mode prints JSON lines, then the card's name and power limit.  Needs
a CUDA card; imports nothing of JAX or of the JAX reference package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (m, n, k) timed under every plan: Fig. 3's n, the crossover sweep's, the
# yi-6b f32 forward's (m 128) and mamba2-370m's (m 512) shapes.
PLAN_SHAPES = [(32, 32, 32), (64, 64, 64), (128, 128, 128), (256, 256, 256),
               (512, 512, 512), (1024, 1024, 1024), (2048, 2048, 2048),
               (4096, 4096, 4096), (128, 5120, 4096), (128, 4096, 4096),
               (128, 11008, 4096), (128, 4096, 11008), (128, 64000, 4096),
               (512, 2048, 1024), (512, 128, 1024), (512, 32, 1024),
               (512, 1024, 2048), (512, 50280, 1024)]
# (m, n, k, batch) timed under every plan that the model was not fitted
# to: qwen3-moe-30b-a3b's f32 expert stacks (128 experts, m 64 / 128, gate
# and up 2048 -> 768, down 768 -> 2048, one launch each), ragged shapes
# and square n between the fitted ones.
HELD_OUT_SHAPES = [(64, 768, 2048, 128), (64, 2048, 768, 128),
                   (128, 768, 2048, 128), (128, 2048, 768, 128),
                   (17, 72, 104, 1), (100, 200, 1000, 1), (300, 3000, 700, 1),
                   (1000, 5128, 1048, 1), (1536, 1536, 1536, 1),
                   (3000, 3000, 3000, 1)]
PRECISION_SHAPES = [(128, 4096, 11008), (128, 11008, 4096), (128, 5120, 4096),
                    (1024, 1024, 1024), (4096, 4096, 4096)]


def _plans(m, n, k, batch):
    """Every plan the kernel takes at (m, n, k) for a stack of ``batch``,
    keyed "BMxBN/splits"."""
    import torch

    from repro_torch.kernels import gemm as G

    f32 = torch.float32
    a = torch.randn(batch, m, k, device="cuda")
    b = torch.randn(batch, k, n, device="cuda")
    base = G.tf32x3_plan(m, n, k, f32, a.stride(), b.stride(), a.data_ptr(),
                         b.data_ptr(), G.tf32x3_capacity(a.device.index))
    out = {}
    for bm, bn in G._T3_TILES:
        for splits in range(1, 9):
            kc = 8 * -(-max(k, 1) // (8 * splits))
            if -(-max(k, 1) // kc) != splits:
                continue
            out[f"{bm}x{bn}/{splits}"] = base._replace(bm=bm, bn=bn,
                                                        splits=splits, kc=kc)
    chosen = f"{base.bm}x{base.bn}/{base.splits}"
    return a, b, out, chosen


def run_plans(timing) -> None:
    import torch

    from repro_torch.kernels import gemm as G

    caps = G.tf32x3_capacity(torch.cuda.current_device())
    print(json.dumps({"capacity": {f"{bm}x{bn}": list(row)
                                   for (bm, bn), row in caps.items()}}),
          flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    sets = (("fitted", [(*s, 1) for s in PLAN_SHAPES]),
            ("held_out", HELD_OUT_SHAPES))
    for name_of_set, shapes in sets:
        worst = (0.0, None)
        for m, n, k, batch in shapes:
            a, b, plans, chosen = _plans(m, n, k, batch)
            c = torch.empty(batch, m, n, device="cuda")
            sa, sb, sc = a.stride(), b.stride(), c.stride()[:2]
            iters = 40 if batch * m * n * k <= 2 ** 28 else 10
            times, refused = {}, {}
            for name, plan in plans.items():
                err = G._launch_gemm(a, b, c, m, n, k, batch, sa, sb, sc,
                                     "tf32x3", stream, plan)
                if err:                    # e.g. a cluster the card refuses
                    refused[name] = err
                    continue
                times[name] = timing._time(
                    lambda _, plan=plan: G._launch_gemm(
                        a, b, c, m, n, k, batch, sa, sb, sc, "tf32x3",
                        stream, plan), [None], iters=iters)
            best = min(times, key=times.get)
            ratio = times[chosen] / times[best]
            worst = max(worst, (ratio, [m, n, k, batch]))
            print(json.dumps({"set": name_of_set, "m": m, "n": n, "k": k,
                              "batch": batch, "chosen": chosen,
                              "chosen_ms": times[chosen], "best": best,
                              "best_ms": times[best],
                              "chosen_over_best": ratio, "ms": times,
                              "refused": refused,
                              "library_ms": timing._time(
                                  lambda _: torch.matmul(a, b), [None],
                                  iters=iters)}), flush=True)
        print(json.dumps({"set": name_of_set, "shapes": len(shapes),
                          "worst_chosen_over_best": worst[0],
                          "worst_at": worst[1]}), flush=True)


def run_precision() -> None:
    import torch

    from repro_torch.kernels import gemm as G
    from repro_torch.kernels.ref import gemm_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, k in PRECISION_SHAPES:
        a = torch.randn(m, k, generator=gen, device="cuda")
        b = torch.randn(k, n, generator=gen, device="cuda")
        plain = gemm_ref(a, b)
        exact = torch.matmul(a.double(), b.double())
        scale_p = plain.abs().max().item()
        scale_x = exact.abs().max().item()
        c = G.gemm(a, b)
        torch.cuda.synchronize()
        d = c.double() - exact
        print(json.dumps({
            "m": m, "n": n, "k": k,
            "plan": G.tf32x3_plan(m, n, k, a.dtype, (0, k, 1), (0, n, 1),
                                  a.data_ptr(), b.data_ptr(),
                                  G.tf32x3_capacity(a.device.index)
                                  )._asdict(),
            "plain_vs_f64": (plain.double() - exact).abs().max().item()
            / scale_x,
            "vs_plain": (c - plain).abs().max().item() / scale_p,
            "vs_f64": d.abs().max().item() / scale_x,
            "mean_signed_vs_f64": (d * exact.sign()).mean().item()
            / scale_x}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--label", default="", help="name printed with the times")
    ap.add_argument("--plans", action="store_true",
                    help="time every tf32x3 plan at PLAN_SHAPES and "
                    "HELD_OUT_SHAPES")
    ap.add_argument("--precision", action="store_true",
                    help="the tf32x3 error against cuBLAS fp32 and f64")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("gemm_f32_times: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from smoke import timing
    from repro_torch.configs import get_arch
    from repro_torch.kernels.gemm import gemm

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.plans:
        run_plans(timing)
    elif args.precision:
        run_precision()
    else:
        gen = torch.Generator(device="cuda").manual_seed(timing.SEED)

        def randn(*shape, dtype=torch.float32):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        rows, tot = timing.time_f32_gemms(
            gemm, get_arch(timing.ARCH), get_arch(timing.SSM_ARCH),
            randn)
        print(json.dumps({"label": args.label, "src": args.src,
                          "f32_gemm_shapes": rows, "per_forward": tot}),
              flush=True)
    print(timing._card_name_and_power_limit(), flush=True)


if __name__ == "__main__":
    main()
