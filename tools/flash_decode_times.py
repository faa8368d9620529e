#!/usr/bin/env python3
"""Time one source tree's flash-decode kernel on the card.

    python3 tools/flash_decode_times.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds that tree's ``csrc/flash_decode.cu``, and times the kernel in bf16
at ``smoke/shapes.py``'s ``DECODE_TIME_SHAPES`` (yi-6b's last serve step, a
64-slot cache with 31 valid, and its published 4096-slot context with 4095
valid, at B 8 and at B 1) beside its bound, its plain version and SDPA
(CUDA events, caches rotated past L2), with ``smoke/timing.py``'s timing
code.  Prints one JSON line, then the card's name and power limit.  To
compare two trees on one card, run both in one command, in turns (e.g.
parent, change, change, parent).  Needs a CUDA card; imports nothing of
JAX or of the JAX reference package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--label", default="", help="name printed with the times")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_decode_times: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from smoke import timing
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_decode import flash_decode

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(timing.ARCH)
    gen = torch.Generator(device="cuda").manual_seed(timing.SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    shapes = timing.time_flash_decode(flash_decode, cfg.num_heads,
                                          cfg.num_kv_heads, cfg.head_dim,
                                          randn)
    print(json.dumps({"label": args.label, "src": args.src,
                      "flash_decode_shapes": shapes}), flush=True)
    print(timing._card_name_and_power_limit(), flush=True)


if __name__ == "__main__":
    main()
