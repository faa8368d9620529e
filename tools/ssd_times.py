#!/usr/bin/env python3
"""Time one source tree's SSD kernels on the card.

    python3 tools/ssd_times.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds that tree's ``csrc/ssd_scan.cu``, and times, with
``smoke/timing.py``'s timing code (CUDA events):

* the SSD chunk kernel (``ssd_chunk_diag``) at mamba2-370m's 4 x 1024
  forward shape (BH 128, C 4, Q 256, P 64, N 128, fp32 operands, the
  model's decay, inputs rotated past L2) beside its bounds, its plain
  version and the library yardstick (two fp32 cuBLAS bmm around a masked
  exp);
* the whole SSD core as granite-4.0-h-small's mixer runs it
  (``time_ssd_core``: 4 x 4096, H 128, G 1, P 64, N 128, Q 256, from the
  conv's f32 output through ``ssd_inputs`` and ``blas.ssd_scan``) beside
  its bound, its plain composition and its device time by kernel family.

Prints one JSON line, then the card's name and power limit.  To compare
two trees on one card, run both in one command, in turns (e.g. parent,
change, change, parent).  Needs a CUDA card; imports nothing of JAX or of
the JAX reference package.
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
        sys.exit("ssd_times: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from smoke import timing
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ssd_chunk_diag

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(timing.SSM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(timing.SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    shape = timing.time_ssd(ssd_chunk_diag, cfg, randn)
    core = timing.time_ssd_core(randn)
    print(json.dumps({"label": args.label, "src": args.src,
                      "ssd_chunk_diag_shape": shape,
                      "ssd_core_granite": core}), flush=True)
    print(timing._card_name_and_power_limit(), flush=True)


if __name__ == "__main__":
    main()
