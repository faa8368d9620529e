#!/usr/bin/env python3
"""Time one source tree's flash attention on the card.

    python3 tools/flash_attention_times.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds that tree's ``csrc/flash_attention.cu``, and times the kernel with
``smoke/timing.py``'s timing code (CUDA events, operands rotated past
L2) at six shapes, each beside its bound, its plain version and SDPA:

* h2o-danube-1.8b's forward, 1 x 8192, 32 / 8 heads, D 80, causal,
  window 4096, bf16 (the model's transposed views; SDPA with the same
  mask);
* hubert-xlarge's forward, 2 x 512, 16 / 16 heads, D 80, bidirectional,
  bf16 (the same);
* gemma3-27b's windowed forward, 2 x 2048, 32 / 16 heads, D 128, window
  1024, bf16 (the same; a shape whose route does not change);
* yi-6b's prefill, 2 x 512, 32 / 4 heads, D 128, causal, bf16 (the same);
* the yi-6b f32 check's forward, 1 x 128, 32 / 4 heads, D 128, causal, f32
  (SDPA f32 ``is_causal``, TF32 off);
* jamba's f32 check's forward, 1 x 512, 64 / 8 heads, D 128, causal, f32
  (the same).

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
        sys.exit("flash_attention_times: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from smoke import timing
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(timing.SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    zoo = timing.zoo_configs()
    yi = get_arch(timing.ARCH)
    rows = {}
    for tag, b, hq, hkv, s, d, causal, window in \
            timing.zoo_attention_cases(zoo):
        if tag != "jamba/qwen2":
            rows[tag] = timing.time_zoo_attention(
                flash_attention, randn, b, hq, hkv, s, d, causal, window,
                None)
    rows["yi-6b-prefill"] = timing.time_zoo_attention(
        flash_attention, randn, timing.FWD_BATCH, yi.num_heads,
        yi.num_kv_heads, timing.FWD_SEQ, yi.head_dim, True, None,
        yi.num_layers)
    rows["yi-6b-f32"] = timing.time_f32_attention(flash_attention, yi,
                                                      randn)
    rows["jamba-f32"] = timing.time_f32_attention(
        flash_attention, zoo["jamba-f32"], randn, 1,
        timing.JAMBA_F32_FWD_SEQ, launches=1)
    print(json.dumps({"label": args.label, "src": args.src,
                      "flash_attention_shapes": rows}), flush=True)
    print(timing._card_name_and_power_limit(), flush=True)


if __name__ == "__main__":
    main()
