#!/usr/bin/env python3
"""Check the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--out-dir DIR]

Builds every CUDA kernel and checks each against its plain PyTorch
version, then runs the port's paths at published widths on the card, each
on the kernels against the plain path: yi-6b, the paper's ``hnp`` path,
the modeled cluster and streaming engine, mamba2-370m, qwen3-moe-30b-a3b,
the rest of the model zoo, training, the distributed layer on an emulated
mesh and the roofline; last it times every kernel.  :func:`main` is the
list of phases in order.  Each phase lives in a module of ``smoke/``,
whose docstring says what it checks, and prints JSON lines named by their
``"phase"`` field (README.md tabulates them).

Each path's launch and route counters are set to 0 just before it runs
and read just after (``smoke.common.Tally``): every bf16 forward and
hnp-wave GEMM and every bf16 forward attention launch (D 64 / 80 / 128)
must take the tensor-core route (``wgmma``), every serving GEMM the
skinny one, every bf16 decode attention launch the tensor-core one
(``mma``), every f32 forward attention launch (yi-6b, qwen3-moe, jamba)
the f32 tensor-core one (``tf32x3``), the f32 decode's attention the
CUDA-core one (``simt``), every f32 GEMM with m > 16 (phases 2, 6, 7a,
10, 10d) ``tf32x3``, and every SSD launch of the phase-2 checks and of the
forwards (eager, graph, f32) ``mma``.

Any failure exits non-zero and nothing is caught.  Files too long for
standard output (the cluster run's Chrome trace, the Fig. 3 rows, the dry
runs' records) go to ``DIR`` (default ``artifacts/``, git-ignored).  The
last line of stdout is ``{"ok": true, "device": {...}}``; the line before
it is the card's name and power limit from nvidia-smi, and the one before
that lists every kernel.  Imports nothing of JAX or of the JAX reference
package.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

from smoke import (cluster, dense, hnp, kernels, mesh, moe, roofline, ssm,
                   times, train, zoo)
from smoke.common import Tally, emit, fail
from smoke.shapes import ARCH, MOE_ARCH, ROOT, SEED, SSM_ARCH, zoo_configs
from smoke.timing import _card_name_and_power_limit


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one H100.")
    ap.add_argument("--out-dir", type=pathlib.Path,
                    default=ROOT / "artifacts",
                    help="where the long outputs go (default: artifacts/)")
    tally = Tally(ap.parse_args().out_dir.resolve())
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs the card")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    from repro_torch.configs import get_arch

    # ---- 1. build, 2. check ------------------------------------------------
    kernels.run_build()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    cfg, ssm_cfg = get_arch(ARCH), get_arch(SSM_ARCH)
    moe_cfg, zoo_cfgs = get_arch(MOE_ARCH), zoo_configs()
    kernels.check_kernels(cfg, ssm_cfg, moe_cfg, randn, zoo_cfgs, tally)

    # ---- 3.-6. yi-6b: serve, forward, serve-graph, long-decode; 5a.-5c.
    # serve-cluster, trace-export, races on its weights; 6. float32 ---------
    rng = np.random.default_rng(SEED)
    fwd = dense.run_yi(cfg, rng, tally)

    # ---- 7. hnp, 7b. hnp-validated, 7c. stream, 7a. paper-fig3 -------------
    hnp_plain = hnp.run_hnp(cfg, randn, tally)
    hnp.run_hnp_validated(hnp_plain, tally)
    del hnp_plain
    cluster.run_stream()
    cluster.run_paper_fig3(tally)

    # ---- 8.-10. mamba2-370m: ssm-forward, ssm-serve, ssm-float32 -----------
    ssm_fwd = ssm.run_ssm(ssm_cfg, rng, tally)

    # ---- 10a.-10f. qwen3-moe-30b-a3b; 10g. the ragged grouped GEMM ---------
    moe.run_moe(moe_cfg, rng, tally)
    moe.run_grouped(moe_cfg, tally)

    # ---- 12a.-12h. the rest of the zoo -------------------------------------
    zoo.run_zoo(zoo_cfgs, rng, tally)

    # ---- 13. training: yi-6b at published widths, 8 of 32 layers ----------
    train.run_train(randn, tally)

    # ---- 14. the distributed layer on an emulated 8-device mesh ------------
    mesh.run_distributed(tally)

    # ---- 15. the roofline: dry runs on meta, forwards against their bound --
    roofline.run_roofline(tally, {ARCH: fwd, SSM_ARCH: ssm_fwd})

    # ---- 11. times, and the kernels line -----------------------------------
    rows = times.run_times(cfg, ssm_cfg, moe_cfg, zoo_cfgs, randn, tally)
    emit({"seconds_total": time.perf_counter() - t_start})
    emit({"kernels": rows})

    print(_card_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
