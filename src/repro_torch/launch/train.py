"""End-to-end training driver with checkpoint/restart.

Usage (CPU-scale: the reduced config, on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --steps 8 \\
      --global-batch 4 --seq-len 32 --device cpu --ckpt-dir /tmp/ckpt

and on the card, yi-6b at its published widths cut to 8 of 32 layers:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --full \\
      --num-layers 8 --steps 8 --global-batch 2 --seq-len 512

The port of ``src/repro/launch/train.py``.  Its steps run under
``offload_policy(mode="device", use_kernels=True)``, so every eligible op
of the forward runs on the hand-written kernels and the GEMMs of the
backward too (:mod:`repro_torch.kernels.autograd`); on the CPU the
kernels' plain versions run.  As in the reference, the driver builds
the local mesh (:func:`~repro_torch.launch.mesh.make_local_mesh`) and the
parameter shardings on it, and the step uses neither.  Departures: ``--num-layers`` cuts the depth at
published widths (the whole yi-6b's train state, about 97 GB, exceeds the
card's 80 GB); ``--device`` picks the device, the card by default, and a
missing card raises; ``ckpt_dir=None`` (``--ckpt-dir ''``) trains without
checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.core.hero import offload_policy
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import (TrainOptions, init_train_state,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.sharding import named, param_pspecs

__all__ = ["train", "main"]


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def train(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 50,
    global_batch: int = 8,
    seq_len: int = 128,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    peak_lr: float | None = None,
    compress_grads: bool = False,
    resume: bool = True,
    log_every: int = 10,
    num_microbatches: int | None = None,
    num_layers: int | None = None,
    device="cuda",
    on_step: Optional[Callable[[int, float, float], None]] = None,
) -> List[float]:
    """Train ``arch`` for ``steps`` steps on ``SyntheticLM`` (seed 17) from
    seeded random weights; returns the loss of every step run.
    ``on_step(step, loss, seconds)`` is called after each step with its
    host-clock time (the loss read back ends it).  Without ``ckpt_dir``
    nothing is saved or resumed."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    if num_microbatches is not None:
        cfg = dataclasses.replace(cfg, num_microbatches=num_microbatches)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    model = build_model(cfg)
    mesh = make_local_mesh(dev)
    if peak_lr is None:
        # The reduced smoke models move less per step at the full-size
        # default than the synthetic stream's batch-to-batch loss noise,
        # so short smoke runs take a bigger step (the reference's rule).
        peak_lr = 3e-3 if smoke else 3e-4
    opts = TrainOptions(
        peak_lr=peak_lr, warmup_steps=max(steps // 10, 1), total_steps=steps,
        compress_grads=compress_grads,
    )

    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    opt_state, err = init_train_state(model, params, opts)

    ckpt = Checkpointer(Path(ckpt_dir)) if ckpt_dir else None
    start_step = 0
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        (params, opt_state), start_step = ckpt.restore((params, opt_state))
        print(f"resumed from step {start_step}")

    data = SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=17)
    p_shard = named(mesh, param_pspecs(params, mesh))  # noqa: F841 (as the reference)
    step_fn = make_train_step(model, opts)

    losses: List[float] = []
    t_start = time.perf_counter()
    with offload_policy(mode="device", use_kernels=True):
        for step in range(start_step, steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(step).items()}
            params, opt_state, err, metrics = step_fn(params, opt_state, err,
                                                      batch)
            losses.append(float(metrics["loss"]))
            if on_step is not None:
                on_step(step, losses[-1], time.perf_counter() - t0)
            if step % log_every == 0 or step == steps - 1:
                dt = time.perf_counter() - t_start
                print(f"step {step:5d}  loss {losses[-1]:.4f}  ({dt:.1f}s)")
            if ckpt is not None and ((step + 1) % ckpt_every == 0
                                     or step == steps - 1):
                # async: snapshot now, write in background (one in flight)
                ckpt.save_async(step + 1, (params, opt_state))
    if ckpt is not None:
        ckpt.wait()
    return losses


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=_default_ckpt_dir(),
                    help="checkpoint directory; '' trains without one")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=None)  # None: auto by scale
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-resume", dest="resume", action="store_false")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth, keeping the published widths")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    train(
        args.arch,
        smoke=args.smoke,
        steps=args.steps,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir or None,
        ckpt_every=args.ckpt_every,
        peak_lr=args.lr,
        compress_grads=args.compress_grads,
        resume=args.resume,
        num_layers=args.num_layers,
        device=args.device,
    )


if __name__ == "__main__":
    main()
