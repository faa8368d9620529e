"""Pipeline parallelism (GPipe schedule) over a mesh axis.

The twin of ``src/repro/launch/pipeline.py``, on the emulated mesh of
:mod:`repro_torch.sharding.spmd`.  Stages live on the ``model`` (or any)
mesh axis; stage parameters are stacked on a leading (S, …) axis sharded
``P(axis, …)``.  Under a ``shard_map`` a loop runs the classic GPipe
wavefront — at tick ``t`` stage ``k`` processes microbatch ``t−k`` — with
activations handed to the next stage by ``ppermute``.  The backward is
autograd's: the emulated collectives are torch ops, so the gradient
wavefront flows back through the same graph (no hand-written backward
schedule).  ``stage_fn`` runs in the stage's ``shard_map`` body, so the
ops it dispatches take no tensor-parallel plan (a body has no ambient
mesh) and run on the kernels when the policy enables them.

Bubble fraction = (S−1)/(M+S−1) — pick microbatches M ≫ S.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.sharding.spmd import P, axis_index, ppermute, psum, shard_map

__all__ = ["pipeline_apply"]


def pipeline_apply(
    stage_params,
    x: torch.Tensor,
    stage_fn: Callable,
    mesh,
    *,
    axis: str = "model",
    num_microbatches: int | None = None,
):
    """Run ``stage_fn`` S times as a pipeline over mesh axis ``axis``.

    stage_params: tree with leading stage dim (S, …) on every leaf.
    x: (B, …) global batch (replicated across the pipeline axis).
    stage_fn(params_slice, x_mb) -> y_mb with y_mb.shape == x_mb.shape.
    Returns (B, …) outputs equivalent to sequentially applying all stages.
    """
    s = mesh.shape[axis]
    b = x.shape[0]
    m = num_microbatches or s
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    mb = b // m
    xmb = x.reshape(m, mb, *x.shape[1:])

    def local(params_loc, xmb_):
        idx = axis_index(axis)
        p_slice = tree.tree_map(lambda a: a[0], params_loc)
        buf = torch.zeros_like(xmb_[0])
        ys = []
        for t in range(m + s - 1):
            # stage 0 ingests microbatch t (clamped; masked at the end),
            # stages k>0 consume the activation handed over last tick.
            x_in = xmb_[min(max(t, 0), m - 1)] if idx == 0 else buf
            y = stage_fn(p_slice, x_in)
            buf = ppermute(y, axis, [(i, i + 1) for i in range(s - 1)])
            ys.append(y)
        # microbatch j completes on the LAST stage at tick j + s - 1
        outs = torch.stack(ys[s - 1:])                    # (M, mb, …)
        if idx != s - 1:
            outs = torch.zeros_like(outs)
        return psum(outs, axis)                           # broadcast result

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            tree.tree_map(lambda _: P(axis), stage_params),
            P(*((None,) * xmb.ndim)),
        ),
        out_specs=P(*((None,) * xmb.ndim)),
    )
    out = fn(stage_params, xmb)
    return out.reshape(b, *x.shape[1:])
