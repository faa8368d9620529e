"""Step functions: the train step (microbatched gradient accumulation and
the optimizer's update), the prefill step (the full-sequence forward) and
the serve step (one decode token).

``make_train_step`` returns ``train_step(params, opt_state, err, batch) ->
(params, opt_state, err, {"loss": ...})``, as the reference's does
(``src/repro/launch/steps.py``), with:

  * sequential gradient accumulation over ``cfg.num_microbatches``
    (activations live for one microbatch only), summed in
    ``cfg.accum_dtype`` and averaged; microbatch j takes the rows b·nmb + j
    of the batch (the batch factor major, as the reference splits it);
  * optional int8 error-feedback gradient compression
    (``TrainOptions.compress_grads``);
  * AdamW or blockwise-int8 AdamW keyed by the arch config.

Gradients come from autograd over the eager forward; with
``use_kernels`` on, every kernel launch of the forward runs inside an
autograd Function (:mod:`repro_torch.kernels.autograd`).  The reference
traces its microbatch body once under ``lax.scan`` and scales its records
by the microbatch count (``accounting.scaled``); the eager loop here runs
and records every microbatch itself, so it scales nothing: count-weighted
record totals equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import tree
from repro_torch.models.model import Model
from repro_torch.obs.spans import measured
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import make_optimizer
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["TrainOptions", "init_train_state", "make_prefill_step",
           "make_serve_step", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False


def _split_microbatches(batch: Dict[str, torch.Tensor], nmb: int):
    """(B, …) -> (nmb, B/nmb, …); 'positions' is (3, B, S) -> (nmb, 3,
    B/nmb, S).  The batch factor stays major: microbatch j holds rows
    b·nmb + j, as the reference's ``(B,) -> (B/nmb, nmb) -> moveaxis``
    gives them (a plain ``reshape(nmb, B/nmb)`` would give other
    microbatches, and other losses per microbatch)."""

    def leaf(key, x):
        axis = 1 if key == "positions" else 0
        b = x.shape[axis]
        if b % nmb:
            raise ValueError(f"batch {b} % microbatches {nmb} != 0")
        y = x.reshape(*x.shape[:axis], b // nmb, nmb, *x.shape[axis + 1:])
        return torch.movedim(y, axis + 1, 0)

    return {k: leaf(k, v) for k, v in batch.items()}


def init_train_state(model: Model, params, opts: TrainOptions):
    """(opt_state, error_feedback_buffers_or_None)."""
    opt_init, _ = make_optimizer(
        model.cfg, warmup_cosine(opts.peak_lr, opts.warmup_steps,
                                 opts.total_steps))
    opt_state = opt_init(params)
    err = C.init_error_buffer(params) if opts.compress_grads else None
    return opt_state, err


def _value_and_grad(model: Model, params, batch):
    """(loss, grads with params' structure) of ``model.loss``; a leaf the
    loss does not reach gets zeros, as JAX's grad gives it."""
    flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss = model.loss(tree.unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), tree.unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)])


def _loss_and_grads(model: Model, params, batch):
    """(loss, grads) of one train step before its update: the mean over
    ``cfg.num_microbatches`` microbatches, gradients summed in
    ``cfg.accum_dtype`` (with one microbatch: the gradient itself, in the
    params' dtype, as the reference's ``value_and_grad`` gives it)."""
    cfg = model.cfg
    nmb = cfg.num_microbatches
    if nmb == 1:
        return _value_and_grad(model, params, batch)
    accum_dtype = getattr(torch, cfg.accum_dtype)
    mbs = _split_microbatches(batch, nmb)
    grads, losses = None, []
    for j in range(nmb):
        loss_j, g = _value_and_grad(model, params,
                                    {k: v[j] for k, v in mbs.items()})
        losses.append(loss_j)
        if grads is None:
            grads = tree.tree_map(lambda x: x.to(accum_dtype), g)
        else:   # our own buffers: summed in place
            tree.tree_map(lambda a, x: a.add_(x), grads, g)
        del g
    for a in tree.leaves(grads):
        a.div_(nmb)
    return torch.mean(torch.stack(losses)), grads


def make_train_step(model: Model, opts: TrainOptions = TrainOptions()):
    cfg = model.cfg
    if cfg.forward_mode != "eager":
        raise ValueError(
            f"train step: forward_mode={cfg.forward_mode!r} is not "
            f"differentiable here (an hnp graph runs its ops outside "
            f"autograd); train with forward_mode='eager'")
    _, opt_update = make_optimizer(
        cfg, warmup_cosine(opts.peak_lr, opts.warmup_steps, opts.total_steps))

    def train_step(params, opt_state, err, batch):
        loss, grads = _loss_and_grads(model, params, batch)
        with torch.no_grad():
            if err is not None:
                grads, err = C.compress_decompress(grads, err)
            new_params, new_opt = opt_update(grads, opt_state, params)
        return new_params, new_opt, err, {"loss": loss.float()}

    return train_step


def make_prefill_step(model: Model):
    """``prefill_step(params, batch) -> logits (B, S, V)``: one
    ``Model.forward`` over the whole prompt.  ``batch`` is the reference's
    dict (``tokens`` (B, S) int or ``embeds`` (B, S, D), optional
    ``positions``) or a (B, S) token tensor.  Under ``torch.profiler`` a
    call is one ``step:prefill`` range."""
    def prefill_step(params, batch):
        with measured("step", "prefill"):
            return model.forward(params, batch)[0]

    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens, cache_index):
        return model.decode_step(params, cache, tokens, cache_index)

    return serve_step
