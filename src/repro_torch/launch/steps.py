"""Step functions: the prefill step (the full-sequence forward) and the
serve step (one decode token).  The train step arrives with the training
slice."""

from __future__ import annotations

from repro_torch.models.model import Model

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(model: Model):
    """``prefill_step(params, batch) -> logits (B, S, V)``: one
    ``Model.forward`` over the whole prompt.  ``batch`` is the reference's
    dict (``tokens`` (B, S) int or ``embeds`` (B, S, D), optional
    ``positions``) or a (B, S) token tensor."""
    def prefill_step(params, batch):
        return model.forward(params, batch)[0]

    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens, cache_index):
        return model.decode_step(params, cache, tokens, cache_index)

    return serve_step
