"""Step functions: the prefill step (the full-sequence forward) and the
serve step (one decode token).  The train step arrives with the training
slice."""

from __future__ import annotations

from repro_torch.models.model import Model

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(model: Model):
    """``prefill_step(params, tokens) -> logits (B, S, V)``: one
    ``Model.forward`` over the whole prompt (tokens (B, S) int)."""
    def prefill_step(params, tokens):
        return model.forward(params, tokens)[0]

    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens, cache_index):
        return model.decode_step(params, cache, tokens, cache_index)

    return serve_step
