"""Step functions.  Only the serve step is ported so far; the train and
prefill steps arrive with the training and flash-attention slices."""

from __future__ import annotations

from repro_torch.models.model import Model

__all__ = ["make_serve_step"]


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens, cache_index):
        return model.decode_step(params, cache, tokens, cache_index)

    return serve_step
