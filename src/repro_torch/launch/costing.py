"""Costed serving-step helpers shared by the batch and streaming paths.

``launch/serve.py`` (lock-step batch drain) and ``launch/streaming.py``
(continuous batching) place the same two units of work on the cluster — a
prefill over prompt tokens and decode over generated tokens — and both
collapse the model stack to one GEMM-shaped
:class:`~repro_torch.core.cost_model.OpCost` the scheduler can weigh: every
token runs the stack's GEMMs, so ``tokens x d_model x d_model`` batched over
``num_layers`` is the workload shape.  This module is the single home of
that shape math (``_prefill_cost`` / ``_decode_cost`` in serve.py are thin
adapters over it).  The streaming path arrives with the streaming slice.

The streaming engine additionally needs *per-step* decode costs (one token
per active slot per step, weights re-streamed from device memory every
step) and byte estimates for KV handles — all derived from the same config
fields, never from live arrays, so the whole streaming simulation runs
without building a model.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import cost_model as cm

__all__ = [
    "ITEMSIZE",
    "decode_cost",
    "decode_step_cost",
    "kv_bytes_per_token",
    "prefill_cost",
    "stack_gemm_cost",
    "weight_bytes",
    "weight_resident_fraction",
]

# Serving activations/weights are modeled bf16 (gemm_cost itemsize=2),
# whatever dtype the model runs in: the reference's shape math, so both
# packages score placement with identical breakdowns.
ITEMSIZE = 2


def stack_gemm_cost(tokens: int, cfg, *, op: str) -> cm.OpCost:
    """The serving workload unit: ``tokens`` through the stack's GEMMs.

    One ``tokens x d_model x d_model`` GEMM batched over ``num_layers`` —
    the collapse both serve paths score placement with.  ``staged_bytes``
    includes the per-layer weight panels (a cold lane pays them; resident
    weights are credited via ``resident_fraction`` at issue time)."""
    d = cfg.d_model
    return cm.gemm_cost(
        max(int(tokens), 1), d, d, ITEMSIZE,
        batch=max(cfg.num_layers, 1), op=op,
    )


def prefill_cost(prompt_tokens: int, cfg, *, op: str = "serve_prefill") -> cm.OpCost:
    """Modeled prefill workload: every prompt token runs the stack's GEMMs."""
    return stack_gemm_cost(prompt_tokens, cfg, op=op)


def decode_cost(
    tokens: int, cache_bytes: float, cfg, *, op: str = "serve_decode"
) -> cm.OpCost:
    """Modeled lock-step decode workload — *including the KV cache in staged
    bytes*.

    Decode streams the whole cache every step, so a device already holding
    it (pinned handle) skips that share of the copy region.  This is the
    asymmetry the ``cost-aware`` scheduler keys on to route decode batches
    to the cache-holding device."""
    base = stack_gemm_cost(tokens, cfg, op=op)
    return dataclasses.replace(
        base,
        staged_bytes=base.staged_bytes + cache_bytes,
        touched_bytes=base.touched_bytes + cache_bytes,
    )


def decode_step_cost(
    batch: int, cfg, *, cache_bytes: float = 0.0, op: str = "serve_decode_step"
) -> cm.OpCost:
    """One continuous-batching decode step: ``batch`` live tokens through
    the stack.

    Weights and every active request's KV cache are device-resident on the
    decode lane (the slot-refill path migrated the handle there), so they
    ride ``touched_bytes`` — the per-step weight re-stream is what makes a
    step memory-bound and batch width nearly free — while only the step's
    token activations (in) and logits row (out) cross the host link as
    ``staged_bytes``."""
    base = stack_gemm_cost(batch, cfg, op=op)
    act_bytes = 2.0 * max(int(batch), 1) * cfg.d_model * ITEMSIZE
    return dataclasses.replace(
        base,
        staged_bytes=act_bytes,
        touched_bytes=base.touched_bytes + float(cache_bytes),
    )


def kv_bytes_per_token(cfg) -> float:
    """Modeled KV/state bytes one cached token occupies (K + V per layer)."""
    return 2.0 * max(cfg.num_layers, 1) * cfg.d_model * ITEMSIZE


def weight_bytes(cfg) -> float:
    """Bytes of the modeled stack weights (one d x d panel per layer)."""
    return float(max(cfg.num_layers, 1)) * cfg.d_model * cfg.d_model * ITEMSIZE


def weight_resident_fraction(cost: cm.OpCost, cfg) -> float:
    """Share of ``cost.staged_bytes`` that is resident stack weights.

    The streaming engine pins the weights on every lane at server start, so
    a prefill/decode launch only stages its activations; this is the exact
    per-call residency credit threaded through ``assign_at``."""
    if cost.staged_bytes <= 0:
        return 0.0
    return min(weight_bytes(cfg) / cost.staged_bytes, 1.0)
