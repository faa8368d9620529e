"""Int8 error-feedback gradient compression for the data-parallel
all-reduce.

The twin of ``src/repro/optim/compression.py``: each gradient leaf is
quantized to int8 with a per-leaf fp32 scale and the quantization error
kept in a local error-feedback buffer, added back the next step.

  * ``compress_decompress`` — quantize -> dequantize with error feedback:
    the numerics of the compressed all-reduce, in one process.
  * ``compressed_psum`` — the int8 psum itself, inside a ``shard_map``
    body (:mod:`repro_torch.sharding.spmd`): a shared scale by ``pmax``,
    an int32 psum over ``axis_name``, then dequantize.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree
from repro_torch.sharding import spmd

__all__ = ["init_error_buffer", "compress_decompress", "compressed_psum"]


def init_error_buffer(grads) -> Any:
    return tree.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)


def _quant_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(g)) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(g / safe), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads, err) -> Tuple[Any, Any]:
    """Returns (compressed-then-restored grads, new error buffers)."""

    def leaf(g, e):
        gf = g.float() + e
        q, scale = _quant_leaf(gf)
        deq = q.float() * scale
        return deq.to(g.dtype), gf - deq

    outs = [leaf(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(err))]
    return (tree.unflatten(grads, (o[0] for o in outs)),
            tree.unflatten(grads, (o[1] for o in outs)))


def compressed_psum(grads, err, axis_name: str) -> Tuple[Any, Any]:
    """int8 psum over ``axis_name`` with error feedback (in a ``shard_map``
    body).

    The quantization scale is SHARED across participants before
    quantizing (one scalar pmax per leaf) — summing int8 payloads
    quantized at per-device scales and rescaling afterwards is not a sum.
    Returns (the summed, dequantized grads, the new error buffers)."""

    def leaf(g, e):
        gf = g.float() + e
        local_scale = torch.amax(torch.abs(gf)) / 127.0
        scale = spmd.pmax(local_scale, axis_name)          # scalar exchange
        safe = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(gf / safe), -127, 127).to(torch.int8)
        # int32 accumulate avoids overflow for <= 2^24 participants
        tot = spmd.psum(q.to(torch.int32), axis_name)
        deq = tot.float() * safe
        local_restored = q.float() * safe
        return deq.to(g.dtype), gf - local_restored

    outs = [leaf(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(err))]
    return (tree.unflatten(grads, (o[0] for o in outs)),
            tree.unflatten(grads, (o[1] for o in outs)))
