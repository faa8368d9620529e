"""Int8 error-feedback gradient compression.

The reference's ``compress_decompress`` (``src/repro/optim/compression.py``):
each gradient leaf quantized to int8 with a per-leaf fp32 scale and
restored, the quantization error kept in a local error-feedback buffer and
added back the next step — the numerics of the compressed data-parallel
all-reduce.  The reference's ``compressed_psum`` (the int8 psum itself)
needs a mesh and arrives with the distributed layer.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree

__all__ = ["init_error_buffer", "compress_decompress"]


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
