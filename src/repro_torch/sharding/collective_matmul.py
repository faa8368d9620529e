"""Collective matmul: overlap the TP all-gather with partial matmuls.

The twin of ``src/repro/sharding/collective_matmul.py``.  Instead of

    x_full = all_gather(x_shard);  y = x_full @ w_shard

each of the N ring steps multiplies the chunk currently held while
``ppermute``-ing the next one around the ring (Wang et al., "Overlap
communication with dependent computation", ASPLOS'23).  Each tick's local
product is the GEMM kernel at the chunk's shape (``blas.local_matmul``:
no record, as the reference's raw product) with fp32 accumulation and
one rounding to the chunk's dtype.  On the emulated mesh the ring is a chain
of copies in one memory, so nothing overlaps: the form and its numbers
are the reference's, not its speed.
"""

from __future__ import annotations

import torch

from repro_torch.core import blas
from repro_torch.sharding import spmd

__all__ = ["ring_ag_matmul"]


def ring_ag_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                   axis: str) -> torch.Tensor:
    """y = concat_ring(x_shard) @ w, the gather interleaved with compute.

    x_shard: (B, S/N, D) — this device's contraction/sequence shard;
    w:       (D, F_loc) — this device's weight slice (any column shard);
    returns  (B, S, F_loc) with rows ordered by source device.

    Must be called inside a ``shard_map`` body.
    """
    n = spmd.axis_size(axis)
    idx = spmd.axis_index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]  # ring

    def dot(u):
        return blas.local_matmul(u, w, out_dtype=u.dtype)

    chunk = x_shard
    ys, srcs = [], []
    for t in range(n):
        ys.append(dot(chunk))                        # compute on what we hold...
        nxt = spmd.ppermute(chunk, axis, perm)       # ...while the ring moves
        # chunk at tick t originated at device (idx - t) mod n
        srcs.append((idx - t) % n)
        chunk = nxt
    # reorder ticks into source order: out[src[t]] = ys[t]
    ys = torch.stack([ys[srcs.index(j)] for j in range(n)])  # (N, B, S/N, F)
    nb, b, sl, f = ys.shape
    return ys.transpose(0, 1).reshape(b, nb * sl, f)
