"""The benchmark's frozen arithmetic: FLOPs and bytes from shapes.

Every number here follows from a configuration file's published sizes and a
traffic mix's batch shape, never from the program under test, so a change to
the program cannot change what its kernels are measured against.

* A GEMM ``(m, k) @ (k, n)`` does ``2·m·k·n`` FLOPs and moves each operand
  once and its result once.
* Attention does ``2·D`` FLOPs for each of QKᵀ and PV per (query, key) pair
  the inputs need: ``S·(S+1)/2`` pairs a (batch, head) when causal.  It moves
  q, k, v and the output once.
* The SSD within-chunk term (Mamba-2) does ``2·(N + P)`` FLOPs per causal
  (query, key) pair of a chunk, ``Q·(Q+1)/2`` pairs a (batch·head, chunk)
  cell.  It moves x and the output once a (batch·head, chunk) cell, B and
  C once a (batch·group, chunk) cell (the heads of a group share them), in
  the configuration's dtype, and the cumulative log-decays once, in
  float32: the least bytes the function needs, whatever layout or dtype a
  kernel is fed.

A kernel's ideal time is ``max(FLOPs / peak FLOP/s, bytes / peak bytes/s)``
with the peak of its operands' type (:data:`PEAKS`).  :func:`forward_work`
lists one forward's launches of work by family (``gemm``, ``attention``,
``ssd``) and :func:`model_flops` its matmul FLOPs, the numerator of ``mfu``.
A configuration family that is not here adds a module ``work_<family>.py``
beside this one with a ``forward_work(config, batch, seq)`` of its own, and
a ``model_flops(config, batch, seq)`` where its forward has matmul FLOPs
outside its items (an SSM's inter-chunk terms).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

__all__ = ["PEAKS", "attention", "forward_work", "gemm", "ideal_seconds",
           "model_flops", "padded_vocab", "ssd_diag"]

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates without sparsity,
# at the full 700 W power limit).  f32 operands take the TF32 tensor-core
# rate: the highest rate the card has for them, so no f32 kernel can read
# above its roofline.
PEAKS = {
    "bfloat16": 989e12,
    "float32": 494.7e12,
    "hbm_bytes_per_s": 3.35e12,
}
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def gemm(name: str, m: int, k: int, n: int, dtype: str = "bfloat16",
         out_dtype: str = "") -> Dict:
    """One ``(m, k) @ (k, n)`` product in ``dtype``, result in
    ``out_dtype`` (default ``dtype``)."""
    size, out = _ITEMSIZE[dtype], _ITEMSIZE[out_dtype or dtype]
    return {"family": "gemm", "name": name, "dtype": dtype,
            "flops": 2.0 * m * k * n,
            "bytes": float((m * k + k * n) * size + m * n * out)}


def attention(b: int, hq: int, hkv: int, s: int, d: int, *, causal: bool,
              dtype: str = "bfloat16") -> Dict:
    """Softmax attention of ``hq`` query heads over ``hkv`` key/value heads
    (GQA), ``s`` queries against ``s`` keys of width ``d``."""
    pairs = s * (s + 1) // 2 if causal else s * s
    size = _ITEMSIZE[dtype]
    return {"family": "attention", "name": "attention", "dtype": dtype,
            "flops": 4.0 * b * hq * pairs * d,
            "bytes": float(size * (2 * b * hq * s * d + 2 * b * hkv * s * d))}


def ssd_diag(batch: int, heads: int, groups: int, chunks: int, q: int,
             p: int, n: int, dtype: str = "bfloat16") -> Dict:
    """The SSD within-chunk term ``Y = (L ∘ C Bᵀ) X`` over ``batch·heads``
    sequences of ``chunks`` chunks of ``q`` rows, head width ``p``, state
    width ``n``, with B and C shared by the ``heads / groups`` heads of a
    group."""
    pairs = q * (q + 1) // 2
    size = _ITEMSIZE[dtype]
    rows = batch * chunks * q
    return {"family": "ssd", "name": "ssd_diag", "dtype": dtype,
            "flops": 2.0 * batch * heads * chunks * pairs * (n + p),
            "bytes": float(size * rows * (2 * heads * p + 2 * groups * n)
                           + _ITEMSIZE["float32"] * rows * heads)}


def ideal_seconds(item: Dict) -> float:
    """The least time the card could take for one item of work."""
    return max(item["flops"] / PEAKS[item["dtype"]],
               item["bytes"] / PEAKS["hbm_bytes_per_s"])


def padded_vocab(config: Dict) -> int:
    """The rows of the embedding as run: ``vocab_size`` rounded up to
    ``pad_vocab_size_multiple`` where the configuration has one."""
    v, mult = config["vocab_size"], config.get("pad_vocab_size_multiple", 1)
    return -(-v // mult) * mult


def _dense_decoder(config: Dict, batch: int, seq: int) -> List[Dict]:
    d = config["hidden_size"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or d // hq
    ff, v = config["intermediate_size"], padded_vocab(config)
    t, dt = batch * seq, config["torch_dtype"]
    layer = [
        gemm("qkv", t, d, (hq + 2 * hkv) * hd, dt),
        attention(batch, hq, hkv, seq, hd, causal=True, dtype=dt),
        gemm("o", t, hq * hd, d, dt),
        gemm("gate", t, d, ff, dt),
        gemm("up", t, d, ff, dt),
        gemm("down", t, ff, d, dt),
    ]
    return layer * config["num_hidden_layers"] + [gemm("head", t, d, v, dt)]


def _mamba2(config: Dict, batch: int, seq: int) -> List[Dict]:
    d, dt = config["d_model"], config["torch_dtype"]
    di = config["expand"] * d
    p, n, g = config["headdim"], config["d_state"], config["ngroups"]
    h, q = di // p, min(config["chunk_size"], seq)
    t = batch * seq
    layer = [
        gemm("z", t, d, di, dt), gemm("x", t, d, di, dt),
        gemm("b", t, d, g * n, dt), gemm("c", t, d, g * n, dt),
        gemm("dt", t, d, h, dt, out_dtype="float32"),
        ssd_diag(batch, h, g, seq // q, q, p, n, dt),
        gemm("out", t, di, d, dt),
    ]
    return layer * config["n_layer"] + [gemm("head", t, d,
                                             padded_vocab(config), dt)]


_FAMILIES = {"dense_decoder": _dense_decoder, "mamba2": _mamba2}


def forward_work(config: Dict, batch: int, seq: int) -> List[Dict]:
    """One forward's items of work, in launch order."""
    family = config["family"]
    fn = _FAMILIES.get(family)
    if fn is None:
        fn = importlib.import_module(f"portbench.work_{family}").forward_work
    return fn(config, batch, seq)


def _ssd_between_chunks(config: Dict, batch: int, seq: int) -> float:
    """Matmul FLOPs of the SSD outside the within-chunk term: each chunk's
    final state (``Q·N·P`` products a cell) and the states' contribution to
    the outputs (as many)."""
    di = config["expand"] * config["d_model"]
    p, n = config["headdim"], config["d_state"]
    h = di // p
    return 2.0 * 2.0 * batch * h * seq * n * p * config["n_layer"]


def model_flops(config: Dict, batch: int, seq: int) -> float:
    """Matmul FLOPs of one forward as the inputs need them: every item of
    :func:`forward_work`, and for an SSM the inter-chunk state products.
    A family whose ``work_<family>.py`` defines ``model_flops(config,
    batch, seq)`` counts its own."""
    family = config["family"]
    if family not in _FAMILIES:
        own = getattr(importlib.import_module(f"portbench.work_{family}"),
                      "model_flops", None)
        if own is not None:
            return own(config, batch, seq)
    total = sum(w["flops"] for w in forward_work(config, batch, seq))
    if family == "mamba2":
        total += _ssd_between_chunks(config, batch, seq)
    return total
