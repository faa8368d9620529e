"""granite-4.0-h's items of work a forward, and its model FLOPs (see
``work.py`` for the rules: every number from the configuration file's
published sizes and the batch shape, never from the program).

A Mamba-2 layer is its five in-projections (z, x, B, C and dt, the last
written in float32), the SSD's within-chunk term (``ssd_diag``) and the
out-projection; an attention layer its fused q/k/v projection, causal
attention (no position embedding changes no count) and the o-projection.
Every layer then runs the router (float32 logits), the shared expert's
three GEMMs and the routed experts' three products, a family of their own,
``expert_gemm``: over the R = T·k routed rows (T tokens, k experts each),
whatever the routing, each projection does ``2·R·d_in·d_out`` FLOPs and
needs its input rows once, each expert's weights once and its output rows
once.  The tied head closes the forward.  :func:`model_flops` adds the SSD's
inter-chunk state products to the items' FLOPs, as ``work.py`` does for
``mamba2``.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.work import _ITEMSIZE, attention, gemm, padded_vocab, ssd_diag

__all__ = ["expert_gemm", "forward_work", "model_flops"]


def expert_gemm(name: str, rows: int, experts: int, k: int, n: int,
                dtype: str = "bfloat16") -> Dict:
    """One routed-expert projection: ``rows`` rows, each through one of
    ``experts`` (k, n) matrices, ``(rows, k) @ (k, n)`` in all."""
    size = _ITEMSIZE[dtype]
    return {"family": "expert_gemm", "name": name, "dtype": dtype,
            "flops": 2.0 * rows * k * n,
            "bytes": float((rows * k + experts * k * n + rows * n) * size)}


def _sizes(config: Dict):
    d = config["hidden_size"]
    di = config["mamba_expand"] * d
    return d, di, di // config["mamba_d_head"]


def forward_work(config: Dict, batch: int, seq: int) -> List[Dict]:
    d, di, h = _sizes(config)
    dt = config["torch_dtype"]
    t = batch * seq
    p, n = config["mamba_d_head"], config["mamba_d_state"]
    g = config["mamba_n_groups"]
    q = min(config["mamba_chunk_size"], seq)
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["head_dim"]
    e, k = config["num_local_experts"], config["num_experts_per_tok"]
    f, fs = config["intermediate_size"], config["shared_intermediate_size"]
    rows = t * k
    mamba = [
        gemm("z", t, d, di, dt), gemm("x", t, d, di, dt),
        gemm("b", t, d, g * n, dt), gemm("c", t, d, g * n, dt),
        gemm("dt", t, d, h, dt, out_dtype="float32"),
        ssd_diag(batch, h, g, seq // q, q, p, n, dt),
        gemm("out", t, di, d, dt),
    ]
    attn = [
        gemm("qkv", t, d, (hq + 2 * hkv) * hd, dt),
        attention(batch, hq, hkv, seq, hd, causal=True, dtype=dt),
        gemm("o", t, hq * hd, d, dt),
    ]
    ffn = [
        gemm("router", t, d, e, dt, out_dtype="float32"),
        expert_gemm("expert_gate", rows, e, d, f, dt),
        expert_gemm("expert_up", rows, e, d, f, dt),
        expert_gemm("expert_down", rows, e, f, d, dt),
        gemm("shared_gate", t, d, fs, dt), gemm("shared_up", t, d, fs, dt),
        gemm("shared_down", t, fs, d, dt),
    ]
    items: List[Dict] = []
    for kind in config["layer_types"]:
        items += (attn if kind == "attention" else mamba) + ffn
    return items + [gemm("head", t, d, padded_vocab(config), dt)]


def model_flops(config: Dict, batch: int, seq: int) -> float:
    """Matmul FLOPs of one forward as the inputs need them: every item,
    and each Mamba-2 layer's inter-chunk state products (each chunk's final
    state and the states' contribution to the outputs, ``2·Q·N·P``
    products a (batch·head, chunk) cell)."""
    _, _, h = _sizes(config)
    p, n = config["mamba_d_head"], config["mamba_d_state"]
    mixers = sum(kind == "mamba" for kind in config["layer_types"])
    between = 2.0 * 2.0 * batch * h * seq * n * p * mixers
    return sum(w["flops"] for w in forward_work(config, batch, seq)) + between
