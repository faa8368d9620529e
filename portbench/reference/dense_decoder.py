"""Plain float32 forward of a Llama-architecture dense decoder (Yi-6B).

The published equations (Touvron et al. 2023; Yi, arXiv:2403.04652):

    x = E[tokens]
    for each layer:  h = RMSNorm(x) · g1
                     q, k, v = h Wq, h Wk, h Wv;  RoPE on q and k
                     x = x + softmax(q kᵀ / √d_head + causal mask) v · Wo
                     h = RMSNorm(x) · g2
                     x = x + (SiLU(h Wg) ∘ h Wu) Wd
    logits = (RMSNorm(x) · g) Wout

with grouped-query attention (each key/value head serves
``num_attention_heads / num_key_value_heads`` query heads) and rotate-half
RoPE, ``θ_i = rope_theta^(−2i/d_head)``.  Departures: none in the
equations; the angles are computed in float64 before their sine and cosine.
Weights are read from the tree the benchmark hands to the program
(``embed``, ``stack[i]["mixer"]`` ``wq / wk / wv / wo``, ``stack[i]["ffn"]``
``w_gate / w_up / w_down``, the norms' ``scale``, ``final_norm``, ``head``),
as (in, out) matrices, and upcast layer by layer.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.common import matmul, no_tf32, rms_norm

__all__ = ["forward"]


def _rope_tables(seq: int, hd: int, theta: float, device):
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=device) / hd)
    ang = torch.arange(seq, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., S, d_head)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _attention(q, k, v, precision):
    """Causal softmax attention of one sequence: q (G, S, D) query heads of
    one key/value head, k and v (S, D).  float32 scores and softmax."""
    s, d = q.shape[-2], q.shape[-1]
    scores = matmul(q, k.T, precision) * d ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return matmul(probs, v, precision)


def forward(params: Dict, tokens: torch.Tensor, config: Dict,
            precision: str = "float32") -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32."""
    with no_tf32(), torch.no_grad():
        return _forward(params, tokens, config, precision)


def _forward(params, tokens, config, precision):
    d = config["hidden_size"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or d // hq
    group, eps = hq // hkv, config["rms_norm_eps"]
    b, s = tokens.shape
    cos, sin = _rope_tables(s, hd, float(config["rope_theta"]), tokens.device)
    x = params["embed"][tokens].float()                        # (B, S, d)
    for lp in params["stack"]:
        att, ffn = lp["mixer"], lp["ffn"]
        h = rms_norm(x, lp["norm1"]["scale"], eps)
        q = matmul(h, att["wq"], precision).view(b, s, hq, hd)
        k = matmul(h, att["wk"], precision).view(b, s, hkv, hd)
        v = matmul(h, att["wv"], precision).view(b, s, hkv, hd)
        out = torch.empty(b, s, hq, hd, dtype=torch.float32, device=x.device)
        for i in range(b):
            for g in range(hkv):
                qg = _rotate(q[i, :, g * group:(g + 1) * group].transpose(0, 1),
                             cos, sin)
                kg = _rotate(k[i, :, g], cos, sin)
                out[i, :, g * group:(g + 1) * group] = _attention(
                    qg, kg, v[i, :, g], precision).transpose(0, 1)
        del q, k, v
        x = x + matmul(out.view(b, s, hq * hd), att["wo"], precision)
        del out
        h = rms_norm(x, lp["norm2"]["scale"], eps)
        gate = torch.nn.functional.silu(matmul(h, ffn["w_gate"], precision))
        up = matmul(h, ffn["w_up"], precision)
        del h
        x = x + matmul(gate * up, ffn["w_down"], precision)
        del gate, up
    h = rms_norm(x, params["final_norm"]["scale"], eps)
    return matmul(h, params["head"], precision)
