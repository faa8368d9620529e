"""Plain float32 forward of granite-4.0-h (``model_type``
``granitemoehybrid``: IBM Granite 4.0-H, a hybrid of Mamba-2 mixers and
attention with a mixture of experts in every layer).

The published block, with m_emb = ``embedding_multiplier``, m_res =
``residual_multiplier``, m_att = ``attention_multiplier`` and s_log =
``logits_scaling``:

    x = m_emb · E[tokens]
    for each layer i:  h = RMSNorm(x) · g1
                       mix = Mamba2(h)                   if layer_types[i] == "mamba"
                             softmax(m_att · q kᵀ + causal mask) v · Wo
                                                          if "attention"
                             (q, k, v = h Wq, h Wk, h Wv; grouped-query heads;
                              no position embedding: "nope")
                       x = x + m_res · mix
                       h = RMSNorm(x) · g2
                       l = h W_router;  T = top-k(l) (k = num_experts_per_tok)
                       moe = Σ_{e ∈ T} softmax(l_T)_e · (SiLU(h Wg_e) ∘ h Wu_e) Wd_e
                       shared = (SiLU(h Wg_s) ∘ h Wu_s) Wd_s
                       x = x + m_res · (moe + shared)
    logits = (RMSNorm(x) · g) Eᵀ / s_log                (tied embeddings)

Mamba2 is the published mixer of ``reference/mamba2.py`` (in-projection to
z, x, B, C and dt; the causal depthwise conv with bias and SiLU; softplus(dt
+ dt_bias); the SSD scan in chunks of ``mamba_chunk_size``; the D skip; the
gated RMSNorm of y ∘ SiLU(z); the out-projection), here with one group of
B and C for the 128 heads.  The attention is written out here, since
``reference/dense_decoder.py``'s rotates by RoPE and fixes the scale at
head_dim ** -0.5.  The router softmaxes its top-k logits, which
equals a softmax over all logits renormalised over the top-k.  Every routed
copy reaches its expert (no capacity; a loop over the experts).  The whole
stream is float32, with TF32 off; weights are upcast one matmul at a time
(``common.matmul``).  The forward runs one prompt (batch row) at a time:
every piece of the block acts on one sequence or one token, so the rows are
independent, and a row's activations (4096 tokens) are a quarter of a
4 × 4096 batch's.  Departures: none in the equations; the cut (the first
``num_hidden_layers`` of the published layers) is the configuration file's.
Weights are read from the tree the benchmark hands to the program (the
hybrid stack's super-blocks ``stack[b]["sub{j}"]``, layer ``b · P + j``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import mamba2
from portbench.reference.common import matmul, no_tf32, rms_norm

__all__ = ["forward"]


def _mamba_config(config: Dict) -> Dict:
    """The mixer's sizes under ``reference/mamba2.py``'s names."""
    return {"d_model": config["hidden_size"], "expand": config["mamba_expand"],
            "d_state": config["mamba_d_state"],
            "ngroups": config["mamba_n_groups"],
            "headdim": config["mamba_d_head"],
            "chunk_size": config["mamba_chunk_size"],
            "norm_epsilon": config["rms_norm_eps"]}


def _attention(ap, h, config, precision):
    """NoPE causal grouped-query attention of one sequence, h (1, S, d)."""
    s = h.shape[1]
    hd = config["head_dim"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    group = hq // hkv
    q = matmul(h[0], ap["wq"], precision).view(s, hkv, group, hd)
    k = matmul(h[0], ap["wk"], precision).view(s, hkv, hd)
    v = matmul(h[0], ap["wv"], precision).view(s, hkv, hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(s, hkv, group, hd, dtype=torch.float32, device=h.device)
    for g in range(hkv):
        qg = q[:, g].transpose(0, 1)                          # (G, S, D)
        scores = matmul(qg, k[:, g].T, precision) \
            * config["attention_multiplier"]
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        out[:, g] = matmul(probs, v[:, g], precision).transpose(0, 1)
    return matmul(out.view(1, s, hq * hd), ap["wo"], precision)


def _swiglu(x, wg, wu, wd, precision):
    return matmul(F.silu(matmul(x, wg, precision)) * matmul(x, wu, precision),
                  wd, precision)


def _moe(fp, h, config, precision):
    """Routed experts (every copy, no capacity) and the shared expert."""
    t = h.reshape(-1, h.shape[-1])
    k = config["num_experts_per_tok"]
    logits = matmul(t, fp["router"], precision)               # (T, E)
    top, idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    # Each copy's weighted output in its own slot, summed over k after the
    # loop: the same sum on every run (no atomics).
    parts = torch.zeros(t.shape[0], k, t.shape[1], dtype=torch.float32,
                        device=t.device)
    for e in range(config["num_local_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = _swiglu(t[tok], fp["we_gate"][e], fp["we_up"][e],
                        fp["we_down"][e], precision)
            parts[tok, slot] = y * gates[tok, slot, None]
    sh = fp["dense"]
    out = parts.sum(1) + _swiglu(t, sh["w_gate"], sh["w_up"], sh["w_down"],
                                 precision)
    return out.reshape(h.shape)


def _row(params, tokens, config, precision):
    """One prompt (1, S) -> logits (1, S, V)."""
    eps, m_res = config["rms_norm_eps"], config["residual_multiplier"]
    kinds, period = config["layer_types"], config["attn_layer_period"]
    mcfg = _mamba_config(config)
    x = params["embed"][tokens].float() * config["embedding_multiplier"]
    for i, kind in enumerate(kinds):
        lp = params["stack"][i // period][f"sub{i % period}"]
        h = rms_norm(x, lp["norm1"]["scale"], eps)
        if kind == "attention":
            mix = _attention(lp["mixer"], h, config, precision)
        else:
            mix = mamba2._mixer(lp["mixer"], h, mcfg, precision)
        x = x + m_res * mix
        del h, mix
        h = rms_norm(x, lp["norm2"]["scale"], eps)
        x = x + m_res * _moe(lp["ffn"], h, config, precision)
        del h
    h = rms_norm(x, params["final_norm"]["scale"], eps)
    return matmul(h, params["embed"].T, precision) / config["logits_scaling"]


def forward(params: Dict, tokens: torch.Tensor, config: Dict,
            precision: str = "float32") -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32."""
    with no_tf32(), torch.no_grad():
        out = None
        for b in range(tokens.shape[0]):
            row = _row(params, tokens[b:b + 1], config, precision)
            if out is None:
                out = row.new_empty((tokens.shape[0], *row.shape[1:]))
            out[b:b + 1] = row
            del row
        return out
