"""Plain float32 forward of Mamba-2 (Dao and Gu, arXiv:2405.21060).

The published block, with the state-space-dual (SSD) form of the scan as
the paper's minimal listing (``ssd_minimal_discrete``) gives it:

    x = E[tokens]
    for each layer:  h = RMSNorm(x) · g1
                     z, xBC, dt = h W_in        (W_in split as Wz, [Wx Wb Wc], Wdt)
                     xBC = SiLU(causal depthwise conv1d(xBC) + b_conv)
                     X, B, C = split(xBC)       (heads of P, groups of N)
                     dt = softplus(dt + dt_bias);  A = −exp(A_log)
                     Y = SSD(X·dt, A·dt, B, C; chunk Q) + D · X
                     x = x + RMSNorm(Y ∘ SiLU(z)) · g_y  W_out
    logits = (RMSNorm(x) · g) Eᵀ              (tied embeddings)

SSD per chunk of Q steps: the within-chunk term (L ∘ C Bᵀ) X with
L[i, j] = exp(Σ_{j<t≤i} a_t) for j ≤ i, each chunk's final state, the
recurrence of states between chunks, and the states' contribution to the
outputs.  Departures: none in the equations; the residual stream is float32
here, as the published ``residual_in_fp32`` keeps it.  Weights are read from
the tree the benchmark hands to the program (``stack[i]["mixer"]`` ``wz, wx,
wb, wc, wdt, wo, conv_w (K, F), conv_b, dt_bias, a_log, d_skip`` and
``norm``), as (in, out) matrices.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.common import matmul, no_tf32, rms_norm

__all__ = ["forward", "ssd"]

_BATCH_BLOCK = 4


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): Σ_{j<t≤i} a_t below the diagonal, −inf above
    (the paper's stable form: a masked cumulative sum, no differences)."""
    t = a.shape[-1]
    rep = a[..., None].expand(*a.shape, t)                   # [..., i, j] = a_i
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    seg = torch.cumsum(rep.masked_fill(~below, 0.0), dim=-2)
    keep = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def ssd(x, a, b, c, chunk: int, precision: str = "float32"):
    """x (B, L, H, P), a (B, L, H) log-decays, b and c (B, L, H, N) ->
    y (B, L, H, P), starting from a zero state."""
    bsz, length, h, p = x.shape
    q = min(chunk, length)
    nc = length // q
    x, b, c = (t.reshape(bsz, nc, q, h, t.shape[-1]) for t in (x, b, c))
    a = a.reshape(bsz, nc, q, h).permute(0, 3, 1, 2)         # (B, H, C, Q)
    a_cum = torch.cumsum(a, dim=-1)
    # 1. within each chunk
    scores = matmul(c.permute(0, 3, 1, 2, 4),                # (B, H, C, Q, N)
                    b.permute(0, 3, 1, 4, 2), precision)     # -> (B, H, C, Q, Q)
    scores = scores * torch.exp(_segsum(a))
    y = matmul(scores, x.permute(0, 3, 1, 2, 4), precision)  # (B, H, C, Q, P)
    # 2. each chunk's final state
    decay = torch.exp(a_cum[..., -1:] - a_cum)               # (B, H, C, Q)
    states = matmul((b.permute(0, 3, 1, 4, 2) * decay[:, :, :, None, :]),
                    x.permute(0, 3, 1, 2, 4), precision)     # (B, H, C, N, P)
    # 3. between chunks
    states = torch.cat([torch.zeros_like(states[:, :, :1]), states], dim=2)
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    entering = torch.einsum("bhzc,bhcnp->bhznp", chunk_decay, states)[:, :, :-1]
    # 4. states to outputs
    y = y + matmul(c.permute(0, 3, 1, 2, 4), entering, precision) \
        * torch.exp(a_cum)[..., None]
    return y.permute(0, 2, 3, 1, 4).reshape(bsz, length, h, p)


def _conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Causal depthwise conv1d of u (B, L, F) with w (K, F)."""
    k, feats = w.shape
    out = F.conv1d(F.pad(u.transpose(1, 2), (k - 1, 0)),
                   w.float().T[:, None, :], bias.float(), groups=feats)
    return out.transpose(1, 2)


def _mixer(mp, h, config, precision):
    bsz, length, _ = h.shape
    n, g, p = config["d_state"], config["ngroups"], config["headdim"]
    di = config["expand"] * config["d_model"]
    heads = di // p
    z = matmul(h, mp["wz"], precision)
    xbc = torch.cat([matmul(h, mp[w], precision) for w in ("wx", "wb", "wc")],
                    dim=-1)
    dt = F.softplus(matmul(h, mp["wdt"], precision) + mp["dt_bias"].float())
    xbc = F.silu(_conv(xbc, mp["conv_w"], mp["conv_b"]))
    xs = xbc[..., :di].reshape(bsz, length, heads, p)
    bs = xbc[..., di:di + g * n].reshape(bsz, length, g, n)
    cs = xbc[..., di + g * n:].reshape(bsz, length, g, n)
    bs = bs.repeat_interleave(heads // g, dim=2)
    cs = cs.repeat_interleave(heads // g, dim=2)
    a = -torch.exp(mp["a_log"].float())
    y = torch.empty_like(xs)
    for i in range(0, bsz, _BATCH_BLOCK):
        blk = slice(i, i + _BATCH_BLOCK)
        y[blk] = ssd(xs[blk] * dt[blk, ..., None], a * dt[blk], bs[blk],
                     cs[blk], config["chunk_size"], precision)
    y = y + xs * mp["d_skip"].float()[:, None]
    y = y.reshape(bsz, length, di) * F.silu(z)
    y = rms_norm(y, mp["norm"]["scale"], config["norm_epsilon"])
    return matmul(y, mp["wo"], precision)


def forward(params: Dict, tokens: torch.Tensor, config: Dict,
            precision: str = "float32") -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32."""
    with no_tf32(), torch.no_grad():
        eps = config["norm_epsilon"]
        x = params["embed"][tokens].float()
        for lp in params["stack"]:
            h = rms_norm(x, lp["norm1"]["scale"], eps)
            x = x + _mixer(lp["mixer"], h, config, precision)
        h = rms_norm(x, params["final_norm"]["scale"], eps)
        return matmul(h, params["embed"].T, precision)
