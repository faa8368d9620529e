"""Mamba-2 mixer in SSD (state-space duality) form.

SSD recasts the selective-SSM recurrence as chunked matmuls.  The whole
chunked core (within-chunk quadratic term, inter-chunk state recurrence,
D skip) is one registered ``ssd_scan`` descriptor, given B and C once a
group: its host lowering is the plain torch composition, its kernel
lowering runs the whole core on hand-written kernels
(``kernels/csrc/ssd_mma.cuh``) that read x, B and C in place.
Projections go through ``blas.matmul`` and the gate through ``blas.silu``;
the depthwise causal conv and its SiLU through ``blas.causal_conv_silu``
(one hand-written kernel on the card, ``csrc/mamba_conv.cuh``); the gating
stays elementwise glue.  This file has no raw ``torch.matmul`` launch site.

Decode is the one-step recurrence on a (B, H, N, P) fp32 state cache, O(1)
per token.  Unlike the reference (functional updates), the new ssm and conv
states are written into the given cache tensors in place, as the port's KV
cache is.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import blas
from repro_torch.models import layers as L

__all__ = ["init_mamba", "mamba_block", "decode_mamba_block",
           "mamba_state_shapes", "ssd_inputs", "conv_and_inputs"]


def init_mamba(gen: torch.Generator, cfg, dtype, *, device):
    """The reference's distributions: dense weights N(0, 1)·fan_in**-0.5,
    ``conv_w`` N(0, 1)·0.2, ``dt_bias`` / ``a_log`` zeros and ``d_skip``
    ones in fp32 (so a = −1), zero conv bias, unit norm scale."""
    d = cfg.d_model
    di = cfg.d_inner
    h = cfg.ssm_num_heads
    g, n = cfg.ssm_num_groups, cfg.ssm_state_dim
    cw = cfg.ssm_conv_width
    conv_feat = di + 2 * g * n
    p = {
        "wz": L.init_dense(gen, d, di, dtype, device=device),
        "wx": L.init_dense(gen, d, di, dtype, device=device),
        "wb": L.init_dense(gen, d, g * n, dtype, device=device),
        "wc": L.init_dense(gen, d, g * n, dtype, device=device),
        "wdt": L.init_dense(gen, d, h, dtype, device=device),
        "dt_bias": torch.zeros(h, dtype=torch.float32, device=device),
        "a_log": torch.zeros(h, dtype=torch.float32, device=device),
        "d_skip": torch.ones(h, dtype=torch.float32, device=device),
    }
    conv_w = torch.randn(cw, conv_feat, generator=gen, dtype=torch.float32,
                         device=device)
    p["conv_w"] = (conv_w * 0.2).to(dtype)
    p["conv_b"] = torch.zeros(conv_feat, dtype=dtype, device=device)
    p["norm"] = L.init_norm(di, dtype, device=device)
    p["wo"] = L.init_dense(gen, di, d, dtype, device=device)
    return p


def _project(p, x):
    z = blas.matmul(x, p["wz"])
    xin = blas.matmul(x, p["wx"])
    b_ = blas.matmul(x, p["wb"])
    c_ = blas.matmul(x, p["wc"])
    dt = blas.matmul(x, p["wdt"], out_dtype=torch.float32)
    return z, xin, b_, c_, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a linear cut-over (jax.nn.softplus)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_conv(conv_out: torch.Tensor, cfg):
    di, gn = cfg.d_inner, cfg.ssm_num_groups * cfg.ssm_state_dim
    return (conv_out[..., :di], conv_out[..., di:di + gn],
            conv_out[..., di + gn:])


def ssd_inputs(p, xin, b_, c_, dt, cfg):
    """Shape the conv outputs into the ``ssd_scan`` operands: x per head
    (B, S, H, P), B and C once a group (B, S, G, N), all views of the
    conv's output, which the kernels read in place."""
    bsz, s = xin.shape[0], xin.shape[1]
    h, pdim = cfg.ssm_num_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_num_groups, cfg.ssm_state_dim
    dt_f = _softplus(dt + p["dt_bias"])                      # (B, S, H) fp32
    a = -torch.exp(p["a_log"])                               # (H,)
    xh = xin.reshape(bsz, s, h, pdim)
    bg = b_.reshape(bsz, s, g, n)
    cg = c_.reshape(bsz, s, g, n)
    return xh, dt_f, a, bg, cg


def conv_and_inputs(p, xin, b_, c_, dt, cfg):
    """Causal conv + SiLU of the x/B/C projections (``blas.
    causal_conv_silu``: one kernel on the card), then the ``ssd_scan``
    operands.  Shared by the eager block and the graph block."""
    conv_out = blas.causal_conv_silu(xin, b_, c_, p["conv_w"], p["conv_b"])
    return ssd_inputs(p, *_split_conv(conv_out, cfg), dt, cfg)


def mamba_block(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence SSD pass. x: (B, S, D) -> (B, S, D).

    Every heavy piece dispatches through a descriptor: the five input
    projections (``matmul``), the chunked SSD core (``ssd_scan``: its plan
    shards the heads over an ambient mesh's model axis) and the output
    projection (``matmul`` with the ``tp_mode="row"`` single-psum TP
    form)."""
    bsz, s, _ = x.shape
    z, xin, b_, c_, dt = _project(p, x)
    xh, dt_f, a, bg, cg = conv_and_inputs(p, xin, b_, c_, dt, cfg)
    y = blas.ssd_scan(xh, dt_f, a, bg, cg, p["d_skip"], chunk=cfg.ssm_chunk)
    y = y.reshape(bsz, s, cfg.d_inner)
    y = y * blas.silu(z.float())
    y = L.rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    return blas.matmul(y, p["wo"], tp_mode="row")


def mamba_state_shapes(cfg, batch: int):
    """(ssm_state, conv_state) shapes for the decode cache."""
    h, n, pdim = cfg.ssm_num_heads, cfg.ssm_state_dim, cfg.ssm_head_dim
    conv_feat = cfg.d_inner + 2 * cfg.ssm_num_groups * cfg.ssm_state_dim
    return (batch, h, n, pdim), (batch, cfg.ssm_conv_width - 1, conv_feat)


def decode_mamba_block(
    p, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor], cfg
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token recurrence. x: (B, 1, D); state: (ssm (B, H, N, P) fp32,
    conv (B, K−1, F)).  Writes the new states into ``state`` in place and
    returns them with the block output."""
    bsz = x.shape[0]
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token, got x {tuple(x.shape)}")
    h, pdim = cfg.ssm_num_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_num_groups, cfg.ssm_state_dim
    ssm_state, conv_state = state

    z, xin, b_, c_, dt = _project(p, x)
    u = torch.cat([xin, b_, c_], dim=-1)[:, 0, :]             # (B, F)
    hist = torch.cat([conv_state, u[:, None, :].to(conv_state.dtype)], dim=1)
    w = p["conv_w"].float()
    conv_out = torch.einsum("bkf,kf->bf", hist.float(), w)
    conv_out = F.silu(conv_out + p["conv_b"].float())
    xin, b1, c1 = _split_conv(conv_out, cfg)

    dt = _softplus(dt[:, 0] + p["dt_bias"])                   # (B, H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a)                                 # (B, H)

    xh = xin.reshape(bsz, h, pdim)
    rep = h // g
    bh_ = b1.reshape(bsz, g, n).repeat_interleave(rep, dim=1)  # (B, H, N)
    ch_ = c1.reshape(bsz, g, n).repeat_interleave(rep, dim=1)

    new_state = (decay[..., None, None] * ssm_state
                 + torch.einsum("bh,bhn,bhp->bhnp", dt, bh_, xh))
    y = torch.einsum("bhn,bhnp->bhp", ch_, new_state)         # (B, H, P)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, cfg.d_inner)
    y = y * F.silu(z.float())
    y = L.rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    ssm_state.copy_(new_state)
    conv_state.copy_(hist[:, 1:, :])
    return blas.matmul(y, p["wo"]), (ssm_state, conv_state)
