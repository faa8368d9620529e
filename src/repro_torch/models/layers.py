"""Shared model layers. Every contraction goes through the BLAS seam."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import blas

__all__ = [
    "rms_norm",
    "layer_norm",
    "rope",
    "mrope",
    "mlp_apply",
    "init_dense",
    "init_mlp",
    "init_norm",
]


# ---------------------------------------------------------------------------
# init helpers (explicit generator and device)
# ---------------------------------------------------------------------------

def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """(d_in, d_out) weight: N(0, 1) in fp32 scaled by ``d_in**-0.5``, cast
    once (the reference's distribution; different random numbers)."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn(d_in, d_out, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def init_norm(d: int, dtype, *, device, kind: str = "rmsnorm"):
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device)}
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# norms (fp32 internals)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """RMSNorm through the registered ``rmsnorm_scale`` descriptor."""
    return blas.rmsnorm_scale(x, p["scale"], eps=eps)


def layer_norm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """LayerNorm (the audio encoder's): fp32 mean and population variance,
    scale and bias in fp32, one rounding to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def apply_norm(x, p, eps, kind: str):
    return rms_norm(x, p, eps) if kind == "rmsnorm" else layer_norm(x, p, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int; theta: scalar."""
    d = x.shape[-1]
    half = d // 2
    theta = torch.as_tensor(theta, dtype=torch.float32, device=x.device)
    inv_freq = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * inv_freq     # (B, S, half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    return _rope_rotate(x.float(), sin, cos).to(x.dtype)


def mrope(x: torch.Tensor, positions: torch.Tensor, theta,
          sections=(2, 3, 3)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); positions: (3, B, S) —
    the temporal / height / width streams.  The rotary half-dim is split
    into contiguous bands in the ratio ``sections`` (the last band takes the
    remainder), each rotated by its own stream; identical streams reduce to
    :func:`rope`."""
    d = x.shape[-1]
    half = d // 2
    theta = torch.as_tensor(theta, dtype=torch.float32, device=x.device)
    inv_freq = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    total = sum(sections)
    bounds, start = [], 0
    for s in sections:
        size = (half * s) // total
        bounds.append((start, start + size))
        start += size
    bounds[-1] = (bounds[-1][0], half)
    ang = torch.cat(
        [positions[i].to(torch.float32)[..., None] * inv_freq[lo:hi]
         for i, (lo, hi) in enumerate(bounds)], dim=-1)    # (B, S, half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    return _rope_rotate(x.float(), sin, cos).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU) — dense FFN through the BLAS seam
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype, kind: str, *,
             device):
    if kind == "swiglu":
        return {
            "w_gate": init_dense(gen, d, d_ff, dtype, device=device),
            "w_up": init_dense(gen, d, d_ff, dtype, device=device),
            "w_down": init_dense(gen, d_ff, d, dtype, device=device),
        }
    return {
        "w_up": init_dense(gen, d, d_ff, dtype, device=device),
        "b_up": torch.zeros(d_ff, dtype=dtype, device=device),
        "w_down": init_dense(gen, d_ff, d, dtype, device=device),
        "b_down": torch.zeros(d, dtype=dtype, device=device),
    }


def mlp_apply(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Dense FFN through the registered ``mlp_block`` descriptor: one
    dispatch, one record, placement always threaded."""
    if kind == "swiglu":
        return blas.mlp_block(
            x, p["w_up"], p["w_down"], gate=p["w_gate"], kind="swiglu"
        )
    return blas.mlp_block(
        x, p["w_up"], p["w_down"], b_up=p["b_up"], b_down=p["b_down"],
        kind="gelu",
    )
