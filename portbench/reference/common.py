"""Pieces shared by the plain forwards: TF32 off, RMSNorm, and matmuls in
float32 or in float8 e4m3 with float32 accumulation."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["PRECISIONS", "fp8_round", "matmul", "no_tf32", "rms_norm"]

PRECISIONS = ("float32", "fp8")
_E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` in float32 after rounding to float8 e4m3, scaled by the largest
    magnitude along ``dim`` (the contraction dimension: one scale a row of
    activations, a column of weights)."""
    t = t.float()
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / _E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` over the last two dims in float32; with ``fp8`` both
    operands are rounded to e4m3 first."""
    if precision == "fp8":
        return fp8_round(a, -1) @ fp8_round(b, -2)
    if precision != "float32":
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return a.float() @ b.float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()
