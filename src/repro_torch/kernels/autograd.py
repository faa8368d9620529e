"""Gradients through the hand-written kernels.

The kernels are ``ctypes`` launches into outputs the wrappers allocate, so
autograd cannot see through them: a launch under grad would return an
output with no ``grad_fn`` and lose the gradient without an error.  This
module has no twin in the reference, which takes its gradients by tracing
its plain ops (it has no ``custom_vjp``, and its policy keeps the Pallas
kernels off by default).  :func:`lowering` hands the BLAS seam
(:mod:`repro_torch.core.blas`) each row of the lowering table
(:mod:`repro_torch.kernels.ops`) wrapped so that, whenever grad mode is on
and an input requires grad, the launch runs inside a
``torch.autograd.Function`` — on the CPU as well, where the forward is the
kernel's plain version, so the CPU tests exercise each backward:

* the GEMM rows (``gemm``, ``matmul``, ``qkv_project``; ``gemm_batched``,
  ``moe_gemm``, ``moe_expert_ffn`` batched): the backward of a product is
  products, two more launches of the same kernel, dA = dC·Bᵀ (Bᵀ a K-major
  view, which the kernel reads in place) and dB = Aᵀ·dC (Aᵀ copied
  row-major, so that a bf16 product stays on the tensor-core ``wgmma``
  route and does not fall to the CUDA-core ``tiled`` one, which takes a
  column-major A; dB contracts over m, the tokens, which ``wgmma`` reads
  in 8-element units, so a token count off a multiple of 8 still takes
  ``tiled``).  The launches count in the kernel's counters; they go
  through no dispatch, so they write no trace record, as the reference's
  autodiff writes none;
* ``attention`` and the SSD rows (``ssd_chunk_diag``; ``ssd_scan``, the
  whole SSD core, :func:`repro_torch.kernels.ssd_scan.ssd_scan`): no
  backward kernel is owed (the reference has none); the kernel stays the
  forward, and the backward recomputes the plain version
  (:mod:`repro_torch.kernels.ref`; the whole core's
  :func:`~repro_torch.kernels.ref.ssd_scan_ref`) under autograd from the
  saved inputs;
* ``decode_attention`` is on no train path: under grad it raises.

The Mamba-2 mixer's causal conv + SiLU is no row of the table (the BLAS
seam's ``causal_conv_silu`` helper calls its wrapper directly);
:func:`causal_conv_silu` gives it the SSD rows' treatment: the kernel is the
forward and the backward recomputes the plain version.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import ref

__all__ = ["causal_conv_silu", "lowering"]


def _needs_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def _product(fn: Callable, x: torch.Tensor, y: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """``fn(x, y)`` (a GEMM row) on operands of one dtype: an output
    gradient of a wider dtype than the forward's operands widens both."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return fn(x.to(dt), y.to(dt), out_dtype=out_dtype)


class _Gemm(torch.autograd.Function):
    """C = A @ B for (m, k) @ (k, n), or (Z, m, k) @ (Z, k, n) with a
    batched ``fn``."""

    @staticmethod
    def forward(ctx, fn, a, b, out_dtype):
        ctx.fn = fn
        ctx.save_for_backward(a, b)
        return fn(a, b, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[1]:
            da = _product(ctx.fn, dc, b.transpose(-1, -2), a.dtype)
        if ctx.needs_input_grad[2]:
            db = _product(ctx.fn, a.transpose(-1, -2).contiguous(), dc,
                          b.dtype)
        return None, da, db, None


def _recompute(plain: Callable, saved, needs, dout, *args):
    """Gradients of ``plain(*saved, *args)`` for the saved inputs whose
    ``needs`` is set, by autograd of the plain version."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*inputs, *args)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, dout))
    return [next(grads) if n else None for n in needs]


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, q, k, v, causal, window, sm_scale):
        ctx.args = (causal, window, sm_scale)
        ctx.save_for_backward(q, k, v)
        return fn(q, k, v, causal=causal, window=window, sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, dout):
        causal, window, sm_scale = ctx.args

        def plain(q, k, v):
            return ref.attention_ref(q, k, v, causal=causal, window=window,
                                     sm_scale=sm_scale)

        grads = _recompute(plain, ctx.saved_tensors,
                           ctx.needs_input_grad[1:4], dout)
        return (None, *grads, None, None, None)


class _SsdChunkDiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, x, dt_a, b, c):
        ctx.save_for_backward(x, dt_a, b, c)
        return fn(x, dt_a, b, c)

    @staticmethod
    def backward(ctx, dy):
        grads = _recompute(ref.ssd_chunk_diag_ref, ctx.saved_tensors,
                           ctx.needs_input_grad[1:5], dy)
        return (None, *grads)


class _CausalConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, x, b, c, w, bias):
        ctx.save_for_backward(x, b, c, w, bias)
        return fn(x, b, c, w, bias)

    @staticmethod
    def backward(ctx, dout):
        grads = _recompute(ref.causal_conv_silu_ref, ctx.saved_tensors,
                           ctx.needs_input_grad[1:6], dout)
        return (None, *grads)


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, xh, dt, a, bh, ch, d_skip, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(xh, dt, a, bh, ch, d_skip)
        return fn(xh, dt, a, bh, ch, d_skip, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        grads = _recompute(ref.ssd_scan_ref, ctx.saved_tensors,
                           ctx.needs_input_grad[1:7], dy, ctx.chunk)
        return (None, *grads, None)


def _gemm_call(fn):
    def call(a, b, *, out_dtype=None):
        if not _needs_grad((a, b)):
            return fn(a, b, out_dtype=out_dtype)
        return _Gemm.apply(fn, a, b, out_dtype)
    return call


def _attention_call(fn):
    def call(q, k, v, *, causal=True, window=None, sm_scale=None):
        if not _needs_grad((q, k, v)):
            return fn(q, k, v, causal=causal, window=window,
                      sm_scale=sm_scale)
        return _Attention.apply(fn, q, k, v, causal, window, sm_scale)
    return call


def _ssd_call(fn):
    def call(x, dt_a, b, c):
        if not _needs_grad((x, dt_a, b, c)):
            return fn(x, dt_a, b, c)
        return _SsdChunkDiag.apply(fn, x, dt_a, b, c)
    return call


def _ssd_scan_call(fn):
    def call(xh, dt, a, bh, ch, d_skip, *, chunk):
        if not _needs_grad((xh, dt, a, bh, ch, d_skip)):
            return fn(xh, dt, a, bh, ch, d_skip, chunk=chunk)
        return _SsdScan.apply(fn, xh, dt, a, bh, ch, d_skip, chunk)
    return call


def _no_grad_call(name):
    def wrap(fn):
        def call(*args, **kwargs):
            if _needs_grad(args):
                raise RuntimeError(
                    f"{name}: the kernel has no gradient and is on no train "
                    f"path; call it under torch.no_grad()")
            return fn(*args, **kwargs)
        return call
    return wrap


_RULES = {
    "gemm": _gemm_call,
    "matmul": _gemm_call,
    "qkv_project": _gemm_call,
    "gemm_batched": _gemm_call,
    "moe_gemm": _gemm_call,
    "moe_expert_ffn": _gemm_call,
    "attention": _attention_call,
    "ssd_chunk_diag": _ssd_call,
    "ssd_scan": _ssd_scan_call,
    "decode_attention": _no_grad_call("decode_attention"),
}


def lowering(name: str) -> Callable:
    """Row ``name`` of the lowering table, differentiable under grad."""
    from repro_torch.kernels import ops  # the table's current row

    fn = ops.kernel_lowering(name)
    return _RULES[name](fn)


def causal_conv_silu(x, b, c, w, bias):
    """The conv kernel's wrapper (:func:`repro_torch.kernels.ssd_scan.
    causal_conv_silu`: the kernel on the card, its plain version on CPU
    tensors), differentiable under grad."""
    from repro_torch.kernels.ssd_scan import causal_conv_silu as fn

    if not _needs_grad((x, b, c, w, bias)):
        return fn(x, b, c, w, bias)
    return _CausalConv.apply(fn, x, b, c, w, bias)
