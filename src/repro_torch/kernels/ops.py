"""Lowering table: op name -> hand-written kernel entry point.

The device half of the declarative registry (``repro_torch.core.dispatch``):
an :class:`~repro_torch.core.dispatch.OffloadOp` descriptor's ``kernel``
adapter fetches its kernel here by name, so the op table and the kernel
table stay in one-to-one view.  It has every row of the reference's table
(``src/repro/kernels/ops.py``).  ``moe_gemm`` and ``moe_expert_ffn`` (the
capacity-grouped expert GEMM and the grouped expert FFN's three GEMMs)
are the batched GEMM itself, experts as the batch, as the reference maps
both to ``pallas_gemm_batched``: their launches count in
``gemm_batched.launches`` and ``gemm_batched.route_launches``.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.gemm import gemm, gemm_batched
from repro_torch.kernels.ssd_scan import ssd_chunk_diag

__all__ = ["KERNEL_LOWERINGS", "kernel_lowering"]

KERNEL_LOWERINGS = {
    "gemm": gemm,
    "gemm_batched": gemm_batched,    # the hnp scheduler's stacked GEMMs
    "matmul": gemm,                  # leading dims collapse to GEMM m
    "qkv_project": gemm,             # concatenated-weight projection GEMM
    "attention": flash_attention,
    "decode_attention": flash_decode,
    "ssd_chunk_diag": ssd_chunk_diag,
    "ssd_scan": ssd_chunk_diag,      # within-chunk quadratic term
    "moe_gemm": gemm_batched,        # (E, C, d) @ (E, d, f), experts the batch
    "moe_expert_ffn": gemm_batched,  # gate/up/down grouped expert GEMMs
}


def kernel_lowering(name: str):
    try:
        return KERNEL_LOWERINGS[name]
    except KeyError:
        raise KeyError(
            f"no kernel lowering for op {name!r}; have {sorted(KERNEL_LOWERINGS)}"
        ) from None
