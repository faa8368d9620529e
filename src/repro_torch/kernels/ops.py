"""Lowering table: op name -> hand-written kernel entry point.

The device half of the declarative registry (``repro_torch.core.dispatch``):
an :class:`~repro_torch.core.dispatch.OffloadOp` descriptor's ``kernel``
adapter fetches its kernel here by name, so the op table and the kernel
table stay in one-to-one view.  It has one row for each name whose kernel
exists in the port; the reference's other rows (``moe_gemm`` and
``moe_expert_ffn``, wrappers over the batched GEMM that arrive with the
MoE slice, and ``ssd_chunk_diag`` / ``ssd_scan``, which arrive with the SSD
kernel) are listed in ROADMAP.md.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.gemm import gemm, gemm_batched

__all__ = ["KERNEL_LOWERINGS", "kernel_lowering"]

KERNEL_LOWERINGS = {
    "gemm": gemm,
    "gemm_batched": gemm_batched,    # the hnp scheduler's stacked GEMMs
    "matmul": gemm,                  # leading dims collapse to GEMM m
    "qkv_project": gemm,             # concatenated-weight projection GEMM
    "attention": flash_attention,
    "decode_attention": flash_decode,
}


def kernel_lowering(name: str):
    try:
        return KERNEL_LOWERINGS[name]
    except KeyError:
        raise KeyError(
            f"no kernel lowering for op {name!r}; have {sorted(KERNEL_LOWERINGS)}"
        ) from None
