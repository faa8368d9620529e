"""repro_torch.roofline — roofline terms from counted work: the twin of
``src/repro/roofline/``.

:mod:`~repro_torch.roofline.analysis` holds the terms and the hardware
rows; :mod:`~repro_torch.roofline.op_count` counts a call's work on meta
tensors (the twin of the reference's HLO parser)."""

from repro_torch.roofline.analysis import (
    H100_SXM_HW,
    HW,
    Roofline,
    TPU_V5E_HW,
    parse_collectives,
    roofline_terms,
)

__all__ = ["H100_SXM_HW", "HW", "Roofline", "TPU_V5E_HW",
           "parse_collectives", "roofline_terms"]
