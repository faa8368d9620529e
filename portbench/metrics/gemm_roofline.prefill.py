"""The gemm kernel's share of its roofline in the traced forwards (see
``metrics.roofline_share``; kernel names in ``gemm_roofline.prefill.json``)."""

from portbench.metrics import roofline_share


def read(r):
    return roofline_share(r, "gemm_roofline.prefill")
