"""The routed experts' GEMM kernel's share of its roofline in the traced
forwards: the ideal time of the forward's ``expert_gemm`` items
(``work_granitemoehybrid.expert_gemm``: the R = T·k routed rows' FLOPs,
bytes of the rows, each expert's weights once and the outputs), times the
traced forwards, over the device time of the kernels named in
``expert_gemm_roofline.prefill.json``'s ``grouped_kernels``, in percent
(``metrics.roofline_share``'s rule).  None where the trace has no such
kernel or the forward no such work."""

from portbench import metrics
from portbench.work import ideal_seconds

NAME = "expert_gemm_roofline.prefill"


def read(r):
    if r.trace is None:
        return None
    spec = metrics.data(NAME)
    ideal = r.traced_forwards * sum(ideal_seconds(w) for w in r.forward_work
                                    if w["family"] == spec["family"])
    seconds = r.trace.op_seconds(spec["grouped_kernels"])
    if ideal <= 0 or seconds <= 0:
        return None
    return 100.0 * ideal / seconds
