"""Device time in operations that are not the program's own kernels (torch's
elementwise and reduction kernels, copies, sets), as a share of all device
time in the traced forwards, in percent.  The program's kernels are named
in ``glue_share.prefill.json``."""

from portbench.metrics import data


def read(r):
    if r.trace is None:
        return None
    total = r.trace.op_seconds()
    if total <= 0:
        return None
    own = data("glue_share.prefill")["program_kernels"]
    return 100.0 * r.trace.op_seconds(own, exclude=True) / total
