"""Device time in operations that are not the program's own kernels (torch's
elementwise and reduction kernels, copies, sets), as a share of all device
time in the traced forwards, in percent.  The program's kernels are those
named in ``glue_share.prefill.json`` and in the ``"kernels"`` list of every
other ``metrics/*.json`` (each roofline's), so a new kernel is named once,
in its roofline's file."""

import json

from portbench import metrics


def program_kernels():
    """Every kernel name that counts as the program's own."""
    names = list(metrics.data("glue_share.prefill")["program_kernels"])
    for path in sorted(metrics.HERE.glob("*.json")):
        names += json.loads(path.read_text()).get("kernels", [])
    return names


def read(r):
    if r.trace is None:
        return None
    total = r.trace.op_seconds()
    if total <= 0:
        return None
    return 100.0 * r.trace.op_seconds(program_kernels(), exclude=True) / total
