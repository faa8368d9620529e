"""One reader a metric: ``metrics/<name>.py`` defines ``read(readings)``,
which returns the metric's value, or None where the run holds nothing for it
to read (the harness then leaves the metric out of the result line).  A
reader's data (kernel-name families, say) lies beside it in
``metrics/<name>.json``.  :func:`load` finds a reader by the metric's name.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Callable, Dict

__all__ = ["data", "load"]

HERE = pathlib.Path(__file__).resolve().parent


def load(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def data(name: str) -> Dict:
    """``metrics/<name>.json``."""
    return json.loads((HERE / f"{name}.json").read_text())


def roofline_share(r, name: str):
    """A kernel family's roofline share in the traced forwards, in percent:
    the ideal time of the family's work (``work.ideal_seconds`` of each
    item of ``data(name)["family"]`` in a forward, times the traced
    forwards) over the device time of the kernels named in
    ``data(name)["kernels"]``.  None where the trace has no such kernel or
    the forward no such work."""
    from portbench.work import ideal_seconds

    if r.trace is None:
        return None
    spec = data(name)
    ideal = r.traced_forwards * sum(ideal_seconds(w) for w in r.forward_work
                                    if w["family"] == spec["family"])
    seconds = r.trace.op_seconds(spec["kernels"])
    if ideal <= 0 or seconds <= 0:
        return None
    return 100.0 * ideal / seconds
