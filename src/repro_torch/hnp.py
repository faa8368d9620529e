"""``repro_torch.hnp`` — the lazy NumPy-like frontend (alias of
:mod:`repro_torch.frontend.api`).

::

    import repro_torch.hnp as hnp

    h = hnp.tanh(hnp.array(x) @ w1)   # x lands on the card
    y = h @ w2                        # nothing has executed yet
    out = hnp.asnumpy(y)              # the whole graph lowers onto the cluster

On the CPU: ``hnp.array(x, device="cpu")`` (numpy operands then join the
graph's device).  Any op registered in
:mod:`repro_torch.core.dispatch` is reachable here by name (``hnp.gemm``,
``hnp.attention``, ...) — resolved lazily against the registry, so new
descriptors appear with zero frontend changes.
"""

from repro_torch.frontend.api import *  # noqa: F401,F403
from repro_torch.frontend import api as _api
from repro_torch.frontend.api import __all__  # noqa: F401


def __getattr__(name: str):
    # Delegate unknown names to the api module's registry passthrough.
    return getattr(_api, name)
