"""Host ms a traced forward spent in the offload seam itself: inside
``step:prefill``, the time whose innermost open range among ``dispatch:``,
``lower:`` and ``kernel:`` is a ``dispatch:`` range (cost, plan, the
engine's modeled launch and its books; a dispatch nested in another's
lowering counts once).  None where the program opens no such range."""

from portbench.spans import time_under


def read(r):
    return time_under(r.trace, "dispatch")
