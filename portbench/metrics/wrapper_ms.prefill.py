"""Host ms a traced forward spent in the hand-written kernels' wrappers,
from the route to the launch's return: inside ``step:prefill``, the time
whose innermost open range among ``dispatch:``, ``lower:`` and ``kernel:``
is a ``kernel:`` range.  None where the program opens no such range."""

from portbench.spans import time_under


def read(r):
    return time_under(r.trace, "kernel")
