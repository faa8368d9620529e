"""Host ms a traced forward inside the calls that ``host_syncs.prefill``
counts, inside ``step:prefill``.  None where the program opens no such
range."""

from portbench.spans import host_syncs, per_step


def read(r):
    return per_step(r.trace, lambda steps: 1e-3 * sum(
        e - s for _, s, e in host_syncs(r.trace, steps)))
