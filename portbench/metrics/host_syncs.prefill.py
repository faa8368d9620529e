"""CUDA runtime calls a traced forward that hold the host until the card
catches up (``portbench.spans.SYNCS``: stream, device and event
synchronises, the synchronous ``cudaMemcpy``), inside ``step:prefill``.
None where the program opens no such range."""

from portbench.spans import host_syncs, per_step


def read(r):
    return per_step(r.trace, lambda steps: len(host_syncs(r.trace, steps)))
