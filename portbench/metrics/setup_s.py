"""Seconds from the start of the process to the first timed forward: the
imports, the kernels' build (or load), the weights and the warm-up."""


def read(r):
    return r.setup_s
