"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``) on one
H100: full-width prefill of its configurations under closed-loop traffic.

``run.py`` runs one cell once; ``BENCHMARK.json`` at the repository's root
names the cells, configurations and metrics, and the harness finds each
one's files by name: ``configs/<name>.json`` (published sizes and the
limits of ``correct``), ``traffic/<mix>.json``, ``metrics/<metric>.py``,
``reference/<family>.py`` (the plain float32 forward).  ``work.py`` holds
the frozen FLOP and byte arithmetic.  Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of the program.
"""
