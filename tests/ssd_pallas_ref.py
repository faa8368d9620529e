"""A deep-decay, ragged SSD chunk case with the reference Pallas kernel's outputs.

The SSD chunk kernels run only on a CUDA card, and the machine with the
card has no JAX.  So the reference's ``ssd_chunk_diag`` (interpret mode)
is run here once per dtype and its outputs are kept in
``tests/data/ssd_pallas.npz``: ``test_torch_ssd.py`` checks on the CPU
that the file still holds what the reference computes, and
``test_torch_kernels_gpu.py`` holds the card's kernels against it.

The case: two chunks of Q = 200 rows (not a multiple of the port's 64-row
query tile or 32-key step: four query tiles, the last of 8 rows), P 64
and N 128 (mamba2-370m's head and state dims), and the model's decay
(log-decays from dt ≈ 0.7, reaching about -110 over a chunk).  bf16 and
f32.  Inputs come from numpy with one seed, so either side makes the same
operands.  This module imports numpy only; regenerate the file with::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/ssd_pallas_ref.py
"""

import pathlib

import numpy as np

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "ssd_pallas.npz"
BH, C, Q, P, N = 1, 2, 200, 64, 128
DECAY = 0.7
DTYPES = ("bfloat16", "float32")


def inputs():
    """x (BH, C, Q, P), dta (BH, C, Q), b and c (BH, C, Q, N) as float32
    numpy (rounded to the dtype by whichever side uses them)."""
    rng = np.random.default_rng(2026)
    x = rng.normal(size=(BH, C, Q, P)).astype(np.float32)
    dta = np.cumsum(-np.abs(rng.normal(size=(BH, C, Q))) * DECAY,
                    axis=-1).astype(np.float32)
    b = rng.normal(size=(BH, C, Q, N)).astype(np.float32)
    c = rng.normal(size=(BH, C, Q, N)).astype(np.float32)
    return x, dta, b, c


def pallas_outputs():
    """{dtype: the reference Pallas SSD chunk kernel's output as float32}:
    interpret mode on the CPU (imports JAX and the reference)."""
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import ssd_chunk_diag

    out = {}
    for dtype in DTYPES:
        dt = getattr(jnp, dtype)
        got = ssd_chunk_diag(*(jnp.asarray(a, dt) for a in inputs()),
                             interpret=True)
        out[dtype] = np.asarray(got, np.float32)
    return out


def load():
    """The kept outputs: {dtype: float32 array}."""
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **pallas_outputs())
    print(f"wrote {FIXTURE}")
