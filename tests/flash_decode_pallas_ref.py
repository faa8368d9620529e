"""A long-cache decode case with the reference Pallas flash decode's outputs.

The split flash-decode kernels run only on a CUDA card, and the machine
with the card has no JAX.  So the reference's ``flash_decode`` (interpret
mode) is run here once per dtype and its outputs are kept in
``tests/data/flash_decode_pallas.npz``: ``test_torch_flash_decode.py``
checks on the CPU that the file still holds what the reference computes,
and ``test_torch_kernels_gpu.py`` holds the card's kernels against it.

The case: GQA 8:1 (8 q heads on one kv head), D 128, a cache of S = 1024
slots (a multiple of the reference's 256-slot block, so its block stays
whole), which the port's plan cuts into four splits of 256 slots.  Its
rows cover the whole cache, a ragged range, a rolling window (lo > 0,
hi = S), an empty range (lo == hi: output exactly 0), a few slots at the
start, and a range inside one split (the other three splits of that row
have nothing to read).  bf16 (the tensor-core kernel) and f32 (the
CUDA-core kernel).  Inputs come from numpy with one seed, so either side
makes the same operands.  This module imports numpy only; regenerate the
file with::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/flash_decode_pallas_ref.py
"""

import pathlib

import numpy as np

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / \
    "flash_decode_pallas.npz"
HQ, HKV, S, D = 8, 1, 1024, 128
BOUNDS = [(0, S), (37, 700), (600, S), (500, 500), (0, 5), (300, 500)]
EMPTY_ROWS = [i for i, (lo, hi) in enumerate(BOUNDS) if hi <= lo]
DTYPES = ("bfloat16", "float32")


def inputs():
    """q (B, HQ, D), k and v (B, HKV, S, D) as float32 numpy (rounded to
    the dtype by whichever side uses them), lo and hi (B,) int32."""
    rng = np.random.default_rng(2024)
    b = len(BOUNDS)
    q = rng.normal(size=(b, HQ, D)).astype(np.float32)
    k = rng.normal(size=(b, HKV, S, D)).astype(np.float32)
    v = rng.normal(size=(b, HKV, S, D)).astype(np.float32)
    lo = np.array([x for x, _ in BOUNDS], np.int32)
    hi = np.array([y for _, y in BOUNDS], np.int32)
    return q, k, v, lo, hi


def pallas_outputs():
    """{dtype: the reference Pallas flash decode's output as float32}:
    interpret mode on the CPU (imports JAX and the reference)."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    q, k, v, lo, hi = inputs()
    out = {}
    for dtype in DTYPES:
        dt = getattr(jnp, dtype)
        got = jops.flash_decode(jnp.asarray(q, dt), jnp.asarray(k, dt),
                                jnp.asarray(v, dt), jnp.asarray(lo),
                                jnp.asarray(hi), interpret=True)
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
