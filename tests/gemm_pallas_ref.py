"""GEMM cases with the reference Pallas GEMM's outputs.

The skinny kernels (m <= 16) and the f32 tensor-core kernels (``tf32x3``,
f32 with m > 16) run only on a CUDA card, and the machine with the card
has no JAX.  So the reference's ``pallas_gemm`` (interpret mode) is run
here once per case and its outputs are kept in
``tests/data/gemm_skinny_pallas.npz``: ``test_torch_gemm.py`` checks on
the CPU that the file still holds what the reference computes, and
``test_torch_kernels_gpu.py`` holds the card's kernels against it.

The cases take every skinny kernel: both B layouts (row-major, and a
K-major B the card reads as the transpose of a row-major [n, k]), bf16
(tensor cores) and f32 (CUDA cores), m 1 / 8 / 16, bf16 in with f32 out,
and a k of 1000 that the plan splits into uneven parts with n = 200
ragged against every column tile.  Then f32 at m 17, 100 and 256 with
both B layouts (the tf32x3 route: m off every block tile, k split across
a cluster at the smaller m), and f32 in with bf16 out.  Inputs come from
numpy with one seed per case, so either side makes the same operands.
This module imports numpy only; regenerate the file with::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/gemm_pallas_ref.py
"""

import pathlib

import numpy as np

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / \
    "gemm_skinny_pallas.npz"
K, N = 1000, 200


def _cases():
    out = []
    for dtype in ("bfloat16", "float32"):
        for layout in ("mn", "k"):
            for m in (1, 8, 16):
                out.append((f"{dtype}-{layout}-m{m}", m, layout, dtype, dtype))
    for layout in ("mn", "k"):
        out.append((f"bfloat16-float32-{layout}-m8", 8, layout, "bfloat16",
                    "float32"))
    for m in (17, 100, 256):
        for layout in ("mn", "k"):
            out.append((f"float32-{layout}-m{m}", m, layout, "float32",
                        "float32"))
    out.append(("float32-bfloat16-mn-m100", 100, "mn", "float32", "bfloat16"))
    return out


# (id, m, B layout, input dtype, output dtype), every case K x N.
CASES = _cases()


def inputs(case_id):
    """A [m, K] and the logical B [K, N] of one case, as float32 numpy
    (rounded to the input dtype by whichever side uses them)."""
    i = [c[0] for c in CASES].index(case_id)
    m = CASES[i][1]
    rng = np.random.default_rng(1000 + i)
    a = rng.normal(size=(m, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    return a, b


def pallas_outputs():
    """{case id: the reference Pallas GEMM's output as float32}: interpret
    mode on the CPU (imports JAX and the reference)."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    out = {}
    for cid, _, _, dtype, odtype in CASES:
        a, b = inputs(cid)
        got = jops.gemm(jnp.asarray(a, getattr(jnp, dtype)),
                        jnp.asarray(b, getattr(jnp, dtype)),
                        out_dtype=getattr(jnp, odtype), interpret=True)
        out[cid] = np.asarray(got, np.float32)
    return out


def load():
    """The kept outputs: {case id: float32 array}."""
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **pallas_outputs())
    print(f"wrote {FIXTURE}")
