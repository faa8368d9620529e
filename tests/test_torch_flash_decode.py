"""The port's decode attention against the reference's Pallas flash decode
(interpret mode) and against the reference's host math.

On the CPU the kernel wrapper takes its plain version; the kernel itself
(``csrc/flash_decode.cu``) is tested on the card by
``test_torch_kernels_gpu.py``.  Tolerance is ``tests/test_kernels.py``'s
f32 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blas as jblas
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import offload_policy as jpolicy
from repro.kernels import ops as jops
from repro_torch.core import blas as tblas
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.ref import decode_attention_ref

TOL = dict(rtol=2e-5, atol=2e-5)

# tests/test_kernels.py:120-123's ragged cases, plus S = 300 (the reference
# halves its block to 4 slots there; the port masks the tail) with GQA and
# one fully masked row, which must output 0.
CASES = [
    dict(hq=4, hkv=2, s=64, bounds=[(0, 64), (5, 40), (10, 33)]),
    dict(hq=8, hkv=8, s=96, bounds=[(0, 96), (0, 1), (95, 96)]),
    dict(hq=4, hkv=2, s=300, bounds=[(0, 300), (37, 250), (100, 100)]),
]


def _inputs(case, d=16, seed=7):
    rng = np.random.default_rng(seed)
    b = len(case["bounds"])
    q = rng.normal(size=(b, case["hq"], d)).astype(np.float32)
    k = rng.normal(size=(b, case["hkv"], case["s"], d)).astype(np.float32)
    v = rng.normal(size=(b, case["hkv"], case["s"], d)).astype(np.float32)
    lo = np.array([x for x, _ in case["bounds"]], np.int32)
    hi = np.array([y for _, y in case["bounds"]], np.int32)
    return q, k, v, lo, hi


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"S{c['s']}")
def test_flash_decode_matches_reference_kernel(case):
    q, k, v, lo, hi = _inputs(case)
    want = np.asarray(jops.flash_decode(
        *map(jnp.asarray, (q, k, v, lo, hi)), block_kv=16, interpret=True))
    got = flash_decode(*map(torch.from_numpy, (q, k, v, lo, hi)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for i, (x, y) in enumerate(case["bounds"]):
        if y <= x:
            assert np.all(got[i].numpy() == 0.0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"S{c['s']}")
def test_decode_ref_matches_reference_host_math(case):
    """The plain version against the reference's masked attention math,
    one batch row (and its own bounds) at a time."""
    q, k, v, lo, hi = _inputs(case, seed=3)
    got = decode_attention_ref(*map(torch.from_numpy, (q, k, v, lo, hi)))
    pos = np.arange(case["s"])
    for i in range(len(lo)):
        mask = (pos >= lo[i]) & (pos < hi[i])
        want = jblas.attention_math(
            jnp.asarray(q[i:i + 1, :, None, :]), jnp.asarray(k[i:i + 1]),
            jnp.asarray(v[i:i + 1]), causal=False,
            kv_mask=jnp.asarray(mask)[None],
        )[0, :, 0, :]
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_blas_decode_attention_records_and_values(use_kernels):
    """Through the seam with scalar bounds, as the decode layer calls it:
    the record backend maps device-pallas -> device-kernel and the values
    match."""
    case = dict(hq=4, hkv=2, s=64, bounds=[(3, 40)] * 2)
    q, k, v, _, _ = _inputs(case)
    q4 = q[:, :, None, :]
    with jpolicy(mode="device", use_pallas=use_kernels, interpret=True), \
            jtrace() as jt:
        want = np.asarray(jblas.decode_attention(
            jnp.asarray(q4), jnp.asarray(k), jnp.asarray(v),
            jnp.int32(3), jnp.int32(40)))
    with tpolicy(mode="device", use_kernels=use_kernels), ttrace() as tt:
        got = tblas.decode_attention(
            torch.from_numpy(q4), torch.from_numpy(k), torch.from_numpy(v),
            3, 40)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    rename = {"device-pallas": "device-kernel"}
    assert [(r.op, rename.get(r.backend, r.backend), r.cost.flops)
            for r in tt.records] == \
        [(r.op, rename.get(r.backend, r.backend), r.cost.flops)
         for r in jt.records]
    assert tt.records[0].backend == ("device-kernel" if use_kernels
                                     else "device")
