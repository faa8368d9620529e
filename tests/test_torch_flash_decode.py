"""The port's decode attention against the reference's Pallas flash decode
(interpret mode) and against the reference's host math.

On the CPU the kernel wrapper takes its plain version; the kernels
themselves (``csrc/flash_decode.cu``) are tested on the card by
``test_torch_kernels_gpu.py``.  Here also: the route and launch plan the
wrapper computes before a launch, and the reference outputs kept in
``tests/data/flash_decode_pallas.npz`` for the card tests.  Tolerance is
``tests/test_kernels.py``'s f32 2e-5 (bf16 2e-2).
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
from repro_torch.kernels.flash_decode import (_MAX_SMEM, decode_plan,
                                              flash_decode, flash_decode_route,
                                              smem_bytes)
from repro_torch.kernels.ref import decode_attention_ref

import flash_decode_pallas_ref

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


# Clusters of 1..8 blocks the H100 80GB HBM3 holds at once for the mma
# kernel at D 128 (cudaOccupancyMaxActiveClusters; chip_smoke.py prints
# the card's table in its check phase): 132 SMs, two blocks an SM, less
# what the GPCs leave over.
H100_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30)


@pytest.mark.parametrize("b,hq,hkv,s,splits,per", [
    (8, 32, 4, 64, 1, 64),        # yi-6b's serve smoke: one split
    (8, 32, 4, 300, 1, 304),
    (8, 32, 4, 1024, 4, 256),
    (8, 32, 4, 4096, 7, 592),     # yi-6b's 4096-token context: 32 clusters
    (8, 32, 4, 4099, 7, 592),     # a ragged tail
    (1, 32, 4, 4096, 8, 512),     # one long request
    (6, 8, 1, 1024, 4, 256),      # the Pallas fixture's case
    (16, 32, 4, 4096, 3, 1376),   # 64 clusters: 3 blocks each fit
    (8, 64, 4, 4096, 3, 1376),    # two head groups a kv head: 64 clusters
    (64, 32, 4, 4096, 1, 4096),   # 256 clusters: only one-block ones fit
    (128, 32, 4, 4096, 1, 4096),  # more than a wave even then
    (8, 32, 4, 0, 1, 16),
])
def test_decode_plan_splits(b, hq, hkv, s, splits, per):
    """The split plan at the serving shapes on the H100's cluster table:
    one split at the smoke's 64 slots; on long caches the most splits
    whose clusters all fit on the card at once; the same plan for every
    dtype and route."""
    for dt, route in ((torch.bfloat16, "mma"), (torch.float32, "simt")):
        plan = decode_plan(b, hq, hkv, s, 128, dt, route, H100_CLUSTERS)
        assert (plan.splits, plan.per, plan.step) == (splits, per, 16)
    groups = -(-hq // hkv // 8)
    if splits > 1:
        assert b * hkv * groups <= H100_CLUSTERS[splits - 1]


def test_decode_plan_ignores_the_bounds():
    """The plan's inputs are shapes, dtype, route and the card's cluster
    table: nothing that depends on the per-row bounds."""
    import inspect

    params = inspect.signature(decode_plan).parameters
    assert list(params) == ["b", "hq", "hkv", "s", "d", "dtype", "route",
                            "clusters"]


@pytest.mark.parametrize("s", [1, 15, 16, 255, 256, 257, 1000, 4095, 4099,
                               9000, 32768])
@pytest.mark.parametrize("b,hkv", [(1, 1), (1, 4), (8, 4), (3, 2), (32, 8)])
def test_decode_plan_covers_the_cache(s, b, hkv):
    """Every slot lies in exactly one split, no split starts past S, a
    cluster has at most 8 blocks, and splits are whole warp steps."""
    ideal = [2 * 132 // n for n in range(1, 9)]   # no SM left over
    for clusters in (H100_CLUSTERS, ideal):
        plan = decode_plan(b, 8 * hkv, hkv, s, 128, torch.bfloat16, "mma",
                           clusters)
        assert 1 <= plan.splits <= 8 and plan.per % 16 == 0
        assert plan.splits * plan.per >= s
        assert (plan.splits - 1) * plan.per < max(s, 1)


@pytest.mark.parametrize("dtype,d,ptrs,route", [
    (torch.bfloat16, 128, (0, 256, 512), "mma"),
    (torch.bfloat16, 16, (0, 256, 512), "mma"),
    (torch.bfloat16, 80, (0, 256, 512), "mma"),
    (torch.bfloat16, 256, (0, 256, 512), "mma"),
    (torch.bfloat16, 72, (0, 256, 512), "simt"),      # not a multiple of 16
    (torch.bfloat16, 12, (0, 256, 512), "simt"),
    (torch.bfloat16, 128, (0, 258, 512), "simt"),     # misaligned cache
    (torch.bfloat16, 128, (8, 256, 512), "simt"),     # misaligned q
    (torch.float32, 128, (0, 256, 512), "simt"),      # true fp32
    (torch.float32, 16, (0, 256, 512), "simt"),
])
def test_flash_decode_route(dtype, d, ptrs, route):
    assert flash_decode_route(dtype, d, ptrs) == route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_smem_fits_every_head_dim(dtype):
    """Every head dim the kernel takes (8..256) fits one block's shared
    memory on its route, and yi-6b's bf16 shape leaves room for two
    blocks an SM."""
    isz = dtype.itemsize
    for d in range(8, 257):
        route = flash_decode_route(dtype, d, (0, 0, 0))
        step = decode_plan(8, 32, 4, 4096, d, dtype, route,
                           H100_CLUSTERS).step
        assert smem_bytes(route, d, isz, step) <= _MAX_SMEM, d
    if dtype == torch.bfloat16:
        assert 2 * (smem_bytes("mma", 128, 2, 16) + 1024) <= 233_472
    assert decode_plan(8, 32, 4, 4096, 200, torch.float32, "simt",
                       H100_CLUSTERS).step == 8


@pytest.fixture(scope="module")
def decode_pallas_kept():
    return flash_decode_pallas_ref.load(), \
        flash_decode_pallas_ref.pallas_outputs()


@pytest.mark.parametrize("dtype", flash_decode_pallas_ref.DTYPES)
def test_decode_pallas_outputs_are_kept(decode_pallas_kept, dtype):
    """``tests/data/flash_decode_pallas.npz`` holds what the reference's
    Pallas flash decode computes on the long-cache case the card tests
    hold the split kernels against (to within one rounding of the output),
    its empty row is exactly 0, and the port's plain version agrees with
    it at the usual bars."""
    kept, fresh = decode_pallas_kept
    want = fresh[dtype]
    b = len(flash_decode_pallas_ref.BOUNDS)
    d = flash_decode_pallas_ref.D
    assert kept[dtype].shape == want.shape == (b, flash_decode_pallas_ref.HQ, d)
    scale = float(np.abs(want).max())
    bar = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert np.abs(kept[dtype] - want).max() / scale <= bar
    assert np.all(kept[dtype][flash_decode_pallas_ref.EMPTY_ROWS] == 0.0)
    q, k, v, lo, hi = flash_decode_pallas_ref.inputs()
    dt = getattr(torch, dtype)
    got = flash_decode(*(torch.from_numpy(x).to(dt) for x in (q, k, v)),
                       torch.from_numpy(lo), torch.from_numpy(hi))
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert np.abs(got.float().numpy() - want).max() / scale <= tol
