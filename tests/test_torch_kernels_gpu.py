"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (``gpu`` marker) and skips without one.
The file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Tolerances are
``tests/test_kernels.py``'s, f32 2e-5 and bf16 2e-2, of max |plain|
(for attention, of each output row's max |plain|); the SSD chunk kernel's
is 1e-4 in f32 (``tests/test_kernels.py:169``), of each output row's max
|plain|.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import (cluster_capacity, decode_plan,
                                              flash_decode, flash_decode_route)
from repro_torch.kernels.gemm import gemm, gemm_batched
from repro_torch.kernels.ref import (attention_ref, decode_attention_ref,
                                     gemm_batched_ref, gemm_ref,
                                     ssd_chunk_diag_ref)
from repro_torch.kernels.ssd_scan import ssd_chunk_diag, ssd_route

import flash_decode_pallas_ref
import gemm_pallas_ref
import ssd_pallas_ref

pytestmark = pytest.mark.gpu

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (200, 130, 96), (8, 8, 8),
               (1, 256, 64), (8, 5120, 4096), (8, 4096, 11008)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _row_err(got, want):
    """Max over rows (last axis) of the error scaled by that row's max
    |want|; rows that are all 0 are left to the masked-row checks."""
    got, want = got.float(), want.float()
    scale = want.abs().amax(dim=-1)
    live = scale > 0
    return ((got - want).abs().amax(dim=-1)[live] / scale[live]).max().item()


@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_kernel(card, m, n, k, dtype):
    dt = getattr(torch, dtype)
    a = torch.randn(m, k, generator=card, device="cuda").to(dt)
    b = torch.randn(k, n, generator=card, device="cuda").to(dt)
    before = gemm.launches
    got = gemm(a, b)
    torch.cuda.synchronize()
    assert gemm.launches == before + 1 and got.dtype == dt
    assert _err(got, gemm_ref(a, b)) <= TOL[dtype]


# The wgmma route (bf16, m > 16): one block and one k step first (a
# single tile of 16 k), then the reference tests' shapes, ragged m / n / k
# (k a multiple of 8 but not of the 64-wide k tile) and a yi-6b forward
# shape, each with B row-major ("mn": MN-major for wgmma) and as the
# transpose of a row-major [n, k] ("k": K-major, as a tied embedding's).
# An odd n (a C row stride TMA never sees) is possible only with a K-major
# B, whose rows are k long.
WGMMA_SHAPES = [(64, 128, 16), (128, 128, 128), (256, 128, 384),
                (200, 136, 96), (17, 72, 104), (100, 32, 1016),
                (1000, 5128, 8 * 131), (1024, 5120, 4096)]
WGMMA_CASES = [(*shape, layout) for shape in WGMMA_SHAPES
               for layout in ("mn", "k")] + [(100, 33, 1016, "k")]


def _b_operand(card, k, n, layout, dt=torch.bfloat16):
    if layout == "mn":
        return torch.randn(k, n, generator=card, device="cuda").to(dt)
    return torch.randn(n, k, generator=card, device="cuda").to(dt).T


def _route_counts():
    return dict(gemm.route_launches), dict(gemm_batched.route_launches)


@pytest.mark.parametrize("m,n,k,layout", WGMMA_CASES,
                         ids=["x".join(map(str, c)) for c in WGMMA_CASES])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_gemm_wgmma_route(card, m, n, k, layout, out):
    a = torch.randn(m, k, generator=card, device="cuda").to(torch.bfloat16)
    b = _b_operand(card, k, n, layout)
    before = dict(gemm.route_launches)
    got = gemm(a, b, out_dtype=getattr(torch, out))
    torch.cuda.synchronize()
    assert gemm.route_launches == {**before, "wgmma": before["wgmma"] + 1}
    assert got.dtype == getattr(torch, out) and got.shape == (m, n)
    want = gemm_ref(a, b, out_dtype=torch.float32)
    assert _err(got, want) <= TOL["bfloat16"]


def test_gemm_wgmma_fp32_accumulation(card):
    """bf16 inputs accumulate in fp32 on the tensor cores, at m = 128 (the
    CPU test's bar; a bf16 accumulator would stall far below k * 1e-4)."""
    k = 4096
    a = torch.full((128, k), 0.01, dtype=torch.bfloat16, device="cuda")
    b = torch.full((k, 128), 0.01, dtype=torch.bfloat16, device="cuda")
    before = gemm.route_launches["wgmma"]
    got = gemm(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert gemm.route_launches["wgmma"] == before + 1
    assert (got - k * 1e-4).abs().max().item() / (k * 1e-4) < 0.02


@pytest.mark.parametrize("layout", ["mn", "k"])
@pytest.mark.parametrize("broadcast_a", [False, True])
def test_gemm_batched_wgmma_equals_single_launches(card, layout,
                                                   broadcast_a):
    """A stack of two GEMMs in one batched launch equals the two single
    launches bit for bit (graph mode stacks projections that eager mode
    runs one by one), also with A broadcast (batch stride 0)."""
    m, k, n = 1000, 1024, 5128
    if broadcast_a:
        a = torch.randn(m, k, generator=card, device="cuda").to(
            torch.bfloat16).expand(2, m, k)
    else:
        a = torch.randn(2, m, k, generator=card, device="cuda").to(
            torch.bfloat16)
    bs = [_b_operand(card, k, n, layout) for _ in range(2)]
    b = torch.stack(bs) if layout == "mn" else \
        torch.stack([x.T for x in bs]).transpose(1, 2)
    singles, batched = _route_counts()
    got = gemm_batched(a, b)
    torch.cuda.synchronize()
    assert gemm_batched.route_launches == {
        **batched, "wgmma": batched["wgmma"] + 1}
    want = torch.stack([gemm(a[i], bs[i]) for i in range(2)])
    torch.cuda.synchronize()
    assert gemm.route_launches == {**singles, "wgmma": singles["wgmma"] + 2}
    assert torch.equal(got, want)
    assert _err(got, gemm_batched_ref(a, b)) <= TOL["bfloat16"]


def test_gemm_routes_counted_by_kernel(card):
    """Serving shapes (m = 8) take the skinny kernel, f32 and a
    column-major A the CUDA-core tile, bf16 at m > 16 the tensor cores."""
    bf16 = torch.bfloat16
    cases = [
        ((8, 4096), (4096, 5120), bf16, False, "skinny"),
        ((128, 256), (256, 128), torch.float32, False, "tiled"),
        ((256, 128), (256, 128), bf16, True, "tiled"),
        ((128, 256), (256, 128), bf16, False, "wgmma"),
    ]
    for sa, sb, dt, col_major_a, route in cases:
        a = torch.randn(*sa, generator=card, device="cuda").to(dt)
        a = a.T if col_major_a else a
        b = torch.randn(*sb, generator=card, device="cuda").to(dt)
        before = dict(gemm.route_launches)
        got = gemm(a, b)
        torch.cuda.synchronize()
        assert gemm.route_launches == {**before, route: before[route] + 1}
        assert _err(got, gemm_ref(a, b)) <= TOL[str(dt)[6:]]


def test_gemm_kernel_transposed_operands(card):
    a = torch.randn(48, 40, generator=card, device="cuda")
    b = torch.randn(24, 48, generator=card, device="cuda")
    got = gemm(a.T, b.T)            # strided views, read in place
    torch.cuda.synchronize()
    assert _err(got, gemm_ref(a.T, b.T)) <= TOL["float32"]


@pytest.mark.parametrize("bsz", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_batched_kernel(card, bsz, dtype):
    """tests/test_kernels.py::test_gemm_batched's shapes, one launch."""
    dt = getattr(torch, dtype)
    a = torch.randn(bsz, 96, 64, generator=card, device="cuda").to(dt)
    b = torch.randn(bsz, 64, 80, generator=card, device="cuda").to(dt)
    before = (gemm.launches, gemm_batched.launches)
    got = gemm_batched(a, b)
    torch.cuda.synchronize()
    assert (gemm.launches, gemm_batched.launches) == (before[0], before[1] + 1)
    assert got.shape == (bsz, 96, 80) and got.dtype == dt
    assert _err(got, gemm_batched_ref(a, b)) <= TOL[dtype]


# tests/test_kernels.py::test_flash_attention_variants (D 32), then the
# head dims of h2o-danube / hubert (80) and yi-6b (128).
ATTN_CASES = [
    dict(sq=128, skv=128, hq=4, hkv=4, causal=True, d=32),
    dict(sq=128, skv=128, hq=8, hkv=2, causal=True, d=32),
    dict(sq=96, skv=96, hq=4, hkv=2, causal=True, window=32, d=32),
    dict(sq=64, skv=64, hq=4, hkv=4, causal=False, d=32),
    dict(sq=16, skv=128, hq=4, hkv=2, causal=True, d=32),
    dict(sq=100, skv=100, hq=4, hkv=2, causal=True, d=32),
    dict(sq=77, skv=130, hq=8, hkv=2, causal=True, window=20, d=80),
    dict(sq=200, skv=200, hq=8, hkv=1, causal=True, d=128),
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel(card, case, dtype):
    dt = getattr(torch, dtype)
    d = case["d"]
    q = torch.randn(2, case["hq"], case["sq"], d, generator=card,
                    device="cuda").to(dt)
    k = torch.randn(2, case["hkv"], case["skv"], d, generator=card,
                    device="cuda").to(dt)
    v = torch.randn(2, case["hkv"], case["skv"], d, generator=card,
                    device="cuda").to(dt)
    kw = dict(causal=case["causal"], window=case.get("window"))
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.dtype == dt
    assert _row_err(got, attention_ref(q, k, v, **kw)) <= TOL[dtype]


def test_flash_attention_kernel_strided_and_masked_rows(card):
    """q/k/v as (B, S, H, D) transposed views are read in place; rows that
    a window leaves no key (bidirectional, window -5: the last six queries)
    output exactly 0, and causal with window 0 masks every row."""
    b, s, hq, hkv, d = 2, 70, 4, 2, 16
    q = torch.randn(b, s, hq, d, generator=card, device="cuda").transpose(1, 2)
    k = torch.randn(b, s, hkv, d, generator=card, device="cuda").transpose(1, 2)
    v = torch.randn(b, s, hkv, d, generator=card, device="cuda").transpose(1, 2)
    for kw in (dict(causal=True, window=3), dict(causal=False, window=-5),
               dict(causal=True, window=0)):
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = attention_ref(q, k, v, **kw)
        if want.abs().max().item() > 0:
            assert _row_err(got, want) <= TOL["float32"], kw
        dead = want.abs().amax(dim=-1) == 0
        assert dead.any() == (kw["window"] <= 0), kw
        assert got[dead].abs().max().item() == 0.0 if dead.any() else True


# The tensor-core route (bf16, D 64 / 128): the prefill geometry as
# contiguous tensors and as the model's (B, S, H, D) transposed views, a
# suffix (Sq < Skv), ragged lengths, a window, bidirectional, GQA 8:1 and
# 1:1, windows that leave rows no key (0 or less), whose outputs must be
# exactly 0, and kv loops long enough to wrap the ring of K / V stages
# (three stages at D 64, two at D 128) more than once.
WGMMA_ATTN_CASES = [
    dict(b=2, sq=256, skv=256, hq=8, hkv=2, d=128, causal=True),
    dict(b=2, sq=256, skv=256, hq=8, hkv=2, d=64, causal=True),
    dict(b=2, sq=256, skv=256, hq=8, hkv=2, d=128, causal=True, view=True),
    dict(b=2, sq=256, skv=256, hq=8, hkv=2, d=64, causal=True, view=True),
    dict(b=2, sq=16, skv=128, hq=4, hkv=2, d=128, causal=True),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=128, causal=True),
    dict(b=1, sq=200, skv=200, hq=8, hkv=8, d=64, causal=True),
    dict(b=2, sq=200, skv=200, hq=8, hkv=1, d=128, causal=True, window=32),
    dict(b=2, sq=130, skv=130, hq=4, hkv=4, d=64, causal=False),
    dict(b=2, sq=77, skv=130, hq=8, hkv=1, d=128, causal=False, view=True),
    dict(b=1, sq=200, skv=200, hq=8, hkv=1, d=128, causal=False, window=-5),
    dict(b=2, sq=77, skv=130, hq=4, hkv=2, d=64, causal=True, window=0),
    dict(b=1, sq=600, skv=600, hq=4, hkv=2, d=64, causal=True),
    dict(b=1, sq=700, skv=1000, hq=4, hkv=1, d=128, causal=True, window=300,
         view=True),
]


def _attn_operands(card, case, dtype):
    """q, k, v as (B, H, S, D) tensors, or as transposed views of (B, S, H,
    D) storage (``view``), as the model hands them over."""
    b, d = case["b"], case["d"]

    def make(h, s):
        if case.get("view"):
            return torch.randn(b, s, h, d, generator=card,
                               device="cuda").to(dtype).transpose(1, 2)
        return torch.randn(b, h, s, d, generator=card, device="cuda").to(dtype)

    return (make(case["hq"], case["sq"]), make(case["hkv"], case["skv"]),
            make(case["hkv"], case["skv"]))


def _attn_id(c):
    return "-".join(f"{k}{v}" for k, v in c.items())


@pytest.mark.parametrize("case", WGMMA_ATTN_CASES, ids=_attn_id)
def test_flash_attention_wgmma_route(card, case):
    q, k, v = _attn_operands(card, case, torch.bfloat16)
    kw = dict(causal=case["causal"], window=case.get("window"))
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.route_launches == {
        **before, "wgmma": before["wgmma"] + 1}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = attention_ref(q, k, v, **kw)
    dead = want.float().abs().amax(dim=-1) == 0
    if (~dead).any():
        assert _row_err(got, want) <= TOL["bfloat16"]
    window = case.get("window")
    assert bool(dead.any()) == (window is not None and window <= 0)
    if dead.any():
        assert got[dead].abs().max().item() == 0.0


# The CUDA-core route keeps f32 (true fp32, the 2e-5 bar), the head dims
# the tensor-core tile lacks (D 32 of the reference tests, D 80 of
# h2o-danube / hubert) and operands TMA cannot address.
SIMT_ATTN_CASES = [
    dict(b=2, sq=128, skv=128, hq=8, hkv=2, d=128, causal=True,
         dtype="float32"),
    dict(b=2, sq=128, skv=128, hq=8, hkv=2, d=32, causal=True,
         dtype="bfloat16"),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=True, window=20,
         dtype="bfloat16"),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=False,
         dtype="float32"),
]


@pytest.mark.parametrize("case", SIMT_ATTN_CASES, ids=_attn_id)
def test_flash_attention_simt_route(card, case):
    dtype = case["dtype"]
    q, k, v = _attn_operands(card, case, getattr(torch, dtype))
    kw = dict(causal=case["causal"], window=case.get("window"))
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.route_launches == {
        **before, "simt": before["simt"] + 1}
    assert _row_err(got, attention_ref(q, k, v, **kw)) <= TOL[dtype]


def test_flash_attention_misaligned_operand_takes_simt(card):
    """A k whose base address is off by one element (2 bytes) cannot be a
    TMA operand: the bf16 D 128 call runs on the CUDA cores instead."""
    case = dict(b=1, sq=64, skv=64, hq=4, hkv=2, d=128)
    q, k, v = _attn_operands(card, case, torch.bfloat16)
    flat = torch.randn(k.numel() + 1, generator=card, device="cuda").to(
        torch.bfloat16)
    k_odd = flat[1:].view(k.shape)
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k_odd, v)
    torch.cuda.synchronize()
    assert flash_attention.route_launches == {
        **before, "simt": before["simt"] + 1}
    assert _row_err(got, attention_ref(q, k_odd, v)) <= TOL["bfloat16"]


# A column slice x[:, :k] of a wider matrix (row stride > k) as A and as B,
# on every GEMM route: skinny (m <= 16), tiled (f32, or bf16 with a slice
# TMA cannot address) and wgmma (bf16, m > 16, 16-byte-aligned rows).
SLICE_CASES = [(8, 256, 192, "float32", "skinny"),
               (8, 256, 192, "bfloat16", "skinny"),
               (200, 136, 192, "float32", "tiled"),
               (200, 136, 100, "bfloat16", "tiled"),
               (200, 136, 192, "bfloat16", "wgmma")]


@pytest.mark.parametrize("m,n,k,dtype,route", SLICE_CASES,
                         ids=["-".join(map(str, c)) for c in SLICE_CASES])
def test_gemm_column_sliced_operands(card, m, n, k, dtype, route):
    dt = getattr(torch, dtype)
    a = torch.randn(m, k + 40, generator=card, device="cuda").to(dt)[:, :k]
    b = torch.randn(k, n + 24, generator=card, device="cuda").to(dt)[:, :n]
    before = dict(gemm.route_launches)
    got = gemm(a, b)
    torch.cuda.synchronize()
    assert gemm.route_launches == {**before, route: before[route] + 1}
    assert _err(got, gemm_ref(a, b)) <= TOL[dtype]
    a = torch.randn(2, m, k + 40, generator=card,
                    device="cuda").to(dt)[..., :k]
    b = torch.randn(2, k, n + 24, generator=card,
                    device="cuda").to(dt)[..., :n]
    before = dict(gemm_batched.route_launches)
    got = gemm_batched(a, b)
    torch.cuda.synchronize()
    assert gemm_batched.route_launches == {**before, route: before[route] + 1}
    assert _err(got, gemm_batched_ref(a, b)) <= TOL[dtype]


def test_gemm_rejects_operand_without_unit_stride(card):
    """A view with no unit stride (every other column) is not read in
    place: the kernel wrapper raises instead of copying or falling back."""
    a = torch.randn(64, 96, generator=card, device="cuda")[:, ::2]
    b = torch.randn(48, 32, generator=card, device="cuda")
    with pytest.raises(ValueError, match="one unit stride"):
        gemm(a, b)


def _serving_gemms():
    """(id, m, k, n, B layout, out dtype) of every GEMM a decode step of
    yi-6b and of mamba2-370m runs (m = batch = 8): the dt projection writes
    f32, the tied head multiplies by ``embed.T`` (K-major)."""
    from repro_torch.configs import get_arch

    yi, mb = get_arch("yi-6b"), get_arch("mamba2-370m")
    d, hd = yi.d_model, yi.head_dim
    bf16, f32 = "bfloat16", "float32"
    out = [("yi-qkv", d, (yi.num_heads + 2 * yi.num_kv_heads) * hd, "mn", bf16),
           ("yi-wo", yi.num_heads * hd, d, "mn", bf16),
           ("yi-gate-up", d, yi.d_ff, "mn", bf16),
           ("yi-down", yi.d_ff, d, "mn", bf16),
           ("yi-head", d, yi.vocab_size, "mn", bf16)]
    ds, di = mb.d_model, mb.d_inner
    out += [("mamba-z-x", ds, di, "mn", bf16),
            ("mamba-b-c", ds, mb.ssm_num_groups * mb.ssm_state_dim, "mn", bf16),
            ("mamba-dt", ds, mb.ssm_num_heads, "mn", f32),
            ("mamba-out", di, ds, "mn", bf16),
            ("mamba-head", ds, mb.vocab_size, "k", bf16)]
    return [(name, 8, k, n, lay, o) for name, k, n, lay, o in out]


SERVING_GEMMS = _serving_gemms()
_OUT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # by output dtype


def _skinny_check(card, m, k, n, layout, dtype, out, a=None, b=None):
    dt, ot = getattr(torch, dtype), getattr(torch, out)
    if a is None:
        a = torch.randn(m, k, generator=card, device="cuda").to(dt)
    if b is None:
        b = _b_operand(card, k, n, layout, dt)
    before = dict(gemm.route_launches)
    got = gemm(a, b, out_dtype=ot)
    torch.cuda.synchronize()
    assert gemm.route_launches == {**before, "skinny": before["skinny"] + 1}
    assert got.dtype == ot and got.shape == (m, n)
    assert torch.isfinite(got).all()
    assert _err(got, gemm_ref(a, b, out_dtype=torch.float32)) <= _OUT_TOL[out]
    return a, b, got


@pytest.mark.parametrize("m,k,n,layout,out", [c[1:] for c in SERVING_GEMMS],
                         ids=[c[0] for c in SERVING_GEMMS])
def test_gemm_skinny_serving_shapes(card, m, k, n, layout, out):
    """Every decode-step GEMM of both models on the skinny kernels (bf16
    weights; mamba2-370m's head reads ``embed.T`` in place)."""
    _skinny_check(card, m, k, n, layout, "bfloat16", out)


# m at both accumulator-row counts and their edges; k and n off every
# split and vector: 4100 rows split 16 ways leave a short last split,
# n = 130 needs scalar loads, 50280 a ragged last column tile.
SKINNY_SHAPES = [(1000, 1000), (4100, 520), (4096, 130), (1024, 50280)]
DTYPE_PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
               ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("m", [1, 8, 9, 16])
@pytest.mark.parametrize("k,n", SKINNY_SHAPES,
                         ids=["x".join(map(str, s)) for s in SKINNY_SHAPES])
@pytest.mark.parametrize("layout", ["mn", "k"])
@pytest.mark.parametrize("dtype,out", DTYPE_PAIRS,
                         ids=["-".join(p) for p in DTYPE_PAIRS])
def test_gemm_skinny_rows_shapes_dtypes(card, m, k, n, layout, dtype, out):
    _skinny_check(card, m, k, n, layout, dtype, out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["mn", "k"])
def test_gemm_skinny_misaligned_operands(card, dtype, layout):
    """Column slices with an odd row stride (n + 3 for B, k + 3 for A) and
    a B that starts one element past a 16-byte boundary: scalar loads,
    the same results."""
    dt = getattr(torch, dtype)
    m, k, n = 8, 1032, 520
    a = torch.randn(m, k + 3, generator=card, device="cuda").to(dt)[:, :k]
    if layout == "mn":
        b = torch.randn(k, n + 3, generator=card, device="cuda").to(dt)[:, :n]
    else:
        b = torch.randn(n, k + 3, generator=card, device="cuda").to(dt)[:, :k].T
    _skinny_check(card, m, k, n, layout, dtype, dtype, a=a, b=b)
    flat = torch.randn(k * n + 1, generator=card, device="cuda").to(dt)
    b = flat[1:].view(k, n) if layout == "mn" else flat[1:].view(n, k).T
    _skinny_check(card, m, k, n, layout, dtype, dtype, a=a, b=b)


@pytest.mark.parametrize("cid,m,layout,dtype,out", gemm_pallas_ref.CASES,
                         ids=[c[0] for c in gemm_pallas_ref.CASES])
def test_gemm_skinny_matches_pallas_reference(card, cid, m, layout, dtype,
                                              out):
    """Each skinny kernel (tensor cores for bf16, CUDA cores for f32; both
    B layouts, the K-major one read in place as a transpose) against the
    reference's Pallas GEMM on the same numpy inputs: its outputs kept in
    ``tests/data/gemm_skinny_pallas.npz`` (this machine has no JAX; see
    ``tests/gemm_pallas_ref.py``)."""
    a, b = gemm_pallas_ref.inputs(cid)
    want = torch.from_numpy(gemm_pallas_ref.load()[cid])
    dt = getattr(torch, dtype)
    ta = torch.from_numpy(a).to(dt).cuda()
    tb = torch.from_numpy(b).to(dt).cuda() if layout == "mn" else \
        torch.from_numpy(np.ascontiguousarray(b.T)).to(dt).cuda().T
    before = dict(gemm.route_launches)
    got = gemm(ta, tb, out_dtype=getattr(torch, out))
    torch.cuda.synchronize()
    assert gemm.route_launches == {**before, "skinny": before["skinny"] + 1}
    assert got.dtype == getattr(torch, out) and got.shape == want.shape
    assert _err(got.cpu(), want) <= _OUT_TOL[out]


@pytest.mark.parametrize("k,n,layout", [(4096, 11008, "mn"), (1024, 2048, "mn"),
                                        (1024, 32, "mn"), (4096, 5120, "k")])
def test_gemm_skinny_stacked_equals_single_and_repeats(card, k, n, layout):
    """A stack of two decode GEMMs at m = 8 in one batched launch equals
    the two single launches bit for bit (graph mode stacks what eager mode
    runs one by one), and a second launch of the same GEMM equals the
    first bit for bit: the split plan ignores the batch count and the
    split-k sum has a fixed order."""
    bf16 = torch.bfloat16
    a = torch.randn(2, 8, k, generator=card, device="cuda").to(bf16)
    bs = [_b_operand(card, k, n, layout) for _ in range(2)]
    b = torch.stack(bs) if layout == "mn" else \
        torch.stack([x.T for x in bs]).transpose(1, 2)
    singles, batched = _route_counts()
    got = gemm_batched(a, b)
    again = gemm_batched(a, b)
    torch.cuda.synchronize()
    assert gemm_batched.route_launches == {
        **batched, "skinny": batched["skinny"] + 2}
    one = [gemm(a[i], bs[i]) for i in range(2)]
    twice = [gemm(a[i], bs[i]) for i in range(2)]
    torch.cuda.synchronize()
    assert gemm.route_launches == {**singles, "skinny": singles["skinny"] + 4}
    assert torch.equal(got, torch.stack(one))
    assert torch.equal(got, again)
    assert all(torch.equal(x, y) for x, y in zip(one, twice))
    assert _err(got, gemm_batched_ref(a, b)) <= TOL["bfloat16"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel(card, dtype):
    bounds = [(0, 300), (5, 40), (10, 33), (0, 1), (299, 300), (100, 100),
              (37, 250), (0, 150)]
    b, hq, hkv, s, d = len(bounds), 32, 4, 300, 128
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, d, generator=card, device="cuda").to(dt)
    k = torch.randn(b, hkv, s, d, generator=card, device="cuda").to(dt)
    v = torch.randn(b, hkv, s, d, generator=card, device="cuda").to(dt)
    lo = torch.tensor([x for x, _ in bounds], dtype=torch.int32, device="cuda")
    hi = torch.tensor([y for _, y in bounds], dtype=torch.int32, device="cuda")
    before = flash_decode.launches
    got = flash_decode(q, k, v, lo, hi)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert _err(got, decode_attention_ref(q, k, v, lo, hi)) <= TOL[dtype]
    assert got[5].abs().max().item() == 0.0          # lo == hi: no slot


def _decode_bounds(s):
    """Per-row bounds on an S-slot cache: the whole cache, one slot, a
    rolling window (lo > 0, hi = S), an empty row (lo == hi), and ranges
    that leave whole splits empty (near the end, near the start, around
    the middle) and a ragged one."""
    return [(0, s), (0, 1), (s // 3, s), (s // 2, s // 2), (s - 40, s - 3),
            (5, min(s, 200)), (s // 2 - 7, s // 2 + 9), (37, s - 11)]


def _decode_case(card, dtype, hq, hkv, s, d, bounds, q=None):
    dt = getattr(torch, dtype)
    b = len(bounds)
    if q is None:
        q = torch.randn(b, hq, d, generator=card, device="cuda").to(dt)
    k = torch.randn(b, hkv, s, d, generator=card, device="cuda").to(dt)
    v = torch.randn(b, hkv, s, d, generator=card, device="cuda").to(dt)
    lo = torch.tensor([x for x, _ in bounds], dtype=torch.int32, device="cuda")
    hi = torch.tensor([y for _, y in bounds], dtype=torch.int32, device="cuda")
    return q, k, v, lo, hi


def _decode_check(q, k, v, lo, hi, dtype, route, empty_rows=True):
    """One launch on ``route`` against the plain version, its empty rows
    (the case must have some unless ``empty_rows`` is False) exactly 0,
    and a second launch equal to the first bit for bit."""
    before = dict(flash_decode.route_launches)
    got = flash_decode(q, k, v, lo, hi)
    again = flash_decode(q, k, v, lo, hi)
    torch.cuda.synchronize()
    assert flash_decode.route_launches == {**before, route: before[route] + 2}
    assert torch.equal(got, again)
    assert _err(got, decode_attention_ref(q, k, v, lo, hi)) <= TOL[dtype]
    empty = (hi <= lo).nonzero().flatten().tolist()
    assert bool(empty) == empty_rows
    if empty:
        assert got[empty].abs().max().item() == 0.0
    return got


@pytest.mark.parametrize("s", [64, 300, 1024, 4096, 4099])
@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_split_kernels(card, dtype, d, s):
    """The split kernels at yi-6b's GQA group (32 q / 4 kv heads) over
    the split counts the plan gives these caches (1 up to 7 or 8, by the
    card's cluster table), every head dim of the routes (bf16 D % 16 == 0
    on the tensor cores, f32 on the CUDA cores), rows that leave whole
    splits empty or nothing at all."""
    args = _decode_case(card, dtype, 32, 4, s, d, _decode_bounds(s))
    route = "mma" if dtype == "bfloat16" else "simt"
    dt = getattr(torch, dtype)
    assert flash_decode_route(dt, d, [t.data_ptr() for t in args[:3]]) == route
    splits = decode_plan(8, 32, 4, s, d, dt, route,
                         cluster_capacity(route, dt, d, 0)).splits
    assert (splits == 1) == (s < 512)
    _decode_check(*args, dtype, route)


@pytest.mark.parametrize("b", [1, 8, 9, 11, 14, 16])
def test_flash_decode_split_counts(card, b):
    """B 1 to 16 at yi-6b's 4 kv heads on a 4096-slot cache: on the
    H100's cluster table the plan gives 8, 7, 6, 5, 4 and 3 splits (the
    most whose clusters fit on the card at once); bf16 against the plain
    version."""
    s = 4096
    bounds = [(0, s)] if b == 1 else \
        [(s // 2, s // 2)] + (_decode_bounds(s) * 2)[:b - 1]
    args = _decode_case(card, "bfloat16", 32, 4, s, 128, bounds)
    _decode_check(*args, "bfloat16", "mma", empty_rows=b > 1)


@pytest.mark.parametrize("hq,hkv", [(8, 8), (4, 2), (16, 4), (32, 4),
                                    (32, 2), (24, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_gqa_groups(card, dtype, hq, hkv):
    """GQA groups of 1 to 24 q heads a kv head: a block serves a head
    group of at most 8 (groups 16 and 24 run 2 and 3 head groups)."""
    args = _decode_case(card, dtype, hq, hkv, 1024, 128, _decode_bounds(1024))
    _decode_check(*args, dtype, "mma" if dtype == "bfloat16" else "simt")


@pytest.mark.parametrize("d,s", [(72, 1024), (12, 300), (9, 300),
                                 (200, 4099), (8, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_simt_head_dims(card, dtype, d, s):
    """Head dims off the tensor-core tile on the CUDA-core kernel.  Cache
    rows that are not whole 16-byte chunks (bf16 D 9 and 12, f32 D 9) are
    copied element by element; f32 D 200 rows take 8-slot warp steps."""
    args = _decode_case(card, dtype, 32, 4, s, d, _decode_bounds(s))
    _decode_check(*args, dtype, "simt")


@pytest.mark.parametrize("operand", ["q", "cache"])
def test_flash_decode_misaligned_operands_take_simt(card, operand):
    """A bf16 q or cache that is contiguous but not 16-byte aligned (a
    view one element into its storage) runs on the CUDA-core kernel, the
    cache element by element."""
    b, hq, hkv, s, d = 8, 32, 4, 1024, 128
    q, k, v, lo, hi = _decode_case(card, "bfloat16", hq, hkv, s, d,
                                   _decode_bounds(s))

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        flat[1:] = x.flatten()
        return flat[1:].view(x.shape)

    if operand == "q":
        q = shifted(q)
    else:
        k, v = shifted(k), shifted(v)
    assert q.is_contiguous() and k.is_contiguous()
    _decode_check(q, k, v, lo, hi, "bfloat16", "simt")


@pytest.mark.parametrize("dtype", flash_decode_pallas_ref.DTYPES)
def test_flash_decode_matches_pallas_reference(card, dtype):
    """The split kernels (4 splits of 256 slots; bf16 on the tensor cores,
    f32 on the CUDA cores) against the reference's Pallas flash decode on
    the same numpy inputs: its outputs kept in
    ``tests/data/flash_decode_pallas.npz`` (this machine has no JAX; see
    ``tests/flash_decode_pallas_ref.py``)."""
    q, k, v, lo, hi = flash_decode_pallas_ref.inputs()
    want = torch.from_numpy(flash_decode_pallas_ref.load()[dtype])
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(dt).cuda() for x in (q, k, v)]
    args += [torch.from_numpy(x).cuda() for x in (lo, hi)]
    b, hkv, s, d = k.shape
    hq = q.shape[1]
    assert decode_plan(b, hq, hkv, s, d, dt, "mma",
                       cluster_capacity("mma", dt, d, 0)).splits == 4
    route = "mma" if dtype == "bfloat16" else "simt"
    before = dict(flash_decode.route_launches)
    got = flash_decode(*args).float().cpu()
    assert flash_decode.route_launches == {**before, route: before[route] + 1}
    assert _err(got, want) <= TOL[dtype]
    assert got[flash_decode_pallas_ref.EMPTY_ROWS].abs().max().item() == 0.0


def test_serve_reduced_runs_on_kernels(card):
    """Reduced yi-6b served on the card with the kernel policy: every
    decode step launches both kernels, and the greedy tokens equal the
    plain device path's (f32, 2 layers)."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch

    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 200, size=4))) for _ in range(8)]
    gemm.launches = flash_decode.launches = 0
    with offload_policy(mode="device", use_kernels=True):
        got = serve_batch("yi-6b", prompts, max_new_tokens=4)
    steps = 4 + 4
    assert gemm.launches == steps * (5 * 2 + 1)
    assert flash_decode.launches == steps * 2
    with offload_policy(mode="device", use_kernels=False):
        want = serve_batch("yi-6b", prompts, max_new_tokens=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_serve_cluster_reduced_matches_serve_batch_on_kernels(card):
    """Reduced yi-6b served by ``serve_cluster`` on the card, three batches
    over two modeled devices (round-robin: one cache migrates): every step
    launches both kernels, and each batch's greedy tokens equal
    ``serve_batch``'s on the same prompts (f32, 2 layers)."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch, serve_cluster

    rng = np.random.default_rng(2)
    batches = [[list(map(int, rng.integers(1, 200, size=4)))
                for _ in range(8)] for _ in range(3)]
    gemm.launches = flash_decode.launches = 0
    with offload_policy(mode="device", use_kernels=True, num_devices=2,
                        scheduler="round-robin"):
        res = serve_cluster("yi-6b", batches, max_new_tokens=4)
    steps = 3 * (4 + 4)
    assert gemm.launches == steps * (5 * 2 + 1)
    assert flash_decode.launches == steps * 2
    assert res.placements == [1, 0, 1] and res.d2d_s > 0.0
    with offload_policy(mode="device", use_kernels=True):
        for got, prompts in zip(res.results, batches, strict=True):
            want = serve_batch("yi-6b", prompts, max_new_tokens=4)
            np.testing.assert_array_equal(got.tokens, want.tokens)


def test_graph_serve_reduced_matches_eager_on_kernels(card):
    """Reduced yi-6b served in graph mode on the kernels (each decode
    step's FFN an hnp graph, the residual fused into it): the same launch
    counts and greedy tokens as eager mode, since both run the same kernels
    on the same operands (f32, 2 layers)."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch

    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, 200, size=4))) for _ in range(8)]
    runs = {}
    for mode in ("eager", "graph"):
        gemm.launches = flash_decode.launches = 0
        with offload_policy(mode="device", use_kernels=True):
            res = serve_batch("yi-6b", prompts, max_new_tokens=4,
                              forward_mode=mode)
        runs[mode] = (res.tokens, gemm.launches, flash_decode.launches)
    steps = 4 + 4
    assert runs["graph"][1:] == (steps * (5 * 2 + 1), steps * 2)
    assert runs["graph"][1:] == runs["eager"][1:]
    np.testing.assert_array_equal(runs["graph"][0], runs["eager"][0])


def test_graph_forward_reduced_on_kernels(card):
    """Reduced yi-6b (f32, 2 layers) Model.forward in graph mode on the
    card: one flash-attention launch per layer, and the kernel path's
    greedy tokens equal the plain device path's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), forward_mode="graph")
    model = build_model(cfg)
    params = model.init_params(card, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=card,
                           device="cuda")
    flash_attention.launches = 0
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        got, _ = model.forward(params, tokens)
    torch.cuda.synchronize()
    assert flash_attention.launches == cfg.num_layers
    with offload_policy(mode="device", use_kernels=False), torch.no_grad():
        want, _ = model.forward(params, tokens)
    assert _err(got, want) <= 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_hnp_batches_same_shape_gemms_on_the_card(card):
    """Two independent same-shape GEMMs forced together take one launch of
    the batched GEMM kernel; values against numpy in float64."""
    import repro_torch.hnp as hnp
    from repro_torch.core.hero import offload_policy

    rng = np.random.default_rng(0)
    x, w1, w2 = (rng.normal(size=s).astype(np.float32)
                 for s in ((64, 96), (96, 48), (96, 48)))
    with offload_policy(mode="device", use_kernels=True):
        a = hnp.array(x)
        y1, y2 = a @ w1, a @ w2
        before = (gemm.launches, gemm_batched.launches)
        hnp.block_all(y1, y2)
        torch.cuda.synchronize()
        assert (gemm.launches, gemm_batched.launches) == (before[0],
                                                          before[1] + 1)
        assert y1.node.value.device.type == "cuda"
    for y, w in ((y1, w1), (y2, w2)):
        want = x.astype(np.float64) @ w.astype(np.float64)
        assert np.abs(hnp.asnumpy(y) - want).max() <= 2e-5 * np.abs(want).max()


# tests/test_kernels.py::test_ssd_chunk_diag's shapes (BH, C, Q, P, N), then
# mamba2-370m's at 4 x 1024 tokens (BH 128, 4 chunks of 256, P 64, N 128),
# a 16-token forward (one 16-row chunk) and a ragged shape: all on the
# tensor-core route (``mma``).  SSD_SIMT_SHAPES: widths that route does not
# take (P > 128, rows not whole 16-byte chunks), on the CUDA cores.
SSD_SHAPES = [(4, 2, 32, 16, 8), (2, 8, 64, 32, 16), (1, 1, 8, 8, 8),
              (128, 4, 256, 64, 128), (32, 1, 16, 64, 128),
              (3, 2, 100, 80, 40)]
SSD_SIMT_SHAPES = [(2, 2, 100, 200, 16), (2, 1, 70, 64, 6), (1, 2, 33, 12, 10)]
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _ssd_inputs(gen, bh, nc, q, p, n, decay=0.1, dtype=torch.float32):
    dta = torch.cumsum(-torch.randn(bh, nc, q, generator=gen,
                                    device="cuda").abs() * decay, dim=-1)
    return [torch.randn(bh, nc, q, p, generator=gen, device="cuda").to(dtype),
            dta.to(dtype),
            torch.randn(bh, nc, q, n, generator=gen, device="cuda").to(dtype),
            torch.randn(bh, nc, q, n, generator=gen, device="cuda").to(dtype)]


def _ssd_on_route(ins, route):
    """One launch, checked to have taken ``route`` (the wrapper's pick)."""
    before = dict(ssd_chunk_diag.route_launches)
    got = ssd_chunk_diag(*ins)
    torch.cuda.synchronize()
    assert ssd_route(ins[0].dtype, ins[0].shape[3], ins[2].shape[3],
                     [t.data_ptr() for t in (*ins, got)]) == route
    moved = {r: n - before[r] for r, n in ssd_chunk_diag.route_launches.items()}
    assert moved == {r: int(r == route) for r in moved}
    return got


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_diag_kernel(card, shape, dtype):
    ins = _ssd_inputs(card, *shape, dtype=getattr(torch, dtype))
    before = ssd_chunk_diag.launches
    got = _ssd_on_route(ins, "mma")
    assert ssd_chunk_diag.launches == before + 1
    assert got.dtype == ins[0].dtype and got.shape == ins[0].shape
    assert _row_err(got, ssd_chunk_diag_ref(*ins)) <= SSD_TOL[dtype]


@pytest.mark.parametrize("shape", SSD_SIMT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_diag_kernel_simt_route(card, shape, dtype):
    ins = _ssd_inputs(card, *shape, dtype=getattr(torch, dtype))
    got = _ssd_on_route(ins, "simt")
    assert _row_err(got, ssd_chunk_diag_ref(*ins)) <= SSD_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_diag_kernel_forward_shape_repeats_bit_for_bit(card, dtype):
    """mamba2-370m's forward shape with the model's decay, on the mma
    route: within the bar, finite, and a second launch gives the same
    bits (no atomics, no workspace)."""
    ins = _ssd_inputs(card, 128, 4, 256, 64, 128, decay=0.7,
                      dtype=getattr(torch, dtype))
    got = _ssd_on_route(ins, "mma")
    assert torch.isfinite(got).all()
    assert _row_err(got, ssd_chunk_diag_ref(*ins)) <= SSD_TOL[dtype]
    assert torch.equal(got, _ssd_on_route(ins, "mma"))


@pytest.mark.parametrize("dtype", ssd_pallas_ref.DTYPES)
def test_ssd_chunk_diag_matches_pallas_reference(card, dtype):
    """The deep-decay ragged case (Q 200, P 64, N 128, two chunks) against
    the reference Pallas kernel's outputs kept in
    ``tests/data/ssd_pallas.npz`` (this machine has no JAX; see
    ``tests/ssd_pallas_ref.py``), per output row."""
    dt = getattr(torch, dtype)
    ins = [torch.from_numpy(a).to("cuda", dt) for a in ssd_pallas_ref.inputs()]
    want = torch.from_numpy(ssd_pallas_ref.load()[dtype]).cuda()
    got = _ssd_on_route(ins, "mma")
    assert _row_err(got, want) <= SSD_TOL[dtype]


def test_ssd_chunk_diag_kernel_deep_decay_and_causality(card):
    """The model's decay (a = -1, dt ≈ 0.7: the log-decay reaches about
    -180 over a 256-token chunk) leaves every output finite, and
    tests/test_kernels.py's causality case holds on the kernel."""
    ins = _ssd_inputs(card, 16, 2, 256, 64, 128, decay=0.7)
    assert ins[1][..., -1].max().item() < -100
    got = _ssd_on_route(ins, "mma")
    assert torch.isfinite(got).all()
    assert _row_err(got, ssd_chunk_diag_ref(*ins)) <= SSD_TOL["float32"]
    x, dta, b, c = _ssd_inputs(card, 1, 1, 16, 8, 4)
    x2 = x.clone()
    x2[:, :, 10:, :] = 123.0
    y1, y2 = ssd_chunk_diag(x, dta, b, c), ssd_chunk_diag(x2, dta, b, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(y1[:, :, :10], y2[:, :, :10], rtol=1e-5,
                               atol=0)


def test_ssd_chunk_diag_kernel_rejects_mixed_dtypes(card):
    x, dta, b, c = _ssd_inputs(card, 2, 1, 8, 8, 8)
    with pytest.raises(TypeError, match="f32/bf16"):
        ssd_chunk_diag(x, dta.double(), b, c)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk_diag(x.transpose(2, 3).contiguous().transpose(2, 3), dta,
                       b, c)


@pytest.mark.parametrize("mode", ["eager", "graph"])
def test_mamba_forward_reduced_on_kernels(card, mode):
    """Reduced mamba2-370m (f32, 2 layers) Model.forward on the card: one
    SSD launch per layer, 6 GEMMs per layer + the tied head in eager mode
    (graph mode: z/x and B/C in one batched launch each), logits within
    1e-4 of the plain device path's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch("mamba2-370m").reduced(),
                              forward_mode=mode)
    model = build_model(cfg)
    params = model.init_params(card, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=card,
                           device="cuda")
    gemm.launches = gemm_batched.launches = ssd_chunk_diag.launches = 0
    ssd_routes = dict(ssd_chunk_diag.route_launches)
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        got, _ = model.forward(params, tokens)
    torch.cuda.synchronize()
    L = cfg.num_layers
    want_counts = ((6 * L + 1, 0) if mode == "eager" else (2 * L + 1, 2 * L))
    assert (gemm.launches, gemm_batched.launches) == want_counts
    assert ssd_chunk_diag.launches == L
    assert ssd_chunk_diag.route_launches["mma"] - ssd_routes["mma"] == L
    with offload_policy(mode="device", use_kernels=False), torch.no_grad():
        want, _ = model.forward(params, tokens)
    assert _err(got, want) <= 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_mamba_serve_reduced_on_kernels(card):
    """Reduced mamba2-370m served on the card: 6 GEMMs per layer + the head
    per decode step, no SSD launch (decode is the one-step recurrence), and
    the kernel path's greedy tokens equal the plain path's."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch

    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(1, 200, size=4))) for _ in range(8)]
    gemm.launches = ssd_chunk_diag.launches = 0
    with offload_policy(mode="device", use_kernels=True):
        got = serve_batch("mamba2-370m", prompts, max_new_tokens=4)
    assert gemm.launches == (4 + 4) * (6 * 2 + 1)
    assert ssd_chunk_diag.launches == 0
    with offload_policy(mode="device", use_kernels=False):
        want = serve_batch("mamba2-370m", prompts, max_new_tokens=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)


# qwen3-moe-30b-a3b's expert GEMMs: E 128 experts, m = groups x capacity
# (64 in a decode step of 8 tokens, 128 in a 2 x 512 forward), gate / up
# 2048 -> 768 and down 768 -> 2048 (the ``moe_gemm`` lowering row).
MOE_EXPERT_SHAPES = [(m, k, n) for m in (64, 128)
                     for k, n in ((2048, 768), (768, 2048))]


@pytest.mark.parametrize("m,k,n", MOE_EXPERT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_batched_moe_expert_shapes(card, m, k, n, dtype):
    from repro_torch.kernels.ref import moe_gemm_ref

    dt = getattr(torch, dtype)
    a = torch.randn(128, m, k, generator=card, device="cuda").to(dt)
    b = (torch.randn(128, k, n, generator=card, device="cuda")
         * k ** -0.5).to(dt)
    _, batched = _route_counts()
    got = gemm_batched(a, b)
    torch.cuda.synchronize()
    route = "wgmma" if dtype == "bfloat16" else "tiled"
    assert gemm_batched.route_launches == {**batched,
                                           route: batched[route] + 1}
    assert _err(got, moe_gemm_ref(a, b)) <= TOL[dtype]


def test_gemm_batched_moe_stack_equals_single_launches(card):
    """The decode step's gate GEMM over 128 experts in one launch equals the
    128 single launches bit for bit."""
    a = torch.randn(128, 64, 2048, generator=card, device="cuda").to(
        torch.bfloat16)
    b = torch.randn(128, 2048, 768, generator=card, device="cuda").to(
        torch.bfloat16)
    got = gemm_batched(a, b)
    want = torch.stack([gemm(a[i], b[i]) for i in range(128)])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _moe_layer(card, dtype=torch.bfloat16):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(),
                              moe_dispatch="grouped")
    p = M.init_moe(card, cfg, dtype, device="cuda")
    x = torch.randn(4, 16, cfg.d_model, generator=card, device="cuda").to(
        dtype)
    return cfg, p, x


def test_moe_ffn_on_kernels_repeats_and_matches_plain(card):
    """The grouped MoE layer on the card: the kernel path launches the
    batched GEMM three times, repeats bit for bit (the unpack sums in a
    fixed order, no atomics) and matches the plain path (bf16 bar)."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import moe as M

    cfg, p, x = _moe_layer(card)
    before = gemm_batched.launches
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        a, aux = M.moe_ffn(p, x, cfg)
        b, _ = M.moe_ffn(p, x, cfg)
    torch.cuda.synchronize()
    assert gemm_batched.launches == before + 6
    assert torch.equal(a, b)
    with offload_policy(mode="device", use_kernels=False), torch.no_grad():
        want, want_aux = M.moe_ffn(p, x, cfg)
    assert _err(a, want) <= TOL["bfloat16"]
    assert float(aux) == pytest.approx(float(want_aux), rel=2e-2)


def test_moe_placed_equals_unplaced_on_the_card(card):
    """``moe_ffn_placed`` with a live placement policy over 4 modeled lanes
    equals the unplaced grouped layer bit for bit on the kernels."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.core.placement import (ExpertPlacementPolicy,
                                            PlacementConfig)
    from repro_torch.models import moe as M

    cfg, p, x = _moe_layer(card)
    with offload_policy(mode="device", use_kernels=True,
                        num_devices=4) as cluster, torch.no_grad():
        want, _ = M.moe_ffn(p, x, cfg)
        pol = ExpertPlacementPolicy(
            PlacementConfig(num_experts=cfg.num_experts), cluster)
        pol.attach()
        before = gemm_batched.launches
        got, _ = M.moe_ffn_placed(p, x, cfg, policy=pol)
    torch.cuda.synchronize()
    assert gemm_batched.launches == before + 3
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["eager", "graph"])
def test_moe_serve_reduced_on_kernels(card, mode):
    """Reduced qwen3-moe (f32, 2 layers) served on the card: each decode
    step launches the GEMM kernel for qkv and wo (the reduced router's 4
    experts are under the kernel gate) and the head, the batched GEMM
    three times a layer, flash decode once a layer; greedy tokens equal
    the plain path's."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch

    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, 200, size=4))) for _ in range(8)]
    gemm.launches = gemm_batched.launches = flash_decode.launches = 0
    with offload_policy(mode="device", use_kernels=True):
        got = serve_batch("qwen3-moe-30b-a3b", prompts, max_new_tokens=4,
                          forward_mode=mode)
    steps, layers = 4 + 4, 2
    assert gemm.launches == steps * (2 * layers + 1)
    assert gemm_batched.launches == steps * 3 * layers
    assert flash_decode.launches == steps * layers
    with offload_policy(mode="device", use_kernels=False):
        want = serve_batch("qwen3-moe-30b-a3b", prompts, max_new_tokens=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
