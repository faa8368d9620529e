"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (``gpu`` marker) and skips without one.
The file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Tolerances are
``tests/test_kernels.py``'s, f32 2e-5 and bf16 2e-2, of max |plain|
(for attention, of each output row's max |plain|); the SSD chunk kernel's
is 1e-4 in f32 (``tests/test_kernels.py:169``), of each output row's max
|plain|.  The Mamba-2 conv kernel's pre-activation equals its plain
version's bit for bit, and its SiLU output lies within 4 f32 ulp.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import (cluster_capacity, decode_plan,
                                              flash_decode, flash_decode_route)
from repro_torch.kernels.gemm import gemm, gemm_batched
from repro_torch.kernels.ref import (attention_ref, causal_conv_silu_ref,
                                     decode_attention_ref, gemm_batched_ref,
                                     gemm_ref, ssd_chunk_diag_ref,
                                     ssd_scan_ref)
from repro_torch.kernels.ssd_scan import (causal_conv_silu, conv_route,
                                          scan_route, ssd_chunk_diag,
                                          ssd_route, ssd_scan)

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


# The wgmma tile order (kernels/gemm.py::wgmma_plan), forced: ragged m and
# n (neither a multiple of 128) with groups that leave a short last group,
# one group a m tile, and the plan's own; the narrow BN 64 tile (n <= 64);
# both B layouts.  m 2000 is 16 m tiles.
ORDER_CASES = [(2000, 1000, 264, "mn"), (2000, 1000, 264, "k"),
               (2000, 48, 512, "mn"), (2000, 64, 512, "k"),
               (1100, 1800, 136, "mn")]


def _wgmma_in_order(a, b, c, group):
    from repro_torch.kernels import gemm as G

    z, m, k = a.shape
    n = b.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    assert G._launch_gemm(a, b, c, m, n, k, z, a.stride(), b.stride(),
                          c.stride()[:2], "wgmma", stream, group=group) == 0
    torch.cuda.synchronize()
    return c


@pytest.mark.parametrize("m,n,k,layout", ORDER_CASES,
                         ids=["x".join(map(str, c)) for c in ORDER_CASES])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_gemm_wgmma_grouped_order_equals_plain_bit_for_bit(card, m, n, k,
                                                           layout, out):
    """Every group size gives the plain order's C bit for bit: only which
    block computes which tile changes."""
    from repro_torch.kernels import gemm as G

    a = torch.randn(1, m, k, generator=card, device="cuda").bfloat16()
    b = _b_operand(card, k, n, layout)[None]
    m_tiles = -(-m // 128)
    plain = _wgmma_in_order(
        a, b, torch.empty(1, m, n, dtype=getattr(torch, out), device="cuda"),
        m_tiles)
    assert _err(plain[0], gemm_ref(a[0], b[0], out_dtype=torch.float32)) \
        <= TOL["bfloat16"]
    for group in sorted({1, 3, 5, 7, G.wgmma_plan(m, n, k, 1,
                                                   G.sm_count(0))}):
        c = torch.full_like(plain, float("nan"))
        assert torch.equal(_wgmma_in_order(a, b, c, group), plain), group


@pytest.mark.parametrize("layout", ["mn", "k"])
def test_gemm_batched_grouped_order_with_a_broadcast_operand(card, layout):
    """A stack with A broadcast (batch stride 0) in grouped order equals the
    plain order bit for bit, each batch entry ordered alone."""
    m, k, n = 1500, 512, 712
    a = torch.randn(m, k, generator=card, device="cuda").bfloat16().expand(
        3, m, k)
    bs = [_b_operand(card, k, n, layout) for _ in range(3)]
    b = torch.stack(bs) if layout == "mn" else \
        torch.stack([x.T for x in bs]).transpose(1, 2)
    plain = _wgmma_in_order(a, b, torch.empty(3, m, n, dtype=torch.bfloat16,
                                              device="cuda"), -(-m // 128))
    for group in (2, 5):
        c = torch.full_like(plain, float("nan"))
        assert torch.equal(_wgmma_in_order(a, b, c, group), plain), group
    assert torch.equal(gemm_batched(a, b), plain)


def test_gemm_grouped_launches_counted_at_large_m_only(card):
    """A launch at m 16384 runs in grouped order and counts once in
    ``grouped_launches``; one at m 1024 keeps the plain order and does not
    count; the batched wrapper counts its own."""
    a = torch.randn(16384, 1024, generator=card, device="cuda").bfloat16()
    b = _b_operand(card, 1024, 256, "mn")
    before = (gemm.grouped_launches, gemm_batched.grouped_launches)
    gemm(a, b)
    assert gemm.grouped_launches == before[0] + 1
    gemm(a[:1024], b)
    gemm_batched(a[:1024].expand(2, 1024, 1024), b.expand(2, 1024, 256))
    assert (gemm.grouped_launches, gemm_batched.grouped_launches) == \
        (before[0] + 1, before[1])
    gemm_batched(a.expand(2, 16384, 1024), b.expand(2, 1024, 256))
    torch.cuda.synchronize()
    assert gemm_batched.grouped_launches == before[1] + 1


def test_gemm_wgmma_yi6b_shape_at_m16384_holds_the_bar(card):
    """yi-6b's fused qkv projection at the benchmark's 4 x 4096 tokens, in
    the plan's grouped order, within the bf16 bar of the plain version."""
    a = torch.randn(16384, 4096, generator=card, device="cuda").bfloat16()
    b = _b_operand(card, 4096, 5120, "mn")
    before = gemm.grouped_launches
    got = gemm(a, b)
    torch.cuda.synchronize()
    assert gemm.grouped_launches == before + 1
    assert _err(got, gemm_ref(a, b, out_dtype=torch.float32)) \
        <= TOL["bfloat16"]


def test_gemm_routes_counted_by_kernel(card):
    """Serving shapes (m = 8) take the skinny kernel, f32 at m > 16 the
    3xTF32 tensor-core tile (a column-major A too), bf16 with a
    column-major A the CUDA-core tile, bf16 at m > 16 the tensor cores."""
    bf16 = torch.bfloat16
    cases = [
        ((8, 4096), (4096, 5120), bf16, False, "skinny"),
        ((128, 256), (256, 128), torch.float32, False, "tf32x3"),
        ((256, 128), (256, 128), torch.float32, True, "tf32x3"),
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


# The f32 tensor-core route (tf32x3: 3xTF32 mma.sync, m > 16): Fig. 3's
# square n, the reference tests' shapes, and ragged ones (m, n, k off
# every block tile; k off 4 and 8; n = 1), each with A row- and
# column-major and B MN- and K-major, against the plain version at the
# f32 bar.
T3_SHAPES = [(32, 32, 32), (64, 64, 64), (128, 128, 128), (256, 256, 256),
             (200, 130, 96), (100, 200, 1000), (17, 72, 104),
             (1000, 5128, 1048), (33, 7, 5), (300, 1, 1001)]


def _t3_operands(card, m, n, k, a_layout, b_layout, dt=torch.float32):
    a = torch.randn(m, k, generator=card, device="cuda") if a_layout == "row" \
        else torch.randn(k, m, generator=card, device="cuda").T
    return a.to(dt), _b_operand(card, k, n, b_layout, dt)


def _on_tf32x3(fn, *args, count=1, **kw):
    before = dict(fn.route_launches)
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.route_launches == {**before, "tf32x3": before["tf32x3"] + count}
    return got


@pytest.mark.parametrize("m,n,k", T3_SHAPES,
                         ids=["x".join(map(str, s)) for s in T3_SHAPES])
@pytest.mark.parametrize("a_layout", ["row", "col"])
@pytest.mark.parametrize("b_layout", ["mn", "k"])
def test_gemm_tf32x3_route(card, m, n, k, a_layout, b_layout):
    a, b = _t3_operands(card, m, n, k, a_layout, b_layout)
    got = _on_tf32x3(gemm, a, b)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _err(got, gemm_ref(a, b)) <= TOL["float32"]
    again = _on_tf32x3(gemm, a, b)
    assert torch.equal(got, again)          # a launch repeats bit for bit
    half = _on_tf32x3(gemm, a, b, out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert _err(half, gemm_ref(a, b)) <= TOL["bfloat16"]


@pytest.mark.parametrize("tile", [(128, 64), (64, 64), (32, 32)])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("a_layout", ["row", "col"])
@pytest.mark.parametrize("b_layout", ["mn", "k"])
def test_gemm_tf32x3_every_tile_and_split(card, tile, splits, a_layout,
                                          b_layout):
    """Every kernel instance (block tile x operand layouts) with every
    cluster size the plan may name, forced on one ragged shape, with the
    16-byte copies the operands allow and with 4-byte copies only: all at
    the f32 bar."""
    from repro_torch.kernels import gemm as G

    m, n, k = 150, 170, 1000
    a, b = _t3_operands(card, m, n, k, a_layout, b_layout)
    want = gemm_ref(a, b)
    sa, sb = (0, *a.stride()), (0, *b.stride())
    kc = 8 * -(-k // (8 * splits))
    plan = G.tf32x3_plan(m, n, k, a.dtype, sa, sb, a.data_ptr(),
                         b.data_ptr(), G.tf32x3_capacity(0))._replace(
                             bm=tile[0], bn=tile[1], splits=splits, kc=kc)
    stream = torch.cuda.current_stream().cuda_stream
    for p in (plan, plan._replace(a_vec=False, b_vec=False)):
        c = torch.empty(m, n, device="cuda")
        assert G._launch_gemm(a, b, c, m, n, k, 1, sa, sb, (0, n), "tf32x3",
                              stream, p) == 0
        torch.cuda.synchronize()
        assert _err(c, want) <= TOL["float32"]


def test_gemm_tf32x3_capacity_is_the_cards(card):
    """The plan's capacity table comes from the card: for every tile and
    cluster size 1..8, a whole number of clusters, at least one, and the
    same table on a second ask (cached once per card)."""
    from repro_torch.kernels import gemm as G

    caps = G.tf32x3_capacity(0)
    assert set(caps) == set(G._T3_TILES)
    for tile, row in caps.items():
        assert len(row) == 8
        for splits, blocks in enumerate(row, 1):
            assert blocks >= splits and blocks % splits == 0, (tile, row)
    assert G.tf32x3_capacity(0) is caps


def test_gemm_tf32x3_plan_refused_when_operands_forbid_it(card):
    """The kernel's entry point refuses 16-byte copies the operands do not
    allow (a misaligned base) and a plan whose splits do not cover k: the
    wrapper never sends them, and a caller that does gets an error, not a
    wrong result."""
    from repro_torch.kernels import gemm as G

    m, n, k = 64, 64, 256
    flat = torch.randn(m * k + 1, generator=card, device="cuda")
    a, b = flat[1:].view(m, k), torch.randn(k, n, generator=card,
                                            device="cuda")
    sa, sb = (0, *a.stride()), (0, *b.stride())
    plan = G.tf32x3_plan(m, n, k, a.dtype, sa, sb, a.data_ptr(),
                         b.data_ptr(), G.tf32x3_capacity(0))
    assert not plan.a_vec and plan.b_vec
    c = torch.empty(m, n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for bad in (plan._replace(a_vec=True), plan._replace(splits=2, kc=64),
                plan._replace(splits=9, kc=32), plan._replace(kc=12)):
        assert G._launch_gemm(a, b, c, m, n, k, 1, sa, sb, (0, n), "tf32x3",
                              stream, bad) != 0
    assert G._launch_gemm(a, b, c, m, n, k, 1, sa, sb, (0, n), "tf32x3",
                          stream, plan) == 0
    torch.cuda.synchronize()
    assert _err(c, gemm_ref(a, b)) <= TOL["float32"]


@pytest.mark.parametrize("m,n,k", [(128, 512, 11008), (128, 4096, 4096),
                                   (512, 1024, 2048)],
                         ids=["yi-down-k11008", "yi-wo", "mamba-out"])
def test_gemm_tf32x3_long_k_holds_the_bar(card, m, n, k):
    """At the yi-6b f32 forward's down projection (k 11008: 344 staged k
    tiles, each one restart of the tensor core's truncating accumulator)
    and at forward shapes split across a cluster, the f32 bar holds."""
    a = torch.randn(m, k, generator=card, device="cuda")
    b = torch.randn(k, n, generator=card, device="cuda")
    got = _on_tf32x3(gemm, a, b)
    assert _err(got, gemm_ref(a, b)) <= TOL["float32"]


def test_gemm_tf32x3_zero_k_and_misaligned(card):
    """k = 0 writes zeros; a base one element past a 16-byte boundary and
    odd row strides take 4-byte copies with the same results."""
    a = torch.randn(40, 0, device="cuda")
    b = torch.randn(0, 24, device="cuda")
    got = _on_tf32x3(gemm, a, b)
    assert got.shape == (40, 24) and not got.any()
    m, n, k = 130, 90, 515
    fa = torch.randn(m * (k + 3) + 1, generator=card, device="cuda")
    fb = torch.randn(k * (n + 1) + 1, generator=card, device="cuda")
    a = fa[1:].view(m, k + 3)[:, :k]
    b = fb[1:].view(k, n + 1)[:, :n]
    got = _on_tf32x3(gemm, a, b)
    assert _err(got, gemm_ref(a, b)) <= TOL["float32"]


@pytest.mark.parametrize("m,k,n", [(64, 2048, 768), (128, 768, 2048),
                                   (300, 520, 130)])
@pytest.mark.parametrize("broadcast", ["none", "a", "b"])
def test_gemm_tf32x3_stacked_equals_single_and_repeats(card, m, k, n,
                                                       broadcast):
    """A stack of f32 GEMMs in one batched launch (qwen3-moe's expert
    shapes, a ragged one; one operand broadcast with batch stride 0 or
    none) equals its single launches bit for bit, and repeats bit for bit:
    the plan ignores the batch count, the split-k sum has a fixed order."""
    z = 4
    a = torch.randn(z, m, k, generator=card, device="cuda")
    b = torch.randn(z, k, n, generator=card, device="cuda")
    if broadcast == "a":
        a = a[:1].expand(z, m, k)
    elif broadcast == "b":
        b = b[:1].expand(z, k, n)
    got = _on_tf32x3(gemm_batched, a, b)
    again = _on_tf32x3(gemm_batched, a, b)
    singles = torch.stack([_on_tf32x3(gemm, a[i], b[i]) for i in range(z)])
    assert torch.equal(got, again) and torch.equal(got, singles)
    assert _err(got, gemm_batched_ref(a, b)) <= TOL["float32"]


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


# The bf16 tensor-core route (D 64 / 80 / 128): the prefill geometry as
# contiguous tensors and as the model's (B, S, H, D) transposed views, a
# suffix (Sq < Skv), ragged lengths, a window, bidirectional, GQA 8:1 and
# 1:1, windows that leave rows no key (0 or less), whose outputs must be
# exactly 0, and kv loops long enough to wrap the ring of K / V stages
# (three stages at D 64, two at D 128) more than once; at D 80 (the
# 128-wide tile, columns 80-127 zero-filled) causal, window 20, window 0,
# bidirectional, GQA 8 / 2 and 32 / 4 (h2o-danube's 32 / 8 too), ragged
# Sq 77 / Skv 130, on views whose neighbouring head holds data.
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
    dict(b=2, sq=256, skv=256, hq=8, hkv=2, d=80, causal=True, view=True),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=True, window=20),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=True, window=20,
         view=True),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=True, window=0,
         view=True),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=False, view=True),
    dict(b=2, sq=130, skv=130, hq=16, hkv=16, d=80, causal=False, view=True),
    dict(b=1, sq=300, skv=300, hq=32, hkv=4, d=80, causal=True, view=True),
    dict(b=1, sq=600, skv=600, hq=32, hkv=8, d=80, causal=True, window=256,
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


def _attn_on_route(card, case, dtype, route):
    """One launch on ``route`` (the route counter moves there and nowhere
    else), checked against the plain version at the dtype's bar, fully
    masked rows exactly 0, and a repeat launch equal bit for bit."""
    q, k, v = _attn_operands(card, case, dtype)
    kw = dict(causal=case["causal"], window=case.get("window"))
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.route_launches == {
        **before, route: before[route] + 2}
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    want = attention_ref(q, k, v, **kw)
    dead = want.float().abs().amax(dim=-1) == 0
    if (~dead).any():
        assert _row_err(got, want) <= TOL[str(dtype).split(".")[1]]
    window = case.get("window")
    assert bool(dead.any()) == (window is not None and window <= 0)
    if dead.any():
        assert got[dead].abs().max().item() == 0.0


@pytest.mark.parametrize("case", WGMMA_ATTN_CASES, ids=_attn_id)
def test_flash_attention_wgmma_route(card, case):
    _attn_on_route(card, case, torch.bfloat16, "wgmma")


# The f32 tensor-core route (3xTF32 mma.sync; D a multiple of 8 up to 128):
# causal, window 20, window 0 and -5 (rows exactly 0), bidirectional, GQA
# 8 / 2 and 32 / 4, ragged Sq 77 / Skv 130 and a suffix (Sq < Skv), the
# yi-6b f32 check's 1 x 128 x 32 / 4 heads, contiguous and as transposed
# views, jamba's f32 1 x 512 x 64 / 8, at D 128, 80, 64 and 16.
TF32X3_ATTN_CASES = [
    dict(b=2, sq=128, skv=128, hq=8, hkv=2, d=128, causal=True),
    dict(b=1, sq=128, skv=128, hq=32, hkv=4, d=128, causal=True),
    dict(b=1, sq=128, skv=128, hq=32, hkv=4, d=128, causal=True, view=True),
    dict(b=1, sq=512, skv=512, hq=64, hkv=8, d=128, causal=True, view=True),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=128, causal=True, window=20),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=128, causal=True, window=0),
    dict(b=1, sq=200, skv=200, hq=8, hkv=1, d=128, causal=False, window=-5,
         view=True),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=128, causal=False, view=True),
    dict(b=2, sq=16, skv=128, hq=4, hkv=2, d=128, causal=True),
    dict(b=1, sq=600, skv=600, hq=4, hkv=2, d=128, causal=True, window=300),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=False),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=True, window=20,
         view=True),
    dict(b=2, sq=130, skv=130, hq=4, hkv=4, d=64, causal=True),
    dict(b=2, sq=70, skv=70, hq=4, hkv=2, d=16, causal=True, window=3,
         view=True),
]


@pytest.mark.parametrize("case", TF32X3_ATTN_CASES, ids=_attn_id)
def test_flash_attention_tf32x3_route(card, case):
    _attn_on_route(card, case, torch.float32, "tf32x3")


@pytest.mark.parametrize("dtype,route", [("bfloat16", "wgmma"),
                                         ("float32", "tf32x3")])
def test_flash_attention_d80_stores_stop_at_the_head_dim(card, dtype, route):
    """D 80 runs a 128-wide tile: launched through the C entry into an
    output whose rows are 128 wide (a sentinel in columns 80-127), the
    kernel writes columns 0-79 of each row and nothing else."""
    import repro_torch.kernels.flash_attention as fa

    dt = getattr(torch, dtype)
    case = dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=True,
                window=20, view=True)
    q, k, v = _attn_operands(card, case, dt)
    wide = torch.full((2, 8, 77, 128), 7.0, dtype=dt, device="cuda")
    out = wide[..., :80]
    err = fa._fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   2, 8, 2, 77, 130, 80, 1, 1, 20, 80 ** -0.5,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *out.stride()[:3], fa._DTYPE_CODE[dt],
                   fa.ROUTES.index(route),
                   torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert bool((wide[..., 80:] == 7.0).all())
    want = attention_ref(q, k, v, causal=True, window=20)
    assert _row_err(out, want) <= TOL[dtype]


@pytest.mark.parametrize("edit", ["bf16", "d136", "d36", "odd-address",
                                  "odd-stride"])
def test_flash_attention_tf32x3_refuses_what_the_route_refuses(card, edit):
    """Named through the C entry, the f32 route refuses operands
    flash_attention_route would not send it (cudaErrorInvalidValue) and
    writes nothing: there is no fallback inside the kernel either."""
    import repro_torch.kernels.flash_attention as fa

    d = {"d136": 136, "d36": 36}.get(edit, 128)
    dt = torch.bfloat16 if edit == "bf16" else torch.float32
    case = dict(b=1, sq=64, skv=64, hq=4, hkv=2, d=d)
    q, k, v = _attn_operands(card, case, dt)
    if edit == "odd-address":
        flat = torch.randn(k.numel() + 1, generator=card, device="cuda")
        k = flat[1:].view(k.shape)
    if edit == "odd-stride":
        wide = torch.randn(1, 2, 64, d + 1, generator=card, device="cuda")
        k = wide[..., :d]
    out = torch.full(q.shape, 7.0, dtype=dt, device="cuda")
    err = fa._fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   1, 4, 2, 64, 64, d, 1, 0, 0, d ** -0.5,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *out.stride()[:3], fa._DTYPE_CODE[dt],
                   fa.ROUTES.index("tf32x3"),
                   torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 1                     # cudaErrorInvalidValue
    assert bool((out == 7.0).all())


# The CUDA-core route keeps what neither tensor-core tile takes: bf16 D 32
# (the reference tests), f32 at a D that is not a multiple of 8 or over
# 128, and operands the 16-byte copies cannot address (below).
SIMT_ATTN_CASES = [
    dict(b=2, sq=128, skv=128, hq=8, hkv=2, d=32, causal=True,
         dtype="bfloat16"),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=36, causal=True, window=20,
         dtype="float32"),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=136, causal=False,
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


@pytest.mark.parametrize("dtype,d", [("bfloat16", 128), ("bfloat16", 80),
                                     ("float32", 128), ("float32", 80)])
def test_flash_attention_misaligned_operand_takes_simt(card, dtype, d):
    """A k whose base address is off by one element cannot be a TMA or a
    16-byte cp.async operand: the call runs on the CUDA cores instead."""
    dt = getattr(torch, dtype)
    case = dict(b=1, sq=64, skv=64, hq=4, hkv=2, d=d)
    q, k, v = _attn_operands(card, case, dt)
    flat = torch.randn(k.numel() + 1, generator=card, device="cuda").to(dt)
    k_odd = flat[1:].view(k.shape)
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k_odd, v)
    torch.cuda.synchronize()
    assert flash_attention.route_launches == {
        **before, "simt": before["simt"] + 1}
    assert _row_err(got, attention_ref(q, k_odd, v)) <= TOL[dtype]


def test_flash_attention_broadcast_batch_takes_simt(card):
    """A k / v broadcast over the batch (stride 0) runs on the CUDA cores,
    in bf16 and f32."""
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(2, 8, 77, 80, generator=card, device="cuda").to(dt)
        k = torch.randn(1, 2, 130, 80, generator=card,
                        device="cuda").to(dt).expand(2, -1, -1, -1)
        v = torch.randn(1, 2, 130, 80, generator=card,
                        device="cuda").to(dt).expand(2, -1, -1, -1)
        before = dict(flash_attention.route_launches)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention.route_launches == {
            **before, "simt": before["simt"] + 1}
        assert _row_err(got, attention_ref(q, k, v)) <= \
            TOL[str(dt).split(".")[1]]


# A column slice x[:, :k] of a wider matrix (row stride > k) as A and as B,
# on every GEMM route: skinny (m <= 16), tf32x3 (f32, m > 16), tiled (bf16
# with a slice TMA cannot address) and wgmma (bf16, m > 16, 16-byte-aligned
# rows).
SLICE_CASES = [(8, 256, 192, "float32", "skinny"),
               (8, 256, 192, "bfloat16", "skinny"),
               (200, 136, 192, "float32", "tf32x3"),
               (200, 136, 101, "float32", "tf32x3"),
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
    B layouts, the K-major one read in place as a transpose) and, at
    m > 16, the f32 tensor-core kernel (tf32x3; A also column-major, read
    in place as a transpose) against the reference's Pallas GEMM on the
    same numpy inputs: its outputs kept in
    ``tests/data/gemm_skinny_pallas.npz`` (this machine has no JAX; see
    ``tests/gemm_pallas_ref.py``)."""
    a, b = gemm_pallas_ref.inputs(cid)
    want = torch.from_numpy(gemm_pallas_ref.load()[cid])
    dt = getattr(torch, dtype)
    route = "skinny" if m <= 16 else "tf32x3"
    tb = torch.from_numpy(b).to(dt).cuda() if layout == "mn" else \
        torch.from_numpy(np.ascontiguousarray(b.T)).to(dt).cuda().T
    tas = [torch.from_numpy(a).to(dt).cuda()]
    if route == "tf32x3":
        tas.append(torch.from_numpy(np.ascontiguousarray(a.T)).cuda().T)
    for ta in tas:
        before = dict(gemm.route_launches)
        got = gemm(ta, tb, out_dtype=getattr(torch, out))
        torch.cuda.synchronize()
        assert gemm.route_launches == {**before, route: before[route] + 1}
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


# The whole SSD core on the chunked route (B, S, H, G, P, N, Q): granite's
# mixer, jamba's eight groups, mamba2-370m's forward, then widths and
# chunks off the models' (P 48 and 128, Q not a multiple of 64, G 3, Q = S
# shorter than a query tile).
SCAN_SHAPES = [(4, 4096, 128, 1, 64, 128, 256), (2, 512, 256, 8, 64, 128, 256),
               (4, 1024, 32, 1, 64, 128, 256), (1, 200, 6, 3, 48, 32, 100),
               (2, 256, 4, 2, 128, 64, 128), (2, 96, 8, 8, 16, 16, 32),
               (1, 40, 2, 1, 8, 8, 40)]


def _scan_operands(gen, bsz, s, h, g, p, n):
    """x (B, S, H, P), B and C (B, S, G, N) as views of one conv-output-
    shaped (B, S, H·P + 2·G·N) f32 buffer (SiLU'd, as the conv gives them),
    dt = softplus(·), a < 0, and d_skip 0: the SSD term alone, which the
    3xTF32 products compute.  (Where D·x cancels a row's SSD term, the row
    keeps the terms' absolute errors: at granite's shape the plain core in
    f32 reads up to 1.2e-4 of such a row against float64 with d_skip ones
    and 4.3e-4 with a random sign, so no bar of 1e-4 between two f32
    computations can hold there.  The D skip is held alone, by
    ``test_ssd_scan_chunked_adds_the_d_skip``.)"""
    f = h * p + 2 * g * n
    buf = torch.nn.functional.silu(
        torch.randn(bsz, s, f, generator=gen, device="cuda"))
    x = buf[..., :h * p].view(bsz, s, h, p)
    b = buf[..., h * p:h * p + g * n].view(bsz, s, g, n)
    c = buf[..., h * p + g * n:].view(bsz, s, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, s, h, generator=gen, device="cuda") - 1.0)
    a = -torch.exp(0.5 * torch.randn(h, generator=gen, device="cuda"))
    d = torch.zeros(h, device="cuda")
    return x, dt, a, b, c, d


@pytest.mark.parametrize("shape", SCAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_scan_chunked_kernels_match_the_plain_core(card, shape):
    """The chunked route's three kernels read x, B and C in place from the
    conv's (B, S, F) output and B and C once a group; every output row lies
    within the SSD bar of the plain core's, one launch of each kernel, no
    chunk-diag launch, and a repeated call gives the same bits."""
    bsz, s, h, g, p, n, q = shape
    x, dt, a, b, c, d = _scan_operands(card, bsz, s, h, g, p, n)
    assert not x.is_contiguous() and not b.is_contiguous()
    assert scan_route(x, dt, b, c, q) == "chunked"
    before = (dict(ssd_scan.kernel_launches), ssd_chunk_diag.launches)
    got = ssd_scan(x, dt, a, b, c, d, chunk=q)
    torch.cuda.synchronize()
    assert {k: v - before[0][k] for k, v in ssd_scan.kernel_launches.items()} \
        == {"state": 1, "pass": 1, "output": 1}
    assert ssd_chunk_diag.launches == before[1]
    assert got.shape == (bsz, s, h, p) and got.is_contiguous()
    assert torch.isfinite(got).all()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = ssd_scan_ref(x, dt, a, b, c, d, q)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert _row_err(got, want) <= SSD_TOL["float32"]
    assert torch.equal(got, ssd_scan(x, dt, a, b, c, d, chunk=q))


def test_ssd_scan_chunked_adds_the_d_skip(card):
    """The chunk output adds D·x once to the SSD term, in fp32: with a D of
    random sign the output less the D = 0 output is D·x within the
    rounding of the two sums, at granite's shape."""
    x, dt, a, b, c, zero = _scan_operands(card, 4, 4096, 128, 1, 64, 128)
    d = torch.randn(128, generator=card, device="cuda")
    y0 = ssd_scan(x, dt, a, b, c, zero, chunk=256)
    yd = ssd_scan(x, dt, a, b, c, d, chunk=256)
    dx = d[None, None, :, None] * x
    ulp = torch.finfo(torch.float32).eps
    assert ((yd - y0 - dx).abs() <= 2 * ulp * (y0.abs() + dx.abs() + yd.abs())
            ).all()


def test_ssd_scan_takes_the_composition_for_what_the_chunked_kernels_do_not(
        card):
    """bf16 operands and P > 128 take the composed route: B and C repeated
    per head around the chunk-diag kernel, as before."""
    for dtype, p in ((torch.bfloat16, 64), (torch.float32, 132)):
        x, dt, a, b, c, d = _scan_operands(card, 2, 128, 4, 2, p, 16)
        x, b, c = x.to(dtype), b.to(dtype), c.to(dtype)
        assert scan_route(x, dt, b, c, 64) == "composed"
        before = (ssd_scan.route_launches["composed"], ssd_chunk_diag.launches)
        got = ssd_scan(x, dt, a, b, c, d, chunk=64)
        torch.cuda.synchronize()
        assert ssd_scan.route_launches["composed"] == before[0] + 1
        assert ssd_chunk_diag.launches == before[1] + 1
        want = ssd_scan_ref(x, dt, a, b, c, d, 64)
        assert _row_err(got, want) <= SSD_TOL[str(dtype).split(".")[1]]


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


# The Mamba-2 mixer's causal conv + SiLU (csrc/mamba_conv.cuh): (B, S, di,
# G·N, K) at granite-4.0-h-small's prefill (4 x 4096, F 8448), mamba2-370m's
# forward (F 2304), jamba's widths (8 groups, F 17408) over an odd S, and
# small odd shapes (S below the conv width, one position, S not a multiple
# of the kernel's 32-row runs).  K is 4, the only conv width it is built
# for.
CONV_SHAPES = [(4, 4096, 8192, 128, 4), (4, 1024, 2048, 128, 4),
               (1, 333, 16384, 1024, 4), (3, 77, 64, 16, 4), (2, 2, 64, 16, 4),
               (2, 45, 32, 8, 4), (3, 1, 32, 8, 4)]


def _conv_operands(gen, bsz, s, di, gn, k, dtype, bias_scale=0.1):
    """x, B, C as the projections write them, the model's taps (0.2 N(0, 1))
    and a bias of ``bias_scale`` N(0, 1), all in ``dtype``."""
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    return (randn(bsz, s, di), randn(bsz, s, gn), randn(bsz, s, gn),
            randn(k, di + 2 * gn, scale=0.2),
            randn(di + 2 * gn, scale=bias_scale))


def _ulps(got, want):
    """Largest distance in f32 units in the last place (same signs)."""
    return (got.view(torch.int32).long()
            - want.view(torch.int32).long()).abs().max().item()


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_causal_conv_silu_kernel(card, shape, dtype):
    """The pre-activation equals the plain version's bit for bit and the
    SiLU output lies within 4 f32 ulp of it, one launch a call."""
    ops = _conv_operands(card, *shape, getattr(torch, dtype))
    assert conv_route(*ops) == {"bfloat16": "bf16", "float32": "f32"}[dtype]
    before = dict(causal_conv_silu.route_launches)
    pre = causal_conv_silu(*ops, silu=False)
    got = causal_conv_silu(*ops)
    torch.cuda.synchronize()
    route = conv_route(*ops)
    assert causal_conv_silu.route_launches[route] == before[route] + 2
    want_pre = causal_conv_silu_ref(*ops, silu=False)
    want = causal_conv_silu_ref(*ops)
    bsz, s, di, gn, _ = shape
    assert got.shape == (bsz, s, di + 2 * gn) and got.dtype == torch.float32
    assert torch.equal(pre, want_pre)
    assert _ulps(got, want) <= 4


def test_causal_conv_silu_kernel_keeps_sequences_apart(card):
    """A batch of distinct sequences, one of them all zeros beside one of
    large values: each row's first K − 1 positions see only zeros before
    them (the zero sequence reads exactly silu(bias)), and each sequence
    equals its own launch alone bit for bit."""
    x, b, c, w, bias = _conv_operands(card, 3, 50, 64, 16, 4, torch.bfloat16,
                                      bias_scale=1.0)
    for t in (x, b, c):
        t[1] = 0
        t[0] *= 1000
    pre = causal_conv_silu(x, b, c, w, bias, silu=False)
    got = causal_conv_silu(x, b, c, w, bias)
    alone = [causal_conv_silu(x[i:i + 1], b[i:i + 1], c[i:i + 1], w, bias)
             for i in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(pre[1], bias.float().expand(50, -1))
    for i in range(3):
        assert torch.equal(got[i:i + 1], alone[i])
    assert torch.equal(pre, causal_conv_silu_ref(x, b, c, w, bias,
                                                 silu=False))


def test_causal_conv_silu_kernel_reads_views_in_place(card):
    """x, B and C as column slices of one wide projection (row strides
    past their widths) and with a batch stride of their own: read in
    place, the same result as on contiguous copies."""
    wide = torch.randn(2, 40, 64 + 32 + 16, generator=card,
                       device="cuda").to(torch.bfloat16)
    x, b, c = wide[..., :64], wide[..., 64:80], wide[..., 96:112]
    w = (0.2 * torch.randn(4, 96, generator=card, device="cuda")
         ).to(torch.bfloat16)
    bias = torch.zeros(96, dtype=torch.bfloat16, device="cuda")
    assert conv_route(x, b, c, w, bias) == "bf16"
    got = causal_conv_silu(x, b, c, w, bias, silu=False)
    want = causal_conv_silu(x.contiguous(), b.contiguous(), c.contiguous(),
                            w, bias, silu=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_causal_conv_silu_copies_views_it_cannot_read_in_place(card):
    """Through ``blas.causal_conv_silu`` under the kernel policy: a
    misaligned view, a sequence stride and a batch stride off the 4-channel
    vector are copied, then launched once, the plain version's result bit
    for bit."""
    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy

    bf16 = torch.bfloat16
    x, b, c, w, bias = _conv_operands(card, 2, 20, 64, 16, 4, bf16)
    flat = torch.randn(2 * 20 * 64 + 1, generator=card, device="cuda")
    views = [(flat.to(bf16)[1:].view(2, 20, 64), b, c),
             (torch.randn(2, 20, 66, generator=card,
                          device="cuda").to(bf16)[..., :64], b, c),
             (x, torch.randn(800, generator=card, device="cuda").to(
                 bf16).as_strided((2, 20, 16), (330, 16, 1)), c)]
    for vx, vb, vc in views:
        ops = (vx, vb, vc, w, bias)
        assert conv_route(*ops) is None
        before = causal_conv_silu.launches
        with offload_policy(mode="device", use_kernels=True), \
                torch.no_grad():
            got = blas.causal_conv_silu(*ops)
        torch.cuda.synchronize()
        assert causal_conv_silu.launches == before + 1
        assert torch.equal(causal_conv_silu(*ops, silu=False),
                           causal_conv_silu_ref(*ops, silu=False))
        assert _ulps(got, causal_conv_silu_ref(*ops)) <= 4


def test_causal_conv_silu_refuses_on_the_card_what_no_copy_fits(card):
    """Under the kernel policy, operands on the card that no copy makes
    fit (widths off the 4-channel vector, K 3 and 5, fp16, mixed dtypes)
    raise, through ``blas.causal_conv_silu`` as through the wrapper: no
    launch and no plain version on the card."""
    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy

    bf16 = torch.bfloat16
    cases = [_conv_operands(card, 2, 20, 64, 10, 4, bf16),
             _conv_operands(card, 2, 20, 62, 16, 4, bf16),
             _conv_operands(card, 2, 20, 64, 16, 3, bf16),
             _conv_operands(card, 2, 20, 64, 16, 5, bf16),
             _conv_operands(card, 2, 20, 64, 16, 4, torch.float16)]
    x, b, c, w, bias = _conv_operands(card, 2, 20, 64, 16, 4, bf16)
    cases.append((x, b, c, w.float(), bias))
    for ops in cases:
        assert conv_route(*ops) is None
        before = causal_conv_silu.launches
        with pytest.raises(ValueError, match="causal_conv_silu kernel"):
            with offload_policy(mode="device", use_kernels=True), \
                    torch.no_grad():
                blas.causal_conv_silu(*ops)
        with pytest.raises(ValueError, match="causal_conv_silu kernel"):
            causal_conv_silu(*ops)
        assert causal_conv_silu.launches == before


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_causal_conv_silu_under_grad_launches_the_kernel(card, dtype):
    """Under grad with operands that require it, the kernel policy launches
    the kernel (inside an ``autograd.Function``): one launch, the output of
    the same launch without grad bit for bit, and every operand's gradient
    that of the plain version (which the backward recomputes) bit for
    bit."""
    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy

    ops = _conv_operands(card, 2, 70, 64, 16, 4, getattr(torch, dtype))
    dout = torch.randn(2, 70, 96, generator=card, device="cuda")
    mine = [t.clone().requires_grad_() for t in ops]
    plain = [t.clone().requires_grad_() for t in ops]
    before = causal_conv_silu.launches
    with offload_policy(mode="device", use_kernels=True):
        got = blas.causal_conv_silu(*mine)
    torch.cuda.synchronize()
    assert causal_conv_silu.launches == before + 1
    assert torch.equal(got.detach(), causal_conv_silu(*ops))
    got.backward(dout)
    causal_conv_silu_ref(*plain).backward(dout)
    for t, u in zip(mine, plain):
        assert torch.equal(t.grad, u.grad)


def test_granite_width_mixers_launch_the_conv_kernel_once_each(
        card, monkeypatch):
    """18 Mamba-2 mixers at granite-4.0-h-small's widths (d 4096, 128 heads
    of 64, N 128, one group, conv 4) on 4 x 4096 tokens, as one forward
    runs them: 18 conv launches on ``bf16``, and the mixer's output within
    the bf16 tolerance of the same mixer with the plain conv (the rest of
    the mixer on the kernels in both)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy
    from repro_torch.models.ssm import init_mamba, mamba_block

    cfg = dataclasses.replace(
        get_arch("mamba2-370m"), d_model=4096, ssm_expand=2,
        ssm_head_dim=64, ssm_state_dim=128, ssm_num_groups=1,
        ssm_conv_width=4, ssm_chunk=256, dtype="bfloat16")
    assert cfg.d_inner == 8192 and cfg.ssm_num_heads == 128
    p = init_mamba(card, cfg, torch.bfloat16, device="cuda")
    p["conv_b"] = (0.1 * torch.randn(p["conv_b"].shape, generator=card,
                                     device="cuda")).to(torch.bfloat16)
    h = torch.randn(4, 4096, 4096, generator=card,
                    device="cuda").to(torch.bfloat16)
    before = dict(causal_conv_silu.route_launches)
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        for _ in range(18):
            y = mamba_block(p, h, cfg)
        torch.cuda.synchronize()
        launched = {r: n - before[r]
                    for r, n in causal_conv_silu.route_launches.items()}
        assert launched == {"f32": 0, "bf16": 18}
        monkeypatch.setattr(blas, "causal_conv_silu", causal_conv_silu_ref)
        y_plain = mamba_block(p, h, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert _err(y, y_plain) <= TOL["bfloat16"]


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
    ssd_routes = dict(ssd_scan.route_launches)
    ssd_kernels = dict(ssd_scan.kernel_launches)
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        got, _ = model.forward(params, tokens)
    torch.cuda.synchronize()
    L = cfg.num_layers
    want_counts = ((6 * L + 1, 0) if mode == "eager" else (2 * L + 1, 2 * L))
    assert (gemm.launches, gemm_batched.launches) == want_counts
    # One SSD core a layer, on the chunked kernels: no chunk-diag launch.
    assert ssd_chunk_diag.launches == 0
    assert {r: n - ssd_routes[r] for r, n in ssd_scan.route_launches.items()} \
        == {"chunked": L, "composed": 0}
    assert all(n - ssd_kernels[k] == L
               for k, n in ssd_scan.kernel_launches.items())
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
    route = "wgmma" if dtype == "bfloat16" else "tf32x3"
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


def _ragged_offsets(counts):
    off = [0]
    for c in counts:
        off.append(off[-1] + c)
    return torch.tensor(off, dtype=torch.int32, device="cuda")


# (counts a row of experts, k, n): empty experts, one expert with every
# row, counts under a 128-row tile and off its multiples, more experts than
# a warp's 32 lanes, and granite-4.0-h's expert shapes (4096 -> 768 and
# back, 72 experts) at a quarter of its prefill's routed rows.
GROUPED_CASES = [
    ([0, 300, 0, 17, 1, 128, 129, 0], 64, 96),
    ([0, 0, 513, 0], 128, 256),
    ([513], 256, 64),
    ([5] * 40 + [0] * 31 + [700], 64, 192),
    ([569] * 71 + [569 + 41], 4096, 768),
    ([569] * 71 + [569 + 41], 768, 4096),
]


@pytest.mark.parametrize("counts,k,n", GROUPED_CASES,
                         ids=[f"case{i}" for i in range(len(GROUPED_CASES))])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_gemm_grouped_matches_per_expert_matmul(card, counts, k, n, out):
    """The ragged grouped GEMM against one ``torch.matmul`` an expert, in
    one launch whose grid never read the counts; repeated, the same
    bits."""
    from repro_torch.kernels.gemm import gemm_grouped

    e, r = len(counts), sum(counts)
    a = torch.randn(r, k, generator=card, device="cuda").to(torch.bfloat16)
    b = (torch.randn(e, k, n, generator=card, device="cuda")
         * k ** -0.5).to(torch.bfloat16)
    offsets = _ragged_offsets(counts)
    od = getattr(torch, out)
    before = gemm_grouped.route_launches["wgmma"]
    got = gemm_grouped(a, b, offsets, out_dtype=od)
    again = gemm_grouped(a, b, offsets, out_dtype=od)
    torch.cuda.synchronize()
    assert gemm_grouped.route_launches["wgmma"] == before + 2
    assert got.dtype == od and got.shape == (r, n)
    assert torch.equal(got, again)
    want = torch.empty(r, n, device="cuda")
    lo = 0
    for i, c in enumerate(counts):
        want[lo:lo + c] = torch.matmul(a[lo:lo + c].float(), b[i].float())
        lo += c
    assert _err(got, want) <= TOL["bfloat16"]


def test_dropless_moe_on_kernels_repeats_and_matches_plain(card):
    """The dropless MoE layer on the card: three ragged grouped launches,
    bit for bit the same on a second run, the plain path's result (bf16
    bar), nothing dropped, and no read of the counts inside the layer."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.hero import offload_policy
    from repro_torch.kernels.gemm import gemm_grouped
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(),
                              moe_dropless=True)
    p = M.init_moe(card, cfg, torch.bfloat16, device="cuda")
    x = torch.randn(4, 64, cfg.d_model, generator=card, device="cuda").to(
        torch.bfloat16)
    before = gemm_grouped.launches
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        a, _ = M.moe_ffn(p, x, cfg)
        b, _ = M.moe_ffn(p, x, cfg)
    torch.cuda.synchronize()
    assert gemm_grouped.launches == before + 6
    assert torch.equal(a, b)
    step = M.last_moe_step()
    assert step.tokens_dropped == 0
    assert step.tokens_routed == 256 * cfg.experts_per_token
    with offload_policy(mode="device", use_kernels=False), torch.no_grad():
        want, _ = M.moe_ffn(p, x, cfg)
    assert _err(a, want) <= TOL["bfloat16"]


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_validate_launches_once_and_equals_unvalidated(card, dtype):
    """``dispatch("gemm", ..., validate=True)`` on CUDA tensors: the graph
    checks run on meta tensors, then the kernel launches once and the
    result equals the unvalidated call's bit for bit.  A dead handle or
    operands that disagree raise before any launch."""
    from repro_torch.analysis.graph import GraphVerificationError
    from repro_torch.core.dispatch import dispatch
    from repro_torch.core.hero import offload_policy

    dt = getattr(torch, dtype)
    a = torch.randn(128, 256, generator=card, device="cuda").to(dt)
    b = torch.randn(256, 64, generator=card, device="cuda").to(dt)
    with offload_policy(mode="device", use_kernels=True) as cluster:
        plain = dispatch("gemm", a, b)
        before = gemm.launches
        got = dispatch("gemm", a, b, validate=True)
        torch.cuda.synchronize()
        assert gemm.launches == before + 1
        assert torch.equal(got, plain)
        dead = cluster.pin_handle("dead", float(a.nbytes), device_id=0)
        cluster.unstage_handle(dead)
        before = gemm.launches
        with pytest.raises(GraphVerificationError, match="use-after-unstage"):
            dispatch("gemm", a, b, handle=dead, validate=True)
        with pytest.raises(GraphVerificationError, match="shape-mismatch"):
            dispatch("gemm", a, b[:-1], validate=True)
        torch.cuda.synchronize()
        assert gemm.launches == before


# ---------------------------------------------------------------------------
# Gradients through the kernels (repro_torch.kernels.autograd): the GEMM
# Function's backward is two more launches of the GEMM kernel, bf16 on the
# tensor-core route (never the CUDA-core ``tiled`` one: dB reads a
# row-major copy of Aᵀ), f32 on ``tf32x3``; attention's and the SSD term's
# backwards recompute their plain versions.
# ---------------------------------------------------------------------------

# (m, n, k): m, the tokens, is dB's contraction, which the tensor-core
# route's TMA reads in 8-element units: a multiple of 8 (as a train step's
# m is); n and k ragged.
GRAD_GEMM_SHAPES = [(64, 96, 128), (136, 72, 104), (512, 5120, 4096),
                    (512, 4096, 11008)]


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("m,n,k", GRAD_GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_function_backward_on_the_kernel(card, m, n, k, dtype):
    from repro_torch.kernels import autograd as kgrad

    dt = getattr(torch, dtype)
    a = torch.randn(m, k, generator=card, device="cuda").to(dt)
    b = (torch.randn(k, n, generator=card, device="cuda") * k ** -0.5).to(dt)
    dc = torch.randn(m, n, generator=card, device="cuda").to(dt)
    ak, bk = _leaf(a), _leaf(b)
    y = kgrad.lowering("gemm")(ak, bk)
    torch.cuda.synchronize()
    before = gemm.launches
    routes = dict(gemm.route_launches)
    y.backward(dc)
    torch.cuda.synchronize()
    assert gemm.launches == before + 2
    used = {r: gemm.route_launches[r] - routes[r] for r in routes}
    assert used["tiled"] == 0
    assert used["wgmma" if dtype == "bfloat16" else "tf32x3"] == 2
    ap, bp = _leaf(a), _leaf(b)
    gemm_ref(ap, bp).backward(dc)
    assert ak.grad.dtype == dt and bk.grad.dtype == dt
    assert _err(ak.grad, ap.grad) <= TOL[dtype]
    assert _err(bk.grad, bp.grad) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_batched_function_backward_on_the_kernel(card, dtype):
    from repro_torch.kernels import autograd as kgrad

    dt = getattr(torch, dtype)
    a = torch.randn(8, 64, 256, generator=card, device="cuda").to(dt)
    b = (torch.randn(8, 256, 96, generator=card, device="cuda")
         * 256 ** -0.5).to(dt)
    dc = torch.randn(8, 64, 96, generator=card, device="cuda").to(dt)
    ak, bk = _leaf(a), _leaf(b)
    y = kgrad.lowering("moe_gemm")(ak, bk)
    before = gemm_batched.launches
    y.backward(dc)
    torch.cuda.synchronize()
    assert gemm_batched.launches == before + 2
    ap, bp = _leaf(a), _leaf(b)
    gemm_batched_ref(ap, bp).backward(dc)
    assert _err(ak.grad, ap.grad) <= TOL[dtype]
    assert _err(bk.grad, bp.grad) <= TOL[dtype]


def test_gemm_function_backward_repeats_bit_for_bit(card):
    from repro_torch.kernels import autograd as kgrad

    a = torch.randn(512, 4096, generator=card, device="cuda").bfloat16()
    b = torch.randn(4096, 1024, generator=card, device="cuda").bfloat16()
    dc = torch.randn(512, 1024, generator=card, device="cuda").bfloat16()
    grads = []
    for _ in range(2):
        ak, bk = _leaf(a), _leaf(b)
        kgrad.lowering("gemm")(ak, bk).backward(dc)
        grads.append((ak.grad, bk.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_function_backward_on_the_card(card, dtype):
    from repro_torch.kernels import autograd as kgrad

    dt = getattr(torch, dtype)
    q = torch.randn(1, 8, 256, 128, generator=card, device="cuda").to(dt)
    k = torch.randn(1, 2, 256, 128, generator=card, device="cuda").to(dt)
    v = torch.randn(1, 2, 256, 128, generator=card, device="cuda").to(dt)
    do = torch.randn(1, 8, 256, 128, generator=card, device="cuda").to(dt)
    before = flash_attention.launches
    ins = [_leaf(t) for t in (q, k, v)]
    out = kgrad.lowering("attention")(*ins, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_ins = [_leaf(t) for t in (q, k, v)]
    ref = attention_ref(*ref_ins, causal=True)
    ref.backward(do)
    assert _row_err(out.detach(), ref.detach()) <= TOL[dtype]
    for got, want in zip(ins, ref_ins):
        assert torch.equal(got.grad, want.grad)     # the same recompute


def test_ssd_function_backward_on_the_card(card):
    from repro_torch.kernels import autograd as kgrad

    g = card
    x = torch.randn(4, 2, 64, 64, generator=g, device="cuda")
    dt_a = torch.cumsum(-0.1 * torch.rand(4, 2, 64, generator=g,
                                          device="cuda"), dim=-1)
    b = torch.randn(4, 2, 64, 128, generator=g, device="cuda")
    c = torch.randn(4, 2, 64, 128, generator=g, device="cuda")
    dy = torch.randn(4, 2, 64, 64, generator=g, device="cuda")
    before = ssd_chunk_diag.launches
    ins = [_leaf(t) for t in (x, dt_a, b, c)]
    y = kgrad.lowering("ssd_chunk_diag")(*ins)
    y.backward(dy)
    torch.cuda.synchronize()
    assert ssd_chunk_diag.launches == before + 1
    ref_ins = [_leaf(t) for t in (x, dt_a, b, c)]
    ssd_chunk_diag_ref(*ref_ins).backward(dy)
    for got, want in zip(ins, ref_ins):
        assert torch.equal(got.grad, want.grad)


def test_decode_attention_refuses_grad_on_the_card(card):
    from repro_torch.kernels import autograd as kgrad

    q = torch.randn(8, 4, 64, generator=card, device="cuda").requires_grad_()
    k = torch.randn(8, 2, 32, 64, generator=card, device="cuda")
    lo = torch.zeros(8, dtype=torch.int32, device="cuda")
    hi = torch.full((8,), 32, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no gradient"):
        kgrad.lowering("decode_attention")(q, k, k, lo, hi)


def test_train_step_on_the_kernels_matches_the_plain_path(card):
    """One train step of reduced yi-6b (f32, 2 microbatches) on the card:
    loss and gradients with the kernels against the plain path (f32 2e-5
    of max |plain|), every GEMM launch on tf32x3 or skinny."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), num_microbatches=2)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=card,
                           device="cuda")
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    routes = dict(gemm.route_launches)
    with offload_policy(mode="device", use_kernels=True):
        lk, gk = steps._loss_and_grads(model, params, batch)
    used = {r: gemm.route_launches[r] - routes[r] for r in routes}
    assert used["tf32x3"] > 0 and used["tiled"] == 0 and used["wgmma"] == 0
    with offload_policy(mode="device", use_kernels=False):
        lp, gp = steps._loss_and_grads(model, params, batch)
    assert abs(float(lk) - float(lp)) <= 2e-5 * abs(float(lp))
    for g, w in zip(tree.leaves(gk), tree.leaves(gp)):
        assert _err(g, w) <= TOL["float32"] or \
            float(w.abs().max()) == 0.0


def test_wgmma_launch_from_a_fresh_thread(card):
    """A thread whose first CUDA call is a tensor-core launch (autograd's
    device thread runs the backward's GEMMs) encodes its TMA maps: the
    library binds the thread's context first."""
    import threading

    a = torch.randn(512, 4096, generator=card, device="cuda").bfloat16()
    b = torch.randn(5120, 4096, generator=card, device="cuda").bfloat16().T
    want = gemm(a, b)
    got = {}

    def run():
        try:
            got["c"] = gemm(a, b)
        except RuntimeError as exc:     # reported by the assertion below
            got["error"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and "error" not in got, got
    torch.cuda.synchronize()
    assert torch.equal(got["c"], want)


# ---------------------------------------------------------------------------
# The distributed layer: plan bodies on an emulated mesh launch the kernels
# per shard, from the mesh's own threads.
# ---------------------------------------------------------------------------

def _mesh(*shape):
    from repro_torch.sharding.spmd import Mesh

    axes = ("data", "model") if len(shape) == 2 else ("model",)
    return Mesh(shape, axes, device="cuda")


def _kernel_policy():
    from repro_torch.core.hero import offload_policy

    return offload_policy(mode="device", use_kernels=True)


@pytest.mark.parametrize("mode", ["row", "col"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_matmul_plan_launches_the_gemm_per_shard(card, mode, dtype):
    from repro_torch.core import blas

    dt = getattr(torch, dtype)
    x = torch.randn(4, 128, 512, generator=card, device="cuda").to(dt)
    w = (torch.randn(512, 1024, generator=card, device="cuda")
         * 512 ** -0.5).to(dt)
    mesh = _mesh(2, 4)
    before = gemm.launches
    with _kernel_policy(), mesh:
        got = blas.matmul(x, w, tp_mode=mode)
    torch.cuda.synchronize()
    assert gemm.launches == before + mesh.size
    assert _err(got, gemm_ref(x.reshape(-1, 512), w).reshape(got.shape)) \
        <= TOL[dtype]
    mesh.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ep_expert_ffn_plan_launches_three_batched_gemms_per_shard(card,
                                                                   dtype):
    from repro_torch.core import blas

    dt = getattr(torch, dtype)
    e, g, c, d, f = 16, 2, 64, 256, 128
    x = torch.randn(e, g, c, d, generator=card, device="cuda").to(dt)
    ws = [(torch.randn(*s, generator=card, device="cuda")
           * s[1] ** -0.5).to(dt) for s in ((e, d, f), (e, d, f), (e, f, d))]
    mesh = _mesh(2, 4)
    before = gemm_batched.launches
    with _kernel_policy(), mesh:
        got = blas.moe_expert_ffn(x, *ws)
    torch.cuda.synchronize()
    assert gemm_batched.launches == before + 3 * mesh.size
    from repro_torch.core.hero import offload_policy
    with offload_policy(mode="device", use_kernels=False):
        want = blas.moe_expert_ffn(x, *ws)
    assert _err(got, want) <= TOL[dtype]
    mesh.close()


def test_head_sharded_ssd_plan_launches_the_ssd_kernel_per_shard(card):
    from repro_torch.core import blas

    b, s, h, p, n = 2, 512, 16, 64, 128
    xh = torch.randn(b, s, h, p, generator=card, device="cuda")
    dt = torch.rand(b, s, h, generator=card, device="cuda") * 0.1
    a = -torch.rand(h, generator=card, device="cuda")
    bh = torch.randn(b, s, h, n, generator=card, device="cuda")
    ch = torch.randn(b, s, h, n, generator=card, device="cuda")
    dsk = torch.randn(h, generator=card, device="cuda")
    mesh = _mesh(2, 4)
    before = ssd_scan.route_launches["chunked"]
    with _kernel_policy(), mesh:
        got = blas.ssd_scan(xh, dt, a, bh, ch, dsk, chunk=256)
    torch.cuda.synchronize()
    # Each shard's heads read their B and C in place: the chunked kernels.
    assert ssd_scan.route_launches["chunked"] == before + mesh.size
    from repro_torch.core.hero import offload_policy
    with offload_policy(mode="device", use_kernels=False):
        want = blas.ssd_scan(xh, dt, a, bh, ch, dsk, chunk=256)
    assert _row_err(got, want) <= 1e-4
    mesh.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_ag_matmul_on_the_card(card, dtype):
    from repro_torch.sharding.collective_matmul import ring_ag_matmul
    from repro_torch.sharding.spmd import P, shard_map

    dt = getattr(torch, dtype)
    x = torch.randn(2, 256, 512, generator=card, device="cuda").to(dt)
    w = (torch.randn(512, 768, generator=card, device="cuda")
         * 512 ** -0.5).to(dt)
    mesh = _mesh(4)
    fn = shard_map(lambda xs, wl: ring_ag_matmul(xs, wl, "model"), mesh=mesh,
                   in_specs=(P(None, "model", None), P(None, "model")),
                   out_specs=P(None, None, "model"))
    before = gemm.launches
    with _kernel_policy():
        got = fn(x, w)
    torch.cuda.synchronize()
    assert gemm.launches == before + 16
    assert _err(got, gemm(x.reshape(-1, 512), w).reshape(got.shape)) \
        <= TOL[dtype]
    mesh.close()


def test_gpipe_on_the_card_equals_its_stages_bit_for_bit(card):
    import torch.nn.functional as F

    from repro_torch import tree
    from repro_torch.core import blas
    from repro_torch.launch.pipeline import pipeline_apply

    params = {"w": (torch.randn(4, 256, 256, generator=card, device="cuda")
                    * 256 ** -0.5).bfloat16(),
              "b": torch.randn(4, 256, generator=card,
                               device="cuda").bfloat16()}
    x = torch.randn(8, 64, 256, generator=card, device="cuda").bfloat16()

    def stage(p, xmb):
        return F.gelu(blas.matmul(xmb, p["w"]) + p["b"], approximate="tanh")

    mesh = _mesh(4)
    with _kernel_policy(), torch.no_grad():
        got = pipeline_apply(params, x, stage, mesh, num_microbatches=8)
        seq = []
        for j in range(8):
            h = x[j:j + 1]
            for i in range(4):
                h = stage(tree.tree_map(lambda a: a[i], params), h)
            seq.append(h)
    assert torch.equal(got, torch.cat(seq))
    mesh.close()
