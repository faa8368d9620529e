"""The port's GEMM against the reference's Pallas GEMM (interpret mode).

On the CPU the kernel wrapper takes its plain version; the kernel itself
(``csrc/gemm.cu``) is tested on the card by ``test_torch_kernels_gpu.py``.
Tolerances are ``tests/test_kernels.py``'s: f32 2e-5, bf16 2e-2, applied
after dividing both sides by max |reference|.  The two packages sum the k
products in different orders (torch's CPU matmul blocks k unlike XLA's
dot), so an f32 element near 0 in a row of magnitude ~40 differs by more
than 2e-5 of itself while staying within 2e-5 of the output's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blas as jblas
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import offload_policy as jpolicy
from repro.kernels import ops as jops
from repro_torch.configs import get_arch
from repro_torch.core import blas as tblas
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import _build
from repro_torch.kernels.gemm import (_T3_SPLITS, _T3_TILES, _unit_stride_2d,
                                      gemm, gemm_route, skinny_plan,
                                      tf32x3_plan)

import gemm_pallas_ref

SHAPES = [(128, 128, 128), (256, 128, 384), (200, 130, 96), (8, 8, 8),
          (1, 256, 64)]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


def _close(got, want, dtype):
    """assert_allclose with the reference's tolerances, scaled by the
    output's magnitude."""
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got / scale, want / scale, **_tol(dtype))


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_matches_reference_kernel(m, n, k, dtype):
    rng = np.random.default_rng(7)
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (k, n), dtype)
    want = np.asarray(jops.gemm(ja, jb, interpret=True), np.float32)
    got = tops.kernel_lowering("gemm")(ta, tb)
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    _close(_np(got), want, dtype)


def test_gemm_fp32_accumulation_bf16_inputs():
    """bf16 inputs accumulate in fp32, with the reference test's bar."""
    k = 4096
    a = torch.full((8, k), 0.01, dtype=torch.bfloat16)
    b = torch.full((k, 8), 0.01, dtype=torch.bfloat16)
    got = gemm(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert abs(got[0, 0].item() - k * 1e-4) / (k * 1e-4) < 0.02


@pytest.mark.parametrize("transpose_a,transpose_b",
                         [(False, True), (True, False), (True, True)])
def test_blas_gemm_transposes_match_reference(transpose_a, transpose_b):
    rng = np.random.default_rng(3)
    sa = (48, 40) if transpose_a else (40, 48)
    sb = (24, 48) if transpose_b else (48, 24)
    ja, ta = _pair(rng, sa, "float32")
    jb, tb = _pair(rng, sb, "float32")
    kw = dict(transpose_a=transpose_a, transpose_b=transpose_b)
    with jpolicy(mode="device", use_pallas=True, interpret=True):
        want = np.asarray(jblas.gemm(ja, jb, **kw))
    with tpolicy(mode="device", use_kernels=True):
        got = tblas.gemm(ta, tb, **kw)
    _close(_np(got), want, "float32")


@pytest.mark.parametrize("m,n,k", [(8, 8, 8), (7, 64, 64)])
def test_kernel_backend_recorded_where_reference_records_pallas(m, n, k):
    """``min(m, n, k) >= 8`` gates the kernel in both packages: (8, 8, 8) is
    eligible, (7, 64, 64) is not and runs the plain device lowering."""
    rng = np.random.default_rng(11)
    ja, ta = _pair(rng, (m, k), "float32")
    jb, tb = _pair(rng, (k, n), "float32")
    with jpolicy(mode="device", use_pallas=True, interpret=True), \
            jtrace() as jt:
        want = np.asarray(jblas.gemm(ja, jb))
    with tpolicy(mode="device", use_kernels=True), ttrace() as tt:
        got = tblas.gemm(ta, tb)
    jb_ = [r.backend for r in jt.records]
    tb_ = [r.backend for r in tt.records]
    assert jb_ == (["device-pallas"] if m >= 8 else ["device"])
    assert tb_ == [{"device-pallas": "device-kernel"}.get(b, b) for b in jb_]
    _close(_np(got), want, "float32")


@pytest.mark.parametrize("parts", [2, 3])
def test_host_k_split_reorders_plain_sums_only(parts):
    """``host_k_split`` changes only the order of the plain lowering's fp32
    sums: the result stays within the f32 bar of the reference kernel and
    of the unsplit sum, the kernel route ignores it, and it resets."""
    rng = np.random.default_rng(5)
    ja, ta = _pair(rng, (8, 1000), "float32")
    jb, tb = _pair(rng, (1000, 24), "float32")
    want = np.asarray(jops.gemm(ja, jb, interpret=True), np.float32)
    with tpolicy(mode="device"):
        whole = tblas.gemm(ta, tb)
        with tblas.host_k_split(parts):
            split = tblas.gemm(ta, tb)
            via_kernel = tops.kernel_lowering("gemm")(ta, tb)
        again = tblas.gemm(ta, tb)
    _close(_np(split), want, "float32")
    _close(_np(split), _np(whole), "float32")
    assert torch.equal(again, whole)
    assert torch.equal(via_kernel, gemm(ta, tb))
    with pytest.raises(ValueError, match="parts >= 1"):
        with tblas.host_k_split(0):
            pass


def test_wrapper_raises_off_cpu_without_kernel():
    """The plain version is taken only for CPU tensors: any other device
    either launches the kernel or raises — never falls back."""
    a = torch.empty(8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        gemm(a, a)


# Operands as callers slice them out of wider storage: 2-D views with one
# unit stride are read in place by every route; a view with none is not.
_STRIDE_CASES = [
    ("contiguous", lambda x: x[:, :96], True),
    ("column-slice", lambda x: x[:, :64], True),
    ("row-slice", lambda x: x[:32], True),
    ("row-and-column-slice", lambda x: x[8:40, 16:80], True),
    ("transposed-column-slice", lambda x: x[:, :64].T, True),
    ("transposed", lambda x: x.T, True),
    ("single-row", lambda x: x[5:6, ::2], True),
    ("single-column", lambda x: x[:, 7:8], True),
    ("no-unit-stride", lambda x: x[:, ::2], False),
    ("no-unit-stride-transposed", lambda x: x[::2, ::2].T, False),
]


@pytest.mark.parametrize("view,ok", [c[1:] for c in _STRIDE_CASES],
                         ids=[c[0] for c in _STRIDE_CASES])
def test_unit_stride_check(view, ok):
    """The kernels' operand check: row-major with a row stride of at least
    the width or column-major with a column stride of at least the height;
    a size-1 dimension's stride is free."""
    assert _unit_stride_2d(view(torch.zeros(64, 96))) is ok


@pytest.mark.parametrize("op", ["gemm", "matmul"])
@pytest.mark.parametrize("sliced", ["a", "b", "both"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_blas_on_column_sliced_operands_matches_reference(op, sliced, dtype):
    """``blas.gemm`` / ``blas.matmul`` on a column slice ``x[:, :k]`` of a
    wider matrix (read in place on the card) agree with the reference's on
    the same numpy values, under the kernel policy."""
    rng = np.random.default_rng(13)
    m, k, n = 40, 48, 24
    ja, ta = _pair(rng, (m, k + 16 if sliced != "b" else k), dtype)
    jb, tb = _pair(rng, (k, n + 8 if sliced != "a" else n), dtype)
    ja, ta = ja[:, :k], ta[:, :k]
    jb, tb = jb[:, :n], tb[:, :n]
    assert _unit_stride_2d(ta) and _unit_stride_2d(tb)
    with jpolicy(mode="device", use_pallas=True, interpret=True), \
            jtrace() as jt:
        want = np.asarray(getattr(jblas, op)(ja, jb), np.float32)
    with tpolicy(mode="device", use_kernels=True), ttrace() as tt:
        got = getattr(tblas, op)(ta, tb)
    assert got.shape == (m, n) and got.dtype == getattr(torch, dtype)
    _close(_np(got), want, dtype)
    assert [r.backend for r in tt.records] == [
        {"device-pallas": "device-kernel"}.get(r.backend, r.backend)
        for r in jt.records]


def _route_cases():
    """(id, gemm_route arguments, route) for every GEMM of the main paths:
    operands as the models hand them over (contiguous row-major, or the
    tied head's ``embed.T``), addresses 16-byte aligned as torch allocates
    them."""
    bf16 = torch.bfloat16

    def rm(m, k, n, batch=1, dtype=bf16):
        a = (m * k if batch > 1 else 0, k, 1)
        b = (k * n if batch > 1 else 0, n, 1)
        return (m, n, k, batch, dtype, a, b, 0, 256)

    yi, mb = get_arch("yi-6b"), get_arch("mamba2-370m")
    d, hd = yi.d_model, yi.head_dim
    yi_gemms = [("qkv", d, (yi.num_heads + 2 * yi.num_kv_heads) * hd),
                ("wo", yi.num_heads * hd, d), ("gate_up", d, yi.d_ff),
                ("down", yi.d_ff, d), ("head", d, yi.vocab_size)]
    ds, di = mb.d_model, mb.d_inner
    mamba_gemms = [("zx", ds, di),
                   ("bc", ds, mb.ssm_num_groups * mb.ssm_state_dim),
                   ("dt", ds, mb.ssm_num_heads), ("out", di, ds)]
    cases = []
    for name, k, n in yi_gemms:
        cases.append((f"yi-forward-{name}", rm(2 * 512, k, n), "wgmma"))
        cases.append((f"yi-serve-{name}", rm(8, k, n), "skinny"))
        cases.append((f"yi-serve-f32-{name}", rm(8, k, n, dtype=torch.float32),
                      "skinny"))
    for name, k, n in mamba_gemms:
        cases.append((f"mamba-forward-{name}", rm(4 * 1024, k, n), "wgmma"))
        cases.append((f"mamba-serve-{name}", rm(8, k, n), "skinny"))
    for name, k, n in mamba_gemms[:2]:
        cases.append((f"mamba-graph-{name}-stack", rm(4 * 1024, k, n, 2),
                      "wgmma"))
    head = (4 * 1024, mb.vocab_size, ds, 1, bf16, (0, ds, 1), (0, 1, ds), 0, 0)
    cases.append(("mamba-forward-tied-head", head, "wgmma"))
    cases.append(("hnp-wave", rm(1024, d, yi.num_kv_heads * hd, 2), "wgmma"))
    f32 = torch.float32
    cases += [
        ("f32", rm(1024, 4096, 4096, dtype=f32), "tf32x3"),
        ("f32-yi-forward-down", rm(128, 11008, 4096, dtype=f32), "tf32x3"),
        ("f32-stack", rm(128, 768, 2048, 128, dtype=f32), "tf32x3"),
        ("f32-col-major-a", (1024, 512, 256, 1, f32, (0, 1, 1024),
                             (0, 512, 1), 0, 0), "tf32x3"),
        ("f32-k-major-b", (512, mb.vocab_size, ds, 1, f32, (0, ds, 1),
                           (0, 1, ds), 0, 0), "tf32x3"),
        ("f32-misaligned", (1024, 512, 256, 1, f32, (0, 259, 1),
                            (0, 515, 1), 4, 8), "tf32x3"),
        ("f32-k-not-multiple-of-4", rm(100, 200, 1001, dtype=f32), "tf32x3"),
        ("col-major-a", (1024, 512, 256, 1, bf16, (0, 1, 1024), (0, 512, 1),
                         0, 0), "tiled"),
        ("k-not-multiple-of-8", rm(1024, 100, 512), "tiled"),
        ("b-row-not-16-byte", rm(1024, 4096, 130), "tiled"),
        ("misaligned-a", (1024, 512, 256, 1, bf16, (0, 256, 1), (0, 512, 1),
                          2, 0), "tiled"),
        ("b-strided-both", (1024, 512, 256, 1, bf16, (0, 256, 1),
                            (0, 1024, 2), 0, 0), "tiled"),
    ]
    return cases


_ROUTE_CASES = _route_cases()


@pytest.mark.parametrize("args,route", [c[1:] for c in _ROUTE_CASES],
                         ids=[c[0] for c in _ROUTE_CASES])
def test_gemm_route(args, route):
    """Every bf16 GEMM with m > 16 of the yi-6b forward (2 x 512 rows),
    the mamba2-370m forward (4 x 1024, the tied head's K-major B included),
    their graph-mode stacks and the hnp wave takes the tensor-core kernel;
    every serving GEMM (m = batch = 8) the skinny one; every f32 GEMM with
    m > 16 (any layout, alignment and k) the 3xTF32 tensor-core kernel;
    bf16 with a column-major A, k % 8 != 0 or operands TMA cannot address
    the CUDA-core tile."""
    assert gemm_route(*args) == route


def _serving_plan_cases():
    """(id, m, k, n, B layout) of every decode-step GEMM of yi-6b and
    mamba2-370m (the tied head's ``embed.T`` K-major), at m = 8 and at the
    other row counts a serving batch may have."""
    yi, mb = get_arch("yi-6b"), get_arch("mamba2-370m")
    d, hd = yi.d_model, yi.head_dim
    ds, di = mb.d_model, mb.d_inner
    shapes = [("yi-qkv", d, (yi.num_heads + 2 * yi.num_kv_heads) * hd, "mn"),
              ("yi-wo", yi.num_heads * hd, d, "mn"),
              ("yi-gate-up", d, yi.d_ff, "mn"),
              ("yi-down", yi.d_ff, d, "mn"),
              ("yi-head", d, yi.vocab_size, "mn"),
              ("mamba-z-x", ds, di, "mn"),
              ("mamba-b-c", ds, mb.ssm_num_groups * mb.ssm_state_dim, "mn"),
              ("mamba-dt", ds, mb.ssm_num_heads, "mn"),
              ("mamba-out", di, ds, "mn"),
              ("mamba-head", ds, mb.vocab_size, "k")]
    return [(f"{name}-m{m}", m, k, n, lay) for name, k, n, lay in shapes
            for m in (1, 8, 16)]


_PLAN_CASES = _serving_plan_cases()


def _b_strides(k, n, layout, batch):
    """B's (batch, k, column) strides: a row-major [k, n] or the transpose
    of a row-major [n, k]; a stack of ``batch`` of them, or one."""
    return ((k * n if batch > 1 else 0,)
            + ((n, 1) if layout == "mn" else (1, k)))


@pytest.mark.parametrize("m,k,n,layout", [c[1:] for c in _PLAN_CASES],
                         ids=[c[0] for c in _PLAN_CASES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_skinny_plan_serving_shapes(m, k, n, layout, dtype):
    """The skinny launch plan at every serving shape: the same for a
    single GEMM and a stack of two (graph mode stacks decode projections,
    and stacked launches must equal single ones bit for bit); the layout
    B's strides give; 16-byte loads (8 bf16 / 4 f32) on 16-byte-aligned
    operands, and bf16 then on the tensor cores; every m <= 16 in one
    block, so the plan is the one m = 1 gets and B is read once; the
    splits (one cluster of at most 8 blocks) cover k exactly."""
    dt = getattr(torch, dtype)
    plans = [skinny_plan(m, n, k, dt, (m * k if z > 1 else 0, k, 1),
                         _b_strides(k, n, layout, z), 0, 4096)
             for z in (1, 2)]
    plan = plans[0]
    assert plans[1] == plan
    assert plan == skinny_plan(1, n, k, dt, (0, k, 1),
                               _b_strides(k, n, layout, 1), 0, 4096)
    assert plan.layout == layout
    assert plan.vec == (8 if dtype == "bfloat16" else 4)
    assert plan.kc % 8 == 0 and 1 <= plan.splits <= 8
    assert (plan.splits - 1) * plan.kc < k <= plan.splits * plan.kc
    cuda_core_mn = dtype == "float32" and layout == "mn"
    assert (plan.tn > 0) == cuda_core_mn   # threads per k row: that kernel's
    assert plan.tn & (plan.tn - 1) == 0 and plan.tn <= 32
    assert plan.a_vec == plan.vec          # A: contiguous rows, aligned


@pytest.mark.parametrize("dtype", DTYPES)
def test_skinny_plan_vector_width_follows_alignment(dtype):
    """16-byte loads only where B's address, its non-unit stride and the
    vector dimension allow them: a column slice with an odd row stride, a
    base one element past a 16-byte boundary, or an n (MN-major) / k
    (K-major) off the vector take scalar loads.  A's staging follows A's
    own layout and alignment, independently of B's."""
    dt = getattr(torch, dtype)
    full = 8 if dtype == "bfloat16" else 4
    item = 2 if dtype == "bfloat16" else 4
    m, k, n = 8, 1024, 512
    a = (0, k, 1)

    def vec(b_strides, b_ptr=4096, kk=k, nn=n, a_strides=a, a_ptr=0):
        return skinny_plan(m, nn, kk, dt, a_strides, b_strides, a_ptr,
                           b_ptr).vec

    assert vec((0, n, 1)) == full
    assert vec((0, 1, k)) == full
    assert vec((0, n + 3, 1)) == 1            # x[:, :n] of a [k, n + 3]
    assert vec((0, 1, k + 3)) == 1            # K-major, odd column stride
    assert vec((0, n, 1), b_ptr=4096 + item) == 1
    assert vec((0, 1, k), b_ptr=4096 + item) == 1
    assert vec((0, 130, 1), nn=130) == 1      # n off the vector
    assert vec((0, 1, 1020), kk=1020) == (4 if dtype == "float32" else 1)
    assert vec((k * n + 1, n, 1)) == 1        # stack with an odd batch stride
    assert vec((0, n, 1), a_strides=(0, k + 3, 1), a_ptr=item) == full

    def a_vec(a_strides, a_ptr=4096, kk=k):
        return skinny_plan(m, n, kk, dt, a_strides, (0, n, 1), a_ptr,
                           4096).a_vec

    assert a_vec(a) == full
    assert a_vec((0, k + 3, 1)) == 1          # x[:, :k] of an [m, k + 3]
    assert a_vec(a, a_ptr=4096 + item) == 1
    assert a_vec((0, 1, m)) == 1              # column-major A
    assert a_vec((0, 1020, 1), kk=1020) == (4 if dtype == "float32" else 1)
    assert skinny_plan(8, n, k, dt, a, (0, n, 1), 0, 0).layout == "mn"
    assert skinny_plan(8, n, k, dt, a, (0, 1, k), 0, 0).layout == "k"


@pytest.mark.parametrize("m", [1, 8, 9, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_skinny_plan_rows_in_one_block(m, dtype):
    """Every m <= 16 is one row group: the plan has no split over rows and
    is the same for every m (the kernels hold all rows in one block: 16
    accumulator rows on the tensor cores, 8 or 16 on the CUDA cores), and
    it is a function of the operands alone, so it is the same at every
    call; m outside [1, 16] is not the skinny route's."""
    dt = getattr(torch, dtype)
    for k, n in ((4096, 5120), (1024, 32), (11008, 4096), (0, 64)):
        plan = skinny_plan(m, n, k, dt, (0, k, 1), (0, n, 1), 0, 0)
        assert plan == skinny_plan(16, n, k, dt, (0, k, 1), (0, n, 1), 0, 0)
        assert plan == skinny_plan(m, n, k, dt, (0, k, 1), (0, n, 1), 0, 0)
    for bad in (0, 17):
        with pytest.raises(ValueError, match="not in"):
            skinny_plan(bad, 64, 64, torch.float32, (0, 64, 1), (0, 64, 1),
                        0, 0)


@pytest.fixture(scope="module")
def pallas_kept():
    return gemm_pallas_ref.load(), gemm_pallas_ref.pallas_outputs()


@pytest.mark.parametrize("cid,m,layout,dtype,out", gemm_pallas_ref.CASES,
                         ids=[c[0] for c in gemm_pallas_ref.CASES])
def test_skinny_pallas_outputs_are_kept(pallas_kept, cid, m, layout, dtype,
                                        out):
    """``tests/data/gemm_skinny_pallas.npz`` holds what the reference's
    Pallas GEMM computes on the decode cases the card tests hold the
    skinny kernels against (to within one rounding of the output, in case
    the reference's k order moves), and the port's plain version agrees
    with it at the usual bars."""
    kept, fresh = pallas_kept
    want = fresh[cid]
    assert kept[cid].shape == want.shape == (m, gemm_pallas_ref.N)
    scale = float(np.abs(want).max())
    bar = 1e-6 if out == "float32" else 2.0 ** -8
    assert np.abs(kept[cid] - want).max() / scale <= bar
    a, b = gemm_pallas_ref.inputs(cid)
    dt = getattr(torch, dtype)
    tb = torch.from_numpy(b).to(dt) if layout == "mn" else \
        torch.from_numpy(np.ascontiguousarray(b.T)).to(dt).T
    got = gemm(torch.from_numpy(a).to(dt), tb, out_dtype=getattr(torch, out))
    _close(_np(got), want, out)


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """An edited csrc header moves every kernel's library path, so a
    source that includes it is never served a stale build."""
    (tmp_path / "k.cu").write_text('#include "t.cuh"\n')
    (tmp_path / "t.cuh").write_text("// tile v1\n")
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "t.cuh").write_text("// tile v2\n")
    second = _build._lib_path("k")
    assert second != first and second.name == first.name == "libk.so"
    (tmp_path / "k.cu").write_text('#include "t.cuh"\n// edited\n')
    assert _build._lib_path("k") not in (first, second)


# f32 GEMM shapes with m > 16 the main paths hand the tf32x3 route: Fig.
# 3's square n, the yi-6b f32 forward (m 128) and mamba2-370m's (m 512),
# qwen3-moe's f32 expert shapes (one expert of a stack) and ragged ones.
def _t3_shapes():
    yi, mb = get_arch("yi-6b"), get_arch("mamba2-370m")
    d, hd = yi.d_model, yi.head_dim
    ds, di = mb.d_model, mb.d_inner
    shapes = [(n, n, n) for n in (32, 64, 128, 256, 512, 1024, 2048, 4096)]
    shapes += [(128, (yi.num_heads + 2 * yi.num_kv_heads) * hd, d),
               (128, d, yi.num_heads * hd), (128, yi.d_ff, d),
               (128, d, yi.d_ff), (128, yi.vocab_size, d)]
    shapes += [(512, di, ds), (512, mb.ssm_num_heads, ds), (512, ds, di),
               (512, mb.vocab_size, ds)]
    shapes += [(128, 768, 2048), (128, 2048, 768), (17, 72, 104),
               (100, 200, 1000), (1000, 5128, 1048), (300, 7, 0),
               (33, 1, 5)]
    return shapes


T3_SHAPES = _t3_shapes()
# tf32x3_capacity(0) on an H100 80GB HBM3 (700 W): blocks of each tile the
# card holds at once in clusters of 1..8 (cudaOccupancyMaxActiveClusters).
H100_T3_CAPACITY = {(128, 64): (264, 264, 237, 248, 235, 234, 224, 240),
                    (64, 64): (528, 528, 489, 496, 470, 474, 483, 496),
                    (32, 32): (924, 924, 861, 864, 855, 846, 868, 856)}


def _plan(m, n, k, dtype, a_strides, b_strides, a_ptr, b_ptr):
    return tf32x3_plan(m, n, k, dtype, a_strides, b_strides, a_ptr, b_ptr,
                       H100_T3_CAPACITY)


@pytest.mark.parametrize("m,n,k", T3_SHAPES,
                         ids=["x".join(map(str, s)) for s in T3_SHAPES])
def test_tf32x3_plan_is_blind_to_the_batch_and_layout(m, n, k):
    """The tile and the splits come from m, n and k alone: a stack (any
    batch stride, 0 included), a column-major A, a K-major B or a
    misaligned operand gets the same tile and splits, so a stacked launch
    runs each matrix exactly as its single launch (bit for bit)."""
    f32 = torch.float32
    base = _plan(m, n, k, f32, (0, k, 1), (0, n, 1), 0, 256)
    variants = [((m * k, k, 1), (k * n, n, 1), 0, 256),
                ((0, k, 1), (k * n, n, 1), 0, 0),
                ((m * k + 1, 1, m), (0, n, 1), 4, 0),
                ((0, k + 3, 1), (0, 1, k + 1), 4, 12)]
    for a_s, b_s, ap, bp in variants:
        plan = _plan(m, n, k, f32, a_s, b_s, ap, bp)
        assert (plan.bm, plan.bn, plan.splits, plan.kc) == \
            (base.bm, base.bn, base.splits, base.kc)


@pytest.mark.parametrize("m,n,k", T3_SHAPES,
                         ids=["x".join(map(str, s)) for s in T3_SHAPES])
def test_tf32x3_plan_covers_the_output_once(m, n, k):
    """The block tiles cover every output element exactly once and the
    splits every k row exactly once: at most 8 splits (a portable
    cluster), kc a multiple of 8, no split empty."""
    plan = _plan(m, n, k, torch.float32, (0, k, 1), (0, n, 1), 0, 0)
    assert (plan.bm, plan.bn) in _T3_TILES
    tm, tn = -(-m // plan.bm), -(-n // plan.bn)
    cover = np.zeros((m, n), np.int32)
    for i in range(tm):
        for j in range(tn):
            cover[i * plan.bm:(i + 1) * plan.bm,
                  j * plan.bn:(j + 1) * plan.bn] += 1
    assert (cover == 1).all()
    assert plan.splits in _T3_SPLITS and plan.splits <= 8
    assert plan.kc % 8 == 0 and plan.kc > 0
    rows = np.zeros(max(k, 1), np.int32)
    for s in range(plan.splits):
        lo, hi = s * plan.kc, min(max(k, 1), (s + 1) * plan.kc)
        assert hi > lo                         # no split without rows
        rows[lo:hi] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("n", [32, 64, 128])
def test_tf32x3_plan_fills_the_card_at_fig3_sizes(n):
    """At Fig. 3's n 128 the tiles and splits give (nearly) every one of
    the H100's 132 SMs a block; at n 32 and 64 k is too short for that
    (every split keeps at least 16 rows), and the smallest tile is taken."""
    plan = _plan(n, n, n, torch.float32, (0, n, 1), (0, n, 1), 0, 0)
    blocks = -(-n // plan.bm) * -(-n // plan.bn) * plan.splits
    if n == 128:
        assert blocks >= 0.9 * 132
    assert (plan.bm, plan.bn) == (32, 32)
    assert plan.kc >= 16 or plan.splits == 1


def test_tf32x3_plan_reads_the_capacity_it_is_given():
    """The tile and splits follow the card's capacity, not a table of one
    card: at Fig. 3's n 128 the H100's table gives a split k, and a card
    that held only one cluster of each size at a time would get none."""
    f32, n = torch.float32, 128
    full = _plan(n, n, n, f32, (0, n, 1), (0, n, 1), 0, 0)
    assert full.splits > 1
    starved = {tile: (row[0],) + tuple(range(2, 9))
               for tile, row in H100_T3_CAPACITY.items()}
    plan = tf32x3_plan(n, n, n, f32, (0, n, 1), (0, n, 1), 0, 0, starved)
    assert plan.splits == 1


def test_tf32x3_plan_copies_follow_layout_and_alignment():
    """Layouts follow the unit strides (A staged k-contiguous unless only
    its row stride is 1; B k-contiguous only when only its k stride is 1);
    16-byte copies only where that operand's rows and batch stride are
    whole 16-byte units and its address is 16-byte aligned.  Other dtypes
    are not the route's."""
    f32 = torch.float32
    m, n, k = 256, 512, 1024

    def plan(a_s, b_s, ap=0, bp=0, kk=k, nn=n):
        return _plan(m, nn, kk, f32, a_s, b_s, ap, bp)

    p = plan((0, k, 1), (0, n, 1))
    assert (p.a_kmajor, p.b_kmajor, p.a_vec, p.b_vec) == (True, False,
                                                           True, True)
    p = plan((0, 1, m), (0, 1, k))           # column-major A, K-major B
    assert (p.a_kmajor, p.b_kmajor, p.a_vec, p.b_vec) == (False, True,
                                                           True, True)
    p = plan((0, k, 1), (0, n, 1), ap=4, bp=8)
    assert (p.a_vec, p.b_vec) == (False, False)
    p = plan((0, k + 3, 1), (0, n + 2, 1))   # column slices, odd strides
    assert (p.a_vec, p.b_vec) == (False, False)
    p = plan((0, 1001, 1), (0, n, 1), kk=1001)
    assert (p.a_vec, p.b_vec) == (False, True)
    p = plan((m * k + 4, k, 1), (k * n + 2, n, 1))
    assert (p.a_vec, p.b_vec) == (True, False)
    p = plan((0, 5, 7), (0, 1, 1), kk=1, nn=1)   # k = 1, n = 1: no unit stride
    assert (p.a_kmajor, p.b_kmajor, p.a_vec, p.b_vec) == (True, False,
                                                           False, False)
    with pytest.raises(ValueError, match="f32 operands only"):
        _plan(m, n, k, torch.bfloat16, (0, k, 1), (0, n, 1), 0, 0)


def _tf32(x):
    """x cut to TF32: its low 13 mantissa bits cleared (what the tensor
    core reads of an fp32 register)."""
    return (np.asarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def _emulate(a, b, terms):
    """The tensor cores' products, exactly (float64): 1xTF32 multiplies
    the TF32 cuts of a and b; 3xTF32 splits each into hi = its TF32 cut and
    lo = x - hi (exact in fp32, read as its own TF32 cut) and sums
    lo·hi + hi·lo + hi·hi."""
    ah, bh = _tf32(a), _tf32(b)
    hh = ah.astype(np.float64) @ bh.astype(np.float64)
    if terms == 1:
        return hh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al.astype(np.float64) @ bh.astype(np.float64)
            + ah.astype(np.float64) @ bl.astype(np.float64) + hh)


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (128, 256, 11008)],
                         ids=["fig3-n128", "yi-down-k11008"])
def test_tf32x3_products_hold_the_f32_bar(m, n, k):
    """The tf32x3 route's arithmetic, emulated in numpy: its three TF32
    products come within the f32 bar (2e-5 of max |ref|) of the
    reference's f32 Pallas GEMM (interpret mode) at Fig. 3's n 128 and at
    yi-6b's down projection (k 11008, n cut to 256), while a single TF32
    product misses it, so the check is not vacuous.  (The tensor core's
    accumulator truncation is held to the bar on the card.)"""
    rng = np.random.default_rng(17)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    want = np.asarray(jops.gemm(jnp.asarray(a), jnp.asarray(b),
                                interpret=True), np.float64)
    scale = np.abs(want).max()
    err3 = np.abs(_emulate(a, b, 3) - want).max() / scale
    err1 = np.abs(_emulate(a, b, 1) - want).max() / scale
    assert err3 <= 2e-5 < err1
    assert err3 < err1 / 20
