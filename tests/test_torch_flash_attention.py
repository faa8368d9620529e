"""The port's flash-attention and batched-GEMM routes on the CPU, against the
reference.

``attention_ref`` (the plain version of ``csrc/flash_attention.cu``) and
the ``attention`` descriptor's CPU path are held against the reference's
Pallas kernel in interpret mode and its ``ref.attention_ref`` on the six
``test_flash_attention_variants`` cases x f32/bf16; ``gemm_batched_ref``
and the ``gemm_batched`` descriptor against ``pallas_gemm_batched`` in
interpret mode.  Tolerances are ``tests/test_kernels.py``'s: f32 2e-5,
bf16 2e-2.  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blas as jblas
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import offload_policy as jpolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import blas as tblas
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_route)
from repro_torch.kernels.gemm import gemm_batched
from repro_torch.kernels.ref import attention_ref, gemm_batched_ref

RNG = np.random.default_rng(7)
RENAME = {"device-pallas": "device-kernel"}

VARIANTS = [
    dict(sq=128, skv=128, hq=4, hkv=4, causal=True),
    dict(sq=128, skv=128, hq=8, hkv=2, causal=True),          # GQA
    dict(sq=96, skv=96, hq=4, hkv=2, causal=True, window=32), # SWA
    dict(sq=64, skv=64, hq=4, hkv=4, causal=False),           # encoder
    dict(sq=16, skv=128, hq=4, hkv=2, causal=True),           # suffix decode
    dict(sq=100, skv=100, hq=4, hkv=2, causal=True),          # ragged
]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _np(shape, dtype):
    return np.asarray(jnp.asarray(RNG.normal(size=shape), dtype))


def _both(a):
    return jnp.asarray(a), tensor_from_numpy(a)


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=_tol(dtype), atol=_tol(dtype))


def _qkv(case, dtype, d=32):
    return [_np((2, h, s, d), dtype) for h, s in (
        (case["hq"], case["sq"]), (case["hkv"], case["skv"]),
        (case["hkv"], case["skv"]))]


@pytest.mark.parametrize("case", VARIANTS,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_reference_kernel(case, dtype):
    q, k, v = _qkv(case, dtype)
    kw = dict(causal=case["causal"], window=case.get("window"))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    want_kernel = jops.flash_attention(jq, jk, jv, block_q=32, block_kv=32,
                                       interpret=True, **kw)
    want_ref = jref.attention_ref(jq, jk, jv, **kw)
    got = attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want_kernel, dtype)
    _close(got, want_ref, dtype)
    # the wrapper takes its plain version for CPU tensors, and counts no
    # launch
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(tq, tk, tv, **kw), got,
                               rtol=0, atol=0)
    assert flash_attention.launches == before


@pytest.mark.parametrize("case", VARIANTS,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_descriptor_cpu_path_matches_reference(case, dtype):
    """blas.attention through the seam, kernel policy (the wrapper's plain
    version on CPU tensors) and plain device policy, against the
    reference's descriptor under its kernel policy; the records agree once
    the backend is renamed."""
    q, k, v = _qkv(case, dtype)
    kw = dict(causal=case["causal"], window=case.get("window"))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    with jpolicy(mode="device", use_pallas=True, interpret=True,
                 platform="tpu-v5e"), jtrace() as jt:
        want = jblas.attention(jq, jk, jv, **kw)
    for use_kernels in (True, False):
        with tpolicy(mode="device", use_kernels=use_kernels,
                     platform="tpu-v5e"), ttrace() as tt:
            got = tblas.attention(tq, tk, tv, **kw)
        _close(got, want, dtype)
        (jr,), (tr,) = jt.records, tt.records
        assert tr.backend == ("device-kernel" if use_kernels else "device")
        assert (tr.op, tr.shape_key, tr.dtype, tr.cost.flops,
                tr.cost.staged_bytes) == (jr.op, jr.shape_key, jr.dtype,
                                          jr.cost.flops, jr.cost.staged_bytes)
        assert tr.regions.offload_s == jr.regions.offload_s


def test_attention_window_routing_matches_reference():
    """A Python-int window is kernel-eligible (a window covering every key
    reaches the kernel as None); a tensor window — the reference's traced
    per-layer scalar — and a kv_mask take the masked host math."""
    q, k, v = (_np((1, 2, 8, 16), "float32") for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    jmask, tmask = _both(np.arange(8) < 5)
    cases = [
        (dict(window=4), dict(window=4)),
        (dict(window=1 << 30), dict(window=1 << 30)),
        (dict(window=jnp.int32(4)), dict(window=torch.tensor(4))),
        (dict(kv_mask=jmask), dict(kv_mask=tmask)),
    ]
    for jkw, tkw in cases:
        with jpolicy(mode="device", use_pallas=True, interpret=True,
                     platform="tpu-v5e"), jtrace() as jt:
            want = jblas.attention(jq, jk, jv, **jkw)
        with tpolicy(mode="device", use_kernels=True,
                     platform="tpu-v5e"), ttrace() as tt:
            got = tblas.attention(tq, tk, tv, **tkw)
        _close(got, want, "float32")
        assert RENAME.get(jt.records[0].backend, jt.records[0].backend) == \
            tt.records[0].backend
        assert tt.records[0].cost.flops == jt.records[0].cost.flops


@pytest.mark.parametrize("window", [None, 700])
def test_chunked_host_attention_matches_reference(window):
    """Past 8192 keys the host math runs an online-softmax loop over kv
    chunks, as the reference's lax.scan form does."""
    q = _np((1, 2, 3, 8), "float32")
    k, v = _np((1, 1, 9216, 8), "float32"), _np((1, 1, 9216, 8), "float32")
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    want = jblas.attention_math(jq, jk, jv, causal=True, window=window)
    got = tblas.attention_math(tq, tk, tv, causal=True, window=window)
    _close(got, want, "float32")
    _close(got, jref.attention_ref(jq, jk, jv, causal=True, window=window),
           "float32")


def test_flash_attention_wrapper_rejects_what_it_cannot_run():
    q = torch.zeros(1, 4, 8, 16, device="meta")
    k = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="shorter"):
        flash_attention(torch.zeros(1, 4, 9, 16), torch.zeros(1, 2, 8, 16),
                        torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention(torch.zeros(1, 3, 8, 16), torch.zeros(1, 2, 8, 16),
                        torch.zeros(1, 2, 8, 16))


def _route_strides(d, dtype, layout="bhsd", b=2, s=512, hq=32, hkv=4):
    """(strides, ptrs) of q, k, v and the output as ``flash_attention``
    hands them to :func:`flash_attention_route`: (B, H, S, D) tensors, the
    model's (B, S, H, D) storage as transposed views (``"bshd"``), or k / v
    as views into one packed (B, S, (Hq + 2 Hkv) D + pad) projection with a
    row of ``pad`` extra elements (``"packed<pad>"``).  Meta tensors: only
    strides matter; addresses are 16-byte aligned unless a test moves one.
    """
    def make(h):
        if layout == "bshd":
            return torch.empty(b, s, h, d, dtype=dtype,
                               device="meta").transpose(1, 2)
        return torch.empty(b, h, s, d, dtype=dtype, device="meta")

    q, k, v = make(hq), make(hkv), make(hkv)
    if layout.startswith("packed"):
        width = (hq + 2 * hkv) * d + int(layout[len("packed"):])
        qkv = torch.empty(b, s, width, dtype=dtype, device="meta")
        k = qkv[..., hq * d:(hq + hkv) * d].unflatten(-1, (hkv, d))
        k = k.transpose(1, 2)
    out = torch.empty(b, hq, s, d, dtype=dtype, device="meta")
    return [t.stride() for t in (q, k, v, out)], [0, 256 * 4096, 512, 1024]


# yi-6b's prefill geometry (Hq 32, Hkv 4, S 512) at the bf16 tensor-core
# route's head dims, contiguous and as the model's transposed views, also
# D 80 (h2o-danube's 32 / 8 heads, hubert's 16 / 16); f32 at head dims
# that are multiples of 8 up to 128 on the f32 tensor-core route; then
# what stays on the CUDA cores: D 32 in bf16 (the reference tests), f32
# at D 36 and 136, a sequence stride that is not a multiple of 16 bytes,
# an odd base address, a strided head dim and a broadcast (stride 0)
# batch, in bf16 and f32.
_D80 = dict(d=80, dtype=torch.bfloat16)
_F32 = dict(d=128, dtype=torch.float32)
_ROUTE_CASES = [
    ("bf16-d128", dict(d=128, dtype=torch.bfloat16), None, "wgmma"),
    ("bf16-d64", dict(d=64, dtype=torch.bfloat16), None, "wgmma"),
    ("bf16-d128-bshd-view", dict(d=128, dtype=torch.bfloat16,
                                 layout="bshd"), None, "wgmma"),
    ("bf16-d64-bshd-view", dict(d=64, dtype=torch.bfloat16,
                                layout="bshd"), None, "wgmma"),
    ("bf16-d128-packed-aligned", dict(d=128, dtype=torch.bfloat16,
                                      layout="packed8"), None, "wgmma"),
    ("f32-d128", _F32, None, "tf32x3"),
    ("f32-d64-bshd-view", dict(d=64, dtype=torch.float32, layout="bshd"),
     None, "tf32x3"),
    ("bf16-d80", _D80, None, "wgmma"),
    ("bf16-d32", dict(d=32, dtype=torch.bfloat16), None, "simt"),
    ("bf16-d128-misaligned-stride", dict(d=128, dtype=torch.bfloat16,
                                         layout="packed4"), None, "simt"),
    ("bf16-d128-odd-address", dict(d=128, dtype=torch.bfloat16),
     ("ptr", 1, 2), "simt"),
    ("bf16-d128-strided-head-dim", dict(d=128, dtype=torch.bfloat16),
     ("stride", 2, (4096 * 128, 512 * 128, 256, 2)), "simt"),
    ("bf16-d128-broadcast-batch", dict(d=128, dtype=torch.bfloat16),
     ("stride", 0, (0, 512 * 128, 128, 1)), "simt"),
    ("bf16-d80-danube-bshd-view", dict(_D80, layout="bshd", b=1, s=8192,
                                       hkv=8), None, "wgmma"),
    ("bf16-d80-hubert-bshd-view", dict(_D80, layout="bshd", hq=16, hkv=16),
     None, "wgmma"),
    ("bf16-d80-packed-aligned", dict(_D80, layout="packed8"), None, "wgmma"),
    ("bf16-d80-odd-address", _D80, ("ptr", 1, 2), "simt"),
    ("bf16-d80-misaligned-stride", dict(_D80, layout="packed4"), None,
     "simt"),
    ("bf16-d80-broadcast-batch", _D80, ("stride", 0, (0, 512 * 80, 80, 1)),
     "simt"),
    ("f32-d128-bshd-view", dict(_F32, layout="bshd"), None, "tf32x3"),
    ("f32-d128-packed-aligned", dict(_F32, layout="packed4"), None,
     "tf32x3"),
    ("f32-d80", dict(_F32, d=80), None, "tf32x3"),
    ("f32-d16", dict(_F32, d=16), None, "tf32x3"),
    ("f32-d36", dict(_F32, d=36), None, "simt"),
    ("f32-d136", dict(_F32, d=136), None, "simt"),
    ("f32-d128-misaligned-stride", dict(_F32, layout="packed2"), None,
     "simt"),
    ("f32-d128-odd-address", _F32, ("ptr", 2, 4), "simt"),
    ("f32-d80-odd-address", dict(_F32, d=80), ("ptr", 1, 4), "simt"),
    ("f32-d128-strided-head-dim", _F32,
     ("stride", 2, (4096 * 128, 512 * 128, 256, 2)), "simt"),
    ("f32-d128-broadcast-batch", _F32, ("stride", 0, (0, 512 * 128, 128, 1)),
     "simt"),
    ("f32-d80-broadcast-batch", dict(_F32, d=80),
     ("stride", 0, (0, 512 * 80, 80, 1)), "simt"),
    ("f32-d128-yi6b-bshd-view", dict(_F32, layout="bshd", b=1, s=128),
     None, "tf32x3"),
    ("f32-d128-jamba-bshd-view", dict(_F32, layout="bshd", b=1, hq=64,
                                      hkv=8), None, "tf32x3"),
    ("f32-d8", dict(_F32, d=8), None, "tf32x3"),
    ("f32-d120", dict(_F32, d=120), None, "tf32x3"),
    ("f32-d132", dict(_F32, d=132), None, "simt"),
    ("f32-d128-packed-odd", dict(_F32, layout="packed1"), None, "simt"),
    ("f32-d128-zero-seq-stride", _F32, ("stride", 1, (512 * 128, 128, 0, 1)),
     "simt"),
]


@pytest.mark.parametrize("kw,edit,route", [c[1:] for c in _ROUTE_CASES],
                         ids=[c[0] for c in _ROUTE_CASES])
def test_flash_attention_route(kw, edit, route):
    """bf16 at D 64 / 80 / 128 and f32 at D a multiple of 8 up to 128, with
    a contiguous head dim and 16-byte-aligned addresses and strides (the
    models' attention, as (B, H, S, D) tensors or the model's transposed
    views), take the two tensor-core kernels (``wgmma``, ``tf32x3``);
    everything else the CUDA-core one."""
    strides, ptrs = _route_strides(**kw)
    if edit is not None:
        what, i, value = edit
        (ptrs if what == "ptr" else strides)[i] = value
    assert flash_attention_route(kw["dtype"], kw["d"], strides, ptrs) == route


@pytest.mark.parametrize("bsz", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_batched_ref_matches_reference_kernel(bsz, dtype):
    a, b = _np((bsz, 96, 64), dtype), _np((bsz, 64, 80), dtype)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    want = jops.gemm_batched(ja, jb, interpret=True)
    got = gemm_batched_ref(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (bsz, 96, 80)
    _close(got, want, dtype)
    _close(got, jref.gemm_batched_ref(ja, jb), dtype)
    before = gemm_batched.launches
    torch.testing.assert_close(gemm_batched(ta, tb), got, rtol=0, atol=0)
    assert gemm_batched.launches == before


@pytest.mark.parametrize("use_kernels", [True, False])
def test_gemm_batched_descriptor_matches_reference(use_kernels):
    a, b = _np((3, 24, 40), "float32"), _np((3, 40, 16), "float32")
    (ja, ta), (jb, tb) = _both(a), _both(b)
    with jpolicy(mode="device", use_pallas=use_kernels, interpret=True,
                 platform="tpu-v5e"), jtrace() as jt:
        want = jblas.gemm_batched(ja, jb)
    with tpolicy(mode="device", use_kernels=use_kernels,
                 platform="tpu-v5e"), ttrace() as tt, tblas.host_k_split(3):
        got = tblas.gemm_batched(ta, tb)
    _close(got, want, "float32")
    (jr,), (tr,) = jt.records, tt.records
    assert (tr.op, RENAME.get(jr.backend, jr.backend), tr.shape_key,
            tr.cost.flops, tr.regions.offload_s) == (
        jr.op, tr.backend, jr.shape_key, jr.cost.flops, jr.regions.offload_s)
    assert tr.op == "gemm_batched"
    assert tr.backend == ("device-kernel" if use_kernels else "device")
    # below the GEMM gate (min(m, n, k) >= 8) the kernel is not eligible
    with tpolicy(mode="device", use_kernels=True), ttrace() as tt:
        tblas.gemm_batched(torch.ones(2, 4, 8), torch.ones(2, 8, 8))
    assert tt.records[0].backend == "device"


def test_blas1_and_syrk_keep_the_reference_routing():
    """syrk is host-only (the paper's build); gemv / dot / axpy / scal /
    nrm2 have no kernel and take the plain device path when offloaded."""
    x = _np((16,), "float32")
    m = _np((12, 16), "float32")
    (jx, tx), (jm, tm) = _both(x), _both(m)
    calls = [("syrk", (jm,), (tm,)), ("gemv", (jm, jx), (tm, tx)),
             ("dot", (jx, jx), (tx, tx)), ("axpy", (2.0, jx, jx), (2.0, tx, tx)),
             ("scal", (3.0, jx), (3.0, tx)), ("nrm2", (jx,), (tx,))]
    for name, jargs, targs in calls:
        with jpolicy(mode="device", platform="tpu-v5e"), jtrace() as jt:
            want = getattr(jblas, name)(*jargs)
        with tpolicy(mode="device", use_kernels=True,
                     platform="tpu-v5e"), ttrace() as tt:
            got = getattr(tblas, name)(*targs)
        _close(got, want, "float32")
        (jr,), (tr,) = jt.records, tt.records
        assert (tr.op, tr.backend, tr.note, tr.device_id) == (
            jr.op, jr.backend, jr.note, jr.device_id), name


def test_linear_matches_reference():
    x, w, b = (_np(s, "float32") for s in ((2, 5, 16), (16, 12), (12,)))
    (jx, tx), (jw, tw), (jb, tb) = _both(x), _both(w), _both(b)
    with jpolicy(mode="device", platform="tpu-v5e"), jtrace() as jt:
        want = jblas.linear(jx, jw, jb)
    with tpolicy(mode="device", platform="tpu-v5e"), ttrace() as tt:
        got = tblas.linear(tx, tw, tb)
    _close(got, want, "float32")
    assert [r.op for r in tt.records] == [r.op for r in jt.records] == ["gemm"]
