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
from repro_torch.kernels.flash_attention import flash_attention
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
