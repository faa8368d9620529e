"""The port's SSM path (Mamba-2 SSD) on the CPU, against the reference.

* ``ssd_chunk_diag_ref`` (the plain version of ``csrc/ssd_scan.cu``) and the
  wrapper's CPU path against the reference's Pallas kernel in interpret
  mode, at ``tests/test_kernels.py``'s shapes and its causality case (1e-4);
* the ``ssd_scan`` descriptor against the reference's, under host and
  kernel policy: values (1e-4), trace records (backend ``device-pallas``
  mapped to ``device-kernel``) and its ``ValueError``;
* the chunked SSD against the naive recurrence of ``tests/test_ssm.py``
  (1e-3);
* ``mamba_block`` / ``decode_mamba_block`` and reduced mamba2-370m
  (``Model.forward`` eager and graph, one block's ``GraphReport``, decode,
  ``serve_batch``, the prefill step) against the reference on weights
  converted from its ``init_params``; tolerances are ``tests/test_models.py``'s
  (f32 2e-4, bf16 6e-2, decode against forward 2e-2).
* the mixer's causal conv + SiLU helper (``blas.causal_conv_silu``): off
  the card its plain version, the former conv bit for bit; its route
  choice; both blocks reaching it.

Both packages run under their kernel policy with ``platform="tpu-v5e"``:
the reference's Pallas kernels in interpret mode, the port's wrappers on
their plain versions (the tensors lie on the CPU).  The kernel itself runs
only on the card (``tests/test_torch_kernels_gpu.py``).
"""

import dataclasses
import functools
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.hnp as jhnp
import repro_torch.hnp as thnp
from repro.configs import get_arch as jget_arch
from repro.core import blas as jblas
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import engine as jengine
from repro.core.hero import offload_policy as jpolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import serve_batch as jserve_batch
from repro.launch.steps import make_prefill_step as jprefill
from repro.models import build_model as jbuild
from repro.models import forward as jforward
from repro.models import ssm as JS
from repro_torch.configs import get_arch as tget_arch
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import blas as tblas
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import engine as tengine
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.kernels.ops import KERNEL_LOWERINGS
from repro_torch.kernels.ref import ssd_chunk_diag_ref
from repro_torch.kernels.ssd_scan import ssd_chunk_diag, ssd_scan
from repro_torch.launch.serve import serve_batch as tserve_batch
from repro_torch.launch.steps import make_prefill_step as tprefill
from repro_torch.models import build_model as tbuild
from repro_torch.models import forward as tforward
from repro_torch.models import ssm as TS

ARCH = "mamba2-370m"
SSD_TOL = 1e-4                              # tests/test_kernels.py:169
TOL = {"float32": 2e-4, "bfloat16": 6e-2}   # tests/test_models.py
RENAME = {"device-pallas": "device-kernel"}
RNG = np.random.default_rng(11)
KERNEL_SHAPES = [(4, 2, 32, 16, 8), (2, 8, 64, 32, 16), (1, 1, 8, 8, 8)]


def _np(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _dta(bh, nc, q, scale=0.1):
    return np.cumsum(-np.abs(_np(bh, nc, q)) * scale, axis=-1).astype(
        np.float32)


def _t(a):
    return tensor_from_numpy(a)


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))


def _ref_policy(**kw):
    return jpolicy(mode="device", use_pallas=True, interpret=True,
                   platform="tpu-v5e", **kw)


def _port_policy(**kw):
    return tpolicy(mode="device", use_kernels=True, platform="tpu-v5e", **kw)


def _cfgs(dtype="float32", mode="eager"):
    j = dataclasses.replace(jget_arch(ARCH).reduced(), dtype=dtype,
                            forward_mode=mode)
    t = dataclasses.replace(tget_arch(ARCH).reduced(), dtype=dtype,
                            forward_mode=mode)
    return j, t


def _params(dtype="float32"):
    jcfg, _ = _cfgs(dtype)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _totals(records):
    """Count-weighted record totals per (op, backend): the reference scans
    its layers (one record per op with count = num_layers), the port's
    eager loop writes one record per layer."""
    out = defaultdict(lambda: [0.0, 0.0])
    for r in records:
        key = (r.op, RENAME.get(r.backend, r.backend))
        out[key][0] += r.count
        out[key][1] += r.count * r.cost.flops
    return dict(out)


# ---------------------------------------------------------------------------
# 1. The SSD chunk kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,nc,q,p,n", KERNEL_SHAPES)
def test_ssd_chunk_diag_ref_matches_reference_kernel(bh, nc, q, p, n):
    x, dta, b, c = _np(bh, nc, q, p), _dta(bh, nc, q), _np(bh, nc, q, n), \
        _np(bh, nc, q, n)
    want_kernel = jops.ssd_chunk_diag(*map(jnp.asarray, (x, dta, b, c)),
                                      interpret=True)
    want_ref = jref.ssd_chunk_diag_ref(*map(jnp.asarray, (x, dta, b, c)))
    got = ssd_chunk_diag_ref(*map(_t, (x, dta, b, c)))
    assert got.shape == (bh, nc, q, p) and got.dtype == torch.float32
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SSD_TOL, atol=SSD_TOL)
    # The wrapper takes its plain version for CPU tensors, and counts no
    # launch.
    before = ssd_chunk_diag.launches
    torch.testing.assert_close(ssd_chunk_diag(*map(_t, (x, dta, b, c))), got,
                               rtol=0, atol=0)
    assert ssd_chunk_diag.launches == before


def test_ssd_chunk_diag_causality():
    """tests/test_kernels.py::test_ssd_chunk_diag_causality on the plain
    version: position t does not depend on inputs past t."""
    bh, nc, q, p, n = 1, 1, 16, 8, 4
    x, dta, b, c = _np(bh, nc, q, p), _dta(bh, nc, q), _np(bh, nc, q, n), \
        _np(bh, nc, q, n)
    y1 = ssd_chunk_diag(*map(_t, (x, dta, b, c))).numpy()
    x2 = x.copy()
    x2[:, :, 10:, :] = 123.0
    y2 = ssd_chunk_diag(*map(_t, (x2, dta, b, c))).numpy()
    np.testing.assert_allclose(y1[:, :, :10], y2[:, :, :10], rtol=1e-5)
    jy2 = jops.ssd_chunk_diag(*map(jnp.asarray, (x2, dta, b, c)),
                              interpret=True)
    np.testing.assert_allclose(y2, np.asarray(jy2), rtol=SSD_TOL,
                               atol=SSD_TOL * np.abs(y2).max())


def test_ssd_chunk_diag_deep_decay_stays_finite():
    """A 256-token chunk whose cumulative log-decay reaches about -180 (the
    model's a = -1 and dt ≈ 0.7): exp of the masked pairs' positive
    exponents overflows, and the select keeps every output finite."""
    q = 256
    dta = np.cumsum(-np.abs(_np(2, 1, q)) * 0.7 * 1.25, axis=-1).astype(
        np.float32)
    assert dta[..., -1].min() < -150
    x, b, c = _np(2, 1, q, 16), _np(2, 1, q, 8), _np(2, 1, q, 8)
    got = ssd_chunk_diag_ref(*map(_t, (x, dta, b, c)))
    assert torch.isfinite(got).all()
    want = jref.ssd_chunk_diag_ref(*map(jnp.asarray, (x, dta, b, c)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SSD_TOL,
                               atol=SSD_TOL * np.abs(got.numpy()).max())


@settings(max_examples=6, deadline=None)
@given(bh=st.integers(1, 3), nc=st.integers(1, 3), q=st.integers(1, 40),
       p=st.integers(1, 20), n=st.integers(1, 20),
       dtype=st.sampled_from(["float32", "bfloat16"]))
def test_ssd_chunk_diag_ref_matches_reference_any_shape(bh, nc, q, p, n,
                                                        dtype):
    """Ragged shapes (Q, P, N not multiples of any tile) and bf16 operands
    (computed in fp32, rounded once to x's dtype)."""
    arrs = [np.asarray(jnp.asarray(a, dtype)) for a in
            (_np(bh, nc, q, p), _dta(bh, nc, q), _np(bh, nc, q, n),
             _np(bh, nc, q, n))]
    want = np.asarray(jref.ssd_chunk_diag_ref(*map(jnp.asarray, arrs)),
                      np.float32)
    got = ssd_chunk_diag_ref(*map(_t, arrs))
    assert got.dtype == getattr(torch, dtype)
    tol = SSD_TOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_ssd_chunk_diag_wrapper_rejects_what_the_kernel_does_not_take():
    x, dta, b, c = (torch.zeros(s) for s in ((2, 1, 8, 4), (2, 1, 8),
                                             (2, 1, 8, 3), (2, 1, 8, 3)))
    with pytest.raises(ValueError, match="dt_a"):
        ssd_chunk_diag(x, dta[:, :, :4], b, c)
    with pytest.raises(ValueError, match="b/c"):
        ssd_chunk_diag(x, dta, b[:1], c[:1])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ssd_chunk_diag(*(t.to("meta") for t in (x, dta, b, c)))
    assert KERNEL_LOWERINGS["ssd_scan"] is ssd_scan
    assert KERNEL_LOWERINGS["ssd_chunk_diag"] is ssd_chunk_diag


# ---------------------------------------------------------------------------
# 2. The ssd_scan descriptor
# ---------------------------------------------------------------------------

def _ssd_operands(bsz=2, s=32, h=4, p=16, n=8, dtype=np.float32):
    x = _np(bsz, s, h, p).astype(dtype)
    dt = (np.abs(_np(bsz, s, h)) * 0.5).astype(np.float32)
    a = (-np.abs(_np(h))).astype(np.float32)
    b, c = _np(bsz, s, h, n).astype(dtype), _np(bsz, s, h, n).astype(dtype)
    d_skip = np.ones(h, np.float32)
    return x, dt, a, b, c, d_skip


@pytest.mark.parametrize("chunk", [8, 32, 64])
@pytest.mark.parametrize("mode,use_kernels", [("host", False),
                                              ("device", False),
                                              ("device", True)])
def test_ssd_scan_descriptor_matches_reference(chunk, mode, use_kernels):
    ops = _ssd_operands()
    with jpolicy(mode=mode, use_pallas=use_kernels, interpret=True,
                 platform="tpu-v5e"), jtrace() as jt:
        want = jblas.ssd_scan(*map(jnp.asarray, ops), chunk=chunk)
    with tpolicy(mode=mode, use_kernels=use_kernels,
                 platform="tpu-v5e"), ttrace() as tt:
        got = tblas.ssd_scan(*map(_t, ops), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ops[0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SSD_TOL,
                               atol=SSD_TOL * np.abs(got.numpy()).max())
    (jr,), (tr,) = jt.records, tt.records
    assert RENAME.get(jr.backend, jr.backend) == tr.backend
    assert tr.backend == {"host": "host", "device": "device"}[mode] + (
        "-kernel" if use_kernels else "")
    assert (tr.op, tr.shape_key, tr.dtype, tr.cost.flops,
            tr.cost.staged_bytes, tr.cost.touched_bytes, tr.cost.out_shape) \
        == (jr.op, jr.shape_key, jr.dtype, jr.cost.flops,
            jr.cost.staged_bytes, jr.cost.touched_bytes, jr.cost.out_shape)
    assert tr.regions.offload_s == jr.regions.offload_s


def test_ssd_scan_eligibility_matches_reference():
    """The kernel gate min(P, N, Q) >= 8 and f32/bf16, kept exactly: a
    narrow state (N 4) or a short chunk (Q 4) takes the plain device path
    in both packages."""
    for n, chunk in ((4, 8), (8, 4), (8, 8)):
        ops = _ssd_operands(n=n, s=16)
        with _ref_policy(), jtrace() as jt:
            jblas.ssd_scan(*map(jnp.asarray, ops), chunk=chunk)
        with _port_policy(), ttrace() as tt:
            tblas.ssd_scan(*map(_t, ops), chunk=chunk)
        want = RENAME.get(jt.records[0].backend, jt.records[0].backend)
        assert tt.records[0].backend == want
        assert want == ("device-kernel" if min(n, chunk) >= 8 else "device")


def test_ssd_scan_rejects_a_ragged_sequence():
    ops = _ssd_operands(s=20)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        jblas.ssd_scan(*map(jnp.asarray, ops), chunk=8)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tblas.ssd_scan(*map(_t, ops), chunk=8)
    with pytest.raises(ValueError, match="dt"):
        tblas.ssd_scan(*map(_t, ops[:1] + (ops[1][:, :4],) + ops[2:]),
                       chunk=4)


def _naive_ssd(x, dt, a, b, c, d_skip):
    """tests/test_ssm.py's oracle: h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_tᵀ."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = np.zeros((bsz, s, h, p), np.float32)
    st_ = np.zeros((bsz, h, n, p), np.float32)
    for t in range(s):
        decay = np.exp(dt[:, t] * a)
        st_ = decay[..., None, None] * st_ + np.einsum(
            "bh,bhn,bhp->bhnp", dt[:, t], b[:, t], x[:, t])
        y[:, t] = np.einsum("bhn,bhnp->bhp", c[:, t], st_)
    return y + x * d_skip[None, None, :, None]


@pytest.mark.parametrize("use_kernels", [True, False])
def test_chunked_ssd_equals_naive_recurrence(use_kernels):
    """The chunked form (within-chunk term, chunk states, the loop over
    chunks) equals the sequential scan across four chunk boundaries."""
    ops = _ssd_operands(s=32, h=8, p=16, n=16)
    with tpolicy(mode="device", use_kernels=use_kernels):
        got = tblas.ssd_scan(*map(_t, ops), chunk=8)
    np.testing.assert_allclose(got.numpy(), _naive_ssd(*ops), rtol=1e-3,
                               atol=1e-3)


def test_ssd_scan_shape_inference_on_meta_matches_eval_shape():
    """hnp infers the node from the host lowering run on meta tensors (no
    value is read); it equals the reference's jax.eval_shape result."""
    ops = _ssd_operands(s=16)
    jn = jhnp.ssd_scan(*map(jnp.asarray, ops), chunk=8).node
    tn = thnp.ssd_scan(*map(_t, ops), chunk=8).node
    assert tn.shape == jn.shape and tn.nbytes == jn.nbytes
    assert str(tn.dtype).removeprefix("torch.") == np.dtype(jn.dtype).name


# ---------------------------------------------------------------------------
# 3. The Mamba block and its decode recurrence
# ---------------------------------------------------------------------------

def _block_params(dtype=jnp.float32):
    jcfg, tcfg = _cfgs()
    jp = JS.init_mamba(jax.random.PRNGKey(0), jcfg, dtype)
    return jcfg, tcfg, jp, _tree_to_torch(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("s", [8, 16, 24])
def test_mamba_block_matches_reference(s):
    jcfg, tcfg, jp, tp = _block_params()
    x = (_np(2, s, jcfg.d_model) * 0.3)
    with _ref_policy(), jtrace() as jt:
        want = JS.mamba_block(jp, jnp.asarray(x), jcfg)
    with _port_policy(), ttrace() as tt:
        got = TS.mamba_block(tp, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL["float32"], atol=TOL["float32"])
    assert _totals(tt.records) == _totals(jt.records)
    assert ("ssd_scan", "device-kernel") in _totals(tt.records)


def test_mamba_block_is_causal():
    """tests/test_ssm.py::test_mamba_causality on the port."""
    _, tcfg, _, tp = _block_params()
    x = _np(1, 16, tcfg.d_model) * 0.3
    x2 = x.copy()
    x2[:, 12:, :] = 55.0
    with _port_policy():
        y1, y2 = TS.mamba_block(tp, _t(x), tcfg), TS.mamba_block(tp, _t(x2),
                                                                tcfg)
    np.testing.assert_allclose(y1[:, :12].numpy(), y2[:, :12].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_decode_mamba_block_matches_reference_and_block():
    """Step-by-step decode against the reference's (1e-4, states too) and
    against the full chunked pass at the last position (2e-3, as
    tests/test_ssm.py); the port writes the states in place."""
    jcfg, tcfg, jp, tp = _block_params()
    s = 16
    x = _np(2, s, jcfg.d_model) * 0.3
    ssm_shape, conv_shape = TS.mamba_state_shapes(tcfg, 2)
    assert (ssm_shape, conv_shape) == JS.mamba_state_shapes(jcfg, 2)
    jstate = (jnp.zeros(ssm_shape, jnp.float32),
              jnp.zeros(conv_shape, jnp.float32))
    tstate = (torch.zeros(ssm_shape), torch.zeros(conv_shape))
    with _ref_policy():
        for t in range(s):
            jout, jstate = JS.decode_mamba_block(
                jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
    with _port_policy():
        for t in range(s):
            tout, new = TS.decode_mamba_block(tp, _t(x[:, t:t + 1]), tstate,
                                              tcfg)
            assert new[0] is tstate[0] and new[1] is tstate[1]
        full = TS.mamba_block(tp, _t(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    for tt_, jj in zip(tstate, jstate):
        np.testing.assert_allclose(tt_.numpy(), np.asarray(jj), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(jj)).max())
    np.testing.assert_allclose(tout[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# 4. Reduced mamba2-370m: forward, graph report, decode, serve, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eager", "graph"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(mode, dtype):
    jp, tp = _params(dtype)
    jcfg, tcfg = _cfgs(dtype, mode)
    toks = _tokens(jcfg)
    with _ref_policy():
        jengine().reset()
        with jtrace() as jt:
            jl, jaux = jbuild(jcfg).forward(jp, {"tokens": jnp.asarray(toks)})
    with _port_policy(), torch.no_grad():
        tengine().reset()
        with ttrace() as tt:
            tl, taux = tbuild(tcfg).forward(tp, torch.from_numpy(toks))
    jl = np.asarray(jl, np.float32)
    assert tl.shape == jl.shape and tl.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert float(taux) == float(jaux) == 0.0
    jtot, ttot = _totals(jt.records), _totals(tt.records)
    assert ttot == jtot
    assert ("ssd_scan", "device-kernel") in ttot
    assert ttot[("ssd_scan", "device-kernel")][0] == tcfg.num_layers
    if mode == "graph":
        assert ("gemm_batched", "device-kernel") in ttot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_eager_and_graph_agree(dtype):
    _, tp = _params(dtype)
    toks = torch.from_numpy(_tokens(_cfgs(dtype)[1]))
    out = {}
    for mode in ("eager", "graph"):
        with _port_policy(), torch.no_grad():
            out[mode] = tbuild(_cfgs(dtype, mode)[1]).forward(tp, toks)[0]
    torch.testing.assert_close(out["graph"], out["eager"], rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_one_mamba_block_graph_report_matches_reference():
    """One Mamba block captured as an hnp graph on both packages: every
    NodeReport field (node ids relative to the block's first node), the
    summary and every record equal, except that the port's ssd_scan takes B
    and C once a group where the reference repeats them over the heads, so
    it stages exactly those repeats' bytes less, with the resident share
    and the modeled offload time that the reference's cost model gives
    those bytes.  z/x and B/C batch into one launch each, and the SiLU gate
    rides the ssd_scan launch."""
    jp, tp = _params("float32")
    jcfg, tcfg = _cfgs("float32", "graph")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (2, 16, jcfg.d_model)), np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jlayer = jax.tree.map(lambda a: a[1], jp["stack"])
    reports = {}
    for name in ("ref", "port"):
        if name == "ref":
            pol, trace, fwd, eng = _ref_policy, jtrace, jforward, jengine
            args = (jlayer, jnp.asarray(x), jcfg)
            kw = dict(positions=jnp.asarray(pos))
            base_leaf = lambda: jhnp.array(jnp.zeros(1)).node.id  # noqa: E731
        else:
            pol, trace, fwd, eng = _port_policy, ttrace, tforward, tengine
            args = (tp["stack"][1], tensor_from_numpy(x), tcfg)
            kw = dict(positions=torch.from_numpy(pos.copy()))
            base_leaf = lambda: thnp.array(torch.zeros(1)).node.id  # noqa: E731
        eng().reset()
        with pol(num_devices=2, scheduler="cost-aware") as scoped, \
                trace() as t, fwd.capture_reports() as reps:
            base = base_leaf() + 1
            y, _ = fwd.graph_block(*args, "mamba", False, **kw)
            if name == "ref":
                score = functools.partial(scoped.policy.score,
                                          platform=scoped.platform)
        (rep,) = reps
        reports[name] = (
            np.asarray(y, np.float32) if name == "ref" else y.numpy(),
            [(r.node_id - base, r.op, RENAME.get(r.backend, r.backend),
              r.device_id, r.resident_fraction, r.staged_in_bytes,
              r.readback_bytes, r.fused, r.batched) for r in rep.launches],
            (rep.nodes_eliminated, rep.prefetched_bytes, rep.fused_ops),
            [(r.op, RENAME.get(r.backend, r.backend), r.device_id,
              r.resident_fraction, r.staged_bytes_charged,
              r.regions.offload_s) for r in t.records
             if r.op != "d2d_copy"] +
            [(r.op, r.device_id, r.cost.staged_bytes) for r in t.records
             if r.op == "d2d_copy"])
    (jy, jrep, jsum, jrec), (ty, trep, tsum, trec) = (reports["ref"],
                                                      reports["port"])
    np.testing.assert_allclose(ty, jy, rtol=2e-4, atol=2e-4)

    def split_ssd(launches, records):
        ssd_l = [r for r in launches if r[1] == "ssd_scan"]
        ssd_r = [r for r in records if r[0] == "ssd_scan"]
        return ([r if r[1] != "ssd_scan" else r[:4] + r[6:] for r in launches],
                [r if r[0] != "ssd_scan" else r[:3] for r in records],
                ssd_l, ssd_r)

    trep_, trec_, (tl,), (tr,) = split_ssd(trep, trec)
    jrep_, jrec_, (jl,), (jr,) = split_ssd(jrep, jrec)
    assert trep_ == jrep_ and tsum == jsum and trec_ == jrec_
    heads, groups = tcfg.ssm_num_heads, tcfg.ssm_num_groups
    bsz, s = x.shape[:2]
    pdim, n = tcfg.ssm_head_dim, tcfg.ssm_state_dim
    repeats = 2 * bsz * s * (heads - groups) * n * 4
    assert groups < heads and tl[5] == jl[5] - repeats
    # The share is (resident + kept output) / (staged + resident + kept
    # output) bytes; the output is kept (no read-back), so the bytes that do
    # not move are rf / (1 - rf) of the staged ones, the same on both sides.
    assert jl[6] == tl[6] == 0.0
    kept = round(jl[4] * jl[5] / (1.0 - jl[4]))
    assert jl[4] == kept / (jl[5] + kept)
    assert tl[4] == kept / (tl[5] + kept) and tr[3] == tl[4]
    # The op's cost reads only the dims, so the modeled time moves with the
    # share alone: the reference's cost model at the port's share.
    z = jnp.zeros
    cost = jblas._ssd_cost(z((bsz, s, heads, pdim)), z((bsz, s, heads)),
                           z((heads,)), z((bsz, s, heads, n)),
                           z((bsz, s, heads, n)), z((heads,)),
                           chunk=tcfg.ssm_chunk)
    assert jr[5] == score(cost, resident_fraction=jl[4]).offload_s
    assert tr[5] == score(cost, resident_fraction=tl[4]).offload_s
    assert sum(1 for r in trep if r[1] == "matmul" and r[8]) == 4
    assert [r[0] for r in trec].count("gemm_batched") == 2
    (ssd,) = [r for r in trep if r[1] == "ssd_scan"]
    assert ssd[7] == ("mul",)        # the SiLU gate rides the ssd launch


def test_decode_matches_forward():
    """tests/test_models.py::test_decode_matches_forward for mamba2-370m
    (chunk 8, 16 tokens, 2e-2), and the port's decode logits against the
    reference's at every step (1e-4 of their scale)."""
    jp, tp = _params()
    jcfg, tcfg = _cfgs()
    s = 16
    toks = _tokens(jcfg, s=s, seed=3)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    with _port_policy(), torch.no_grad():
        fwd = tm.forward(tp, torch.from_numpy(toks))[0]
        cache = tm.init_decode_cache(2, s, device="cpu")
        assert set(cache) == {"ssm", "conv"}
        assert cache["ssm"].dtype == torch.float32
        assert cache["ssm"].shape == (tcfg.num_layers, 2,
                                      tcfg.ssm_num_heads, tcfg.ssm_state_dim,
                                      tcfg.ssm_head_dim)
        tl = []
        for t in range(s):
            logits, cache = tm.decode_step(tp, cache,
                                           torch.from_numpy(toks[:, t:t + 1]),
                                           t)
            tl.append(logits.numpy())
    np.testing.assert_allclose(tl[-1], fwd[:, -1].numpy(), rtol=2e-2,
                               atol=2e-2)
    jc, jl = jm.init_decode_cache(2, s), []
    with _ref_policy():
        for t in range(s):
            logits, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t))
            jl.append(np.asarray(logits))
    jl, tl = np.stack(jl), np.stack(tl)
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(jc["ssm"]),
                               rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jc["ssm"])).max())


class _BlockingJax:
    """``jax`` as the reference's serve module sees it, with every jitted
    step waited for (the reference's token-buffer race, ROADMAP Queue 3;
    see tests/test_torch_serve.py)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kwargs):
        step = jax.jit(fn, **kwargs)
        return lambda *args: jax.block_until_ready(step(*args))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_batch_greedy_tokens_match_reference(use_kernels, monkeypatch):
    import repro.launch.serve

    monkeypatch.setattr(repro.launch.serve, "jax", _BlockingJax())
    jp, tp = _params()
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, 200, size=4))) for _ in range(8)]
    with _ref_policy():
        want = jserve_batch(ARCH, prompts, smoke=True, max_new_tokens=4,
                            params=jp)
    with tpolicy(mode="device", use_kernels=use_kernels, platform="tpu-v5e"):
        got = tserve_batch(ARCH, prompts, smoke=True, max_new_tokens=4,
                           params=tp, device="cpu")
    assert got.tokens.shape == (8, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_cli_serves_mamba_on_the_kernels(capsys):
    from repro_torch.launch.serve import main

    with ttrace() as tt:
        main(["--arch", ARCH, "--device", "cpu", "--prompt-len", "2",
              "--max-new", "2"])
    backends = defaultdict(set)
    for r in tt.records:
        backends[r.op].add(r.backend)
    assert backends["gemm"] == {"device-kernel"}
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["eager", "graph"])
def test_prefill_step_matches_reference(mode):
    jp, tp = _params()
    jcfg, tcfg = _cfgs("float32", mode)
    toks = _tokens(jcfg, s=24)
    with _ref_policy():
        want = jprefill(jbuild(jcfg))(jp, {"tokens": jnp.asarray(toks)})
    with _port_policy(), torch.no_grad():
        step = tprefill(tbuild(tcfg))
        got = step(tp, torch.from_numpy(toks))
        fwd = tbuild(tcfg).forward(tp, torch.from_numpy(toks))[0]
    assert torch.equal(got, fwd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_carries_mamba_params(dtype):
    """Every leaf arrives with the reference's bits and dtype: the fp32
    leaves of a bf16 model (dt_bias, a_log, d_skip) stay fp32, the tied
    embedding is there and no head is made."""
    jp, tp = _params(dtype)
    jcfg, tcfg = _cfgs(dtype)
    assert "head" not in tp and "head" not in jp
    assert len(tp["stack"]) == tcfg.num_layers
    fp32 = {"dt_bias", "a_log", "d_skip"}
    for i, layer in enumerate(tp["stack"]):
        assert set(layer) == {"norm1", "mixer"}
        for name, leaf in layer["mixer"].items():
            want = np.asarray(jp["stack"]["mixer"][name][i]) if name != \
                "norm" else np.asarray(jp["stack"]["mixer"]["norm"]["scale"][i])
            got = leaf if name != "norm" else leaf["scale"]
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name
            if name in fp32:
                assert got.dtype == torch.float32
            else:
                assert got.dtype == getattr(torch, dtype)
            assert np.array_equal(got.view(torch.int16 if dtype == "bfloat16"
                                           and name not in fp32
                                           else torch.int32).numpy(),
                                  want.view(np.int16 if dtype == "bfloat16"
                                            and name not in fp32
                                            else np.int32))
    emb = np.asarray(jp["embed"])
    assert tp["embed"].shape == emb.shape
    # A model built from the converted params runs its tied head.
    with _port_policy(), torch.no_grad():
        logits = tbuild(tcfg).forward(tp, torch.from_numpy(_tokens(tcfg)))[0]
    assert logits.shape[-1] == tcfg.vocab_size


def test_hybrid_and_moe_stacks_build_decode_caches():
    """A uniform MoE stack builds a decode cache; a hybrid stack (jamba's
    Mamba sub-layers beside attention and MoE sub-layers) builds its mixed
    one — k/v a super-block, SSM and conv states a Mamba sub-layer — and
    decodes a token into it (tests/test_torch_hybrid.py holds it against
    the reference)."""
    from repro_torch.models import transformer as T

    hybrid = tget_arch("jamba-1.5-large-398b").reduced()
    n_sb = hybrid.num_layers // 8
    cache = T.init_decode_cache(hybrid, 1, 4, torch.float32, device="cpu")
    ssm_shape, conv_shape = TS.mamba_state_shapes(hybrid, 1)
    assert tuple(cache["k"].shape) == (n_sb, 1, hybrid.num_kv_heads, 4,
                                       hybrid.head_dim)
    assert tuple(cache["ssm"].shape) == (n_sb, 7, *ssm_shape)
    assert tuple(cache["conv"].shape) == (n_sb, 7, *conv_shape)
    assert cache["ssm"].dtype == torch.float32
    stack = T.init_stack(torch.Generator().manual_seed(0), hybrid,
                         torch.float32, device="cpu")
    with _port_policy(), torch.no_grad():
        y, cache = T.decode_stack(stack, cache,
                                  torch.randn(1, 1, hybrid.d_model), 0,
                                  hybrid)
    assert torch.isfinite(y).all() and cache["ssm"].abs().sum() > 0
    moe = tget_arch("qwen3-moe-30b-a3b").reduced()
    cache = T.init_decode_cache(moe, 1, 4, torch.float32, device="cpu")
    assert tuple(cache["k"].shape) == (moe.num_layers, 1, moe.num_kv_heads,
                                       4, moe.head_dim)


# ---------------------------------------------------------------------------
# 5. The mixer's causal conv + SiLU helper (``blas.causal_conv_silu``)
# ---------------------------------------------------------------------------

def _todays_conv(x, b, c, w, bias):
    """The mixer's conv before the helper, verbatim (``models/ssm.py``'s
    ``conv_and_inputs`` and ``_causal_conv``), up to the SiLU."""
    u = torch.cat([x, b, c], dim=-1)
    k, s = w.shape[0], u.shape[1]
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(k):
        shift = k - 1 - i
        ui = torch.nn.functional.pad(u, (0, 0, shift, 0))[:, :s, :]
        out = out + ui.float() * w[i].float()
    return (out + bias.float()).to(u.dtype).float()


def _conv_ops(bsz=2, s=13, di=32, gn=8, k=4, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(bsz, s, di, generator=g).to(dtype),
            torch.randn(bsz, s, gn, generator=g).to(dtype),
            torch.randn(bsz, s, gn, generator=g).to(dtype),
            (0.2 * torch.randn(k, di + 2 * gn, generator=g)).to(dtype),
            (0.1 * torch.randn(di + 2 * gn, generator=g)).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 32, 8, 4), (1, 2, 16, 4, 4),
                                   (3, 40, 24, 12, 3), (2, 7, 10, 6, 5)])
@pytest.mark.parametrize("policy", ["kernels", "host"])
def test_conv_helper_torch_path_is_todays_conv_bit_for_bit(dtype, shape,
                                                           policy):
    """Off the card the helper runs the plain version, which is the mixer's
    former conv + SiLU bit for bit, under either policy, at conv widths the
    kernel takes and at one it does not (K 5)."""
    from repro_torch.kernels.ref import causal_conv_silu_ref

    ops = _conv_ops(*shape, dtype=dtype)
    want = torch.nn.functional.silu(_todays_conv(*ops))
    pol = _port_policy() if policy == "kernels" else tpolicy(mode="host")
    with pol:
        got = tblas.causal_conv_silu(*ops)
    bsz, s, di, gn, _ = shape
    assert got.shape == (bsz, s, di + 2 * gn) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(causal_conv_silu_ref(*ops), want)
    assert torch.equal(causal_conv_silu_ref(*ops, silu=False),
                       _todays_conv(*ops))


def test_conv_helper_matches_the_reference_conv():
    """The helper against the reference's conv + SiLU on the same numpy
    operands (``src/repro/models/ssm.py``: concatenate, ``_causal_conv``,
    ``jax.nn.silu``), f32 at 1e-6."""
    ops = _conv_ops(2, 21, 32, 8, 4)
    u = jnp.concatenate([jnp.asarray(t.numpy()) for t in ops[:3]], axis=-1)
    want = jax.nn.silu(JS._causal_conv(u, jnp.asarray(ops[3].numpy()),
                                       jnp.asarray(ops[4].numpy())))
    with _port_policy():
        got = tblas.causal_conv_silu(*ops)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["cpu", "grad", "float64", "width",
                                  "misaligned", "mixed", "k5"])
def test_conv_helper_takes_the_torch_path_and_counts_nothing(case):
    """Route choice off the card: CPU tensors (even ones the kernel would
    take), grad mode with an operand that requires grad, a dtype, width,
    alignment, dtype mix or conv width the kernel does not take all run the
    plain version, and the kernel's counters stay at 0."""
    from repro_torch.kernels.ref import causal_conv_silu_ref
    from repro_torch.kernels.ssd_scan import causal_conv_silu, conv_route

    ops = list(_conv_ops(2, 9, 32, 8, 4, dtype=torch.bfloat16))
    want_route = {"cpu": "bf16", "grad": "bf16"}.get(case)
    if case == "grad":
        ops = [t.float().requires_grad_() for t in ops]
        want_route = "f32"
    elif case == "float64":
        ops = [t.double() for t in ops]
    elif case == "width":
        ops = list(_conv_ops(2, 9, 30, 8, 4, dtype=torch.bfloat16))
    elif case == "misaligned":
        wide = torch.randn(2, 9, 33).to(torch.bfloat16)
        ops[0] = wide[..., 1:]
    elif case == "mixed":
        ops[3] = ops[3].float()
    elif case == "k5":
        ops = list(_conv_ops(2, 9, 32, 8, 5, dtype=torch.bfloat16))
    assert conv_route(*ops) == want_route
    before = (causal_conv_silu.launches, dict(causal_conv_silu.route_launches))
    with _port_policy():
        got = tblas.causal_conv_silu(*ops)
    assert (causal_conv_silu.launches,
            causal_conv_silu.route_launches) == before
    assert causal_conv_silu.launches == 0
    assert set(causal_conv_silu.route_launches.values()) == {0}
    assert torch.equal(got, causal_conv_silu_ref(*ops))
    if case == "grad":
        assert got.requires_grad
        got.sum().backward()
        assert all(t.grad is not None for t in ops)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy", ["kernels", "host"])
def test_conv_helper_under_grad_gives_the_plain_versions_gradients(dtype,
                                                                  policy):
    """Under grad the kernel policy runs the wrapper inside an
    ``autograd.Function`` whose backward recomputes the plain version (on
    the CPU its forward is the plain version too); the host policy runs the
    plain version itself.  Either way the output and every operand's
    gradient equal the plain version's bit for bit, and nothing launches."""
    from repro_torch.kernels.ref import causal_conv_silu_ref
    from repro_torch.kernels.ssd_scan import causal_conv_silu

    ops = _conv_ops(2, 11, 32, 8, 4, dtype=dtype, seed=3)
    dout = torch.randn(2, 11, 48, generator=torch.Generator().manual_seed(4))
    mine = [t.clone().requires_grad_() for t in ops]
    plain = [t.clone().requires_grad_() for t in ops]
    pol = _port_policy() if policy == "kernels" else tpolicy(mode="host")
    with pol:
        got = tblas.causal_conv_silu(*mine)
    want = causal_conv_silu_ref(*plain)
    assert ("_CausalConv" in type(got.grad_fn).__name__) == (
        policy == "kernels")
    got.backward(dout)
    want.backward(dout)
    assert torch.equal(got, want)
    for t, u in zip(mine, plain):
        assert t.grad.dtype == dtype and torch.equal(t.grad, u.grad)
    assert causal_conv_silu.launches == 0


@pytest.mark.parametrize("case", ["misaligned", "row_stride", "batch_stride",
                                  "channel_stride", "width", "k3", "k5",
                                  "float64", "mixed"])
def test_conv_route_tells_a_copy_from_a_refusal(case):
    """What the card's wrapper does with operands the kernel cannot read as
    they lie: a view's layout (address, row, batch or channel stride) is
    cured by a contiguous copy, which the kernel takes; a width, conv
    width or dtype is not, and raises there."""
    from repro_torch.kernels import ssd_scan as kss

    ops = list(_conv_ops(2, 9, 32, 8, 4, dtype=torch.bfloat16))
    if case == "misaligned":
        ops[0] = torch.randn(2 * 9 * 32 + 1).to(torch.bfloat16)[1:].view(
            2, 9, 32)
    elif case == "row_stride":
        ops[0] = torch.randn(2, 9, 34).to(torch.bfloat16)[..., :32]
    elif case == "batch_stride":
        ops[1] = torch.randn(160).to(torch.bfloat16).as_strided(
            (2, 9, 8), (74, 8, 1))
    elif case == "channel_stride":
        ops[2] = torch.randn(2, 9, 16).to(torch.bfloat16)[..., ::2]
    elif case == "width":
        ops = list(_conv_ops(2, 9, 30, 8, 4, dtype=torch.bfloat16))
    elif case == "k3":
        ops = list(_conv_ops(2, 9, 32, 8, 3, dtype=torch.bfloat16))
    elif case == "k5":
        ops = list(_conv_ops(2, 9, 32, 8, 5, dtype=torch.bfloat16))
    elif case == "float64":
        ops = [t.double() for t in ops]
    elif case == "mixed":
        ops[4] = ops[4].float()
    copyable = case in ("misaligned", "row_stride", "batch_stride",
                        "channel_stride")
    assert kss.conv_route(*ops) is None
    assert (kss._conv_shape_route(*ops) == "bf16") == copyable
    if copyable:
        copies = [t.clone(memory_format=torch.contiguous_format)
                  for t in ops]
        assert kss.conv_route(*copies) == "bf16"


def test_conv_wrapper_rejects_what_does_not_fit():
    from repro_torch.kernels.ssd_scan import causal_conv_silu

    x, b, c, w, bias = _conv_ops(2, 9, 32, 8, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        causal_conv_silu(x, b[:, :4], c, w, bias)
    with pytest.raises(ValueError, match="do not fit F"):
        causal_conv_silu(x, b, c, w[:, :40], bias)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        causal_conv_silu(*(t.to("meta") for t in (x, b, c, w, bias)))


@pytest.mark.parametrize("mode", ["eager", "graph"])
def test_both_mamba_blocks_reach_the_conv_helper(mode, monkeypatch):
    """The eager and the graph block make their SSD operands through
    ``blas.causal_conv_silu``, once a mixer, and the forward still matches
    the reference's."""
    jp, tp = _params("float32")
    jcfg, tcfg = _cfgs("float32", mode)
    toks = _tokens(jcfg)
    calls = []
    helper = tblas.causal_conv_silu
    monkeypatch.setattr(tblas, "causal_conv_silu",
                        lambda *a: calls.append(a[0].shape) or helper(*a))
    with _ref_policy():
        jl, _ = jbuild(jcfg).forward(jp, {"tokens": jnp.asarray(toks)})
    with _port_policy(), torch.no_grad():
        tl, _ = tbuild(tcfg).forward(tp, torch.from_numpy(toks))
    assert len(calls) == tcfg.num_layers
    assert all(s == (*toks.shape, tcfg.d_inner) for s in calls)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=TOL["float32"], atol=TOL["float32"])
