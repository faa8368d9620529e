"""The port's modeled substrate against the JAX reference's.

Cost model, ``HeroCluster.launch`` placement and the dispatch records are
pure-Python float arithmetic in both packages, so the port's outputs must be
*equal* to the reference's, not merely close.  Both sides are pinned to the
same platform (the reference defaults to tpu-v5e, the port to h100-sxm).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from config_parity import assert_config_equal

from repro.core import blas as jblas
from repro.core import cost_model as jcm
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import engine as jengine
from repro.core.hero import offload_policy as jpolicy
from repro.core.platform import get_platform as jplatform
from repro_torch.core import blas as tblas
from repro_torch.core import cost_model as tcm
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import engine as tengine
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.core.platform import get_platform as tplatform

BACKEND = {"device-pallas": "device-kernel"}
PLATFORMS = ["hesoc-vcu128", "tpu-v5e"]
SIZES = [(1, 1, 1), (8, 8, 8), (64, 64, 64), (128, 256, 64), (1000, 17, 300),
         (4096, 4096, 4096)]


def _d(x):
    return dataclasses.asdict(x)


def _scored(bd):
    return (_d(bd), bd.offload_s, bd.speedup)


@pytest.mark.parametrize("reduced", [False, True])
def test_yi_6b_config_equal(reduced):
    from repro.configs import get_arch as jget_arch
    from repro_torch.configs import get_arch as tget_arch

    jc, tc = jget_arch("yi-6b"), tget_arch("yi-6b")
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert_config_equal(tc, jc)


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("mnk", SIZES)
def test_cost_model_equal(platform, mnk):
    jp, tp = jplatform(platform), tplatform(platform)
    assert _d(jp) == _d(tp)
    m, n, k = mnk
    for itemsize in (2, 4, 8):
        jc, tc = jcm.gemm_cost(m, n, k, itemsize), tcm.gemm_cost(m, n, k, itemsize)
        assert _d(jc) == _d(tc)
        for zero_copy in (False, True):
            for rf in (0.0, 0.5, 1.0):
                kw = dict(zero_copy=zero_copy, resident_fraction=rf)
                assert _scored(jcm.breakdown(jc, jp, **kw)) == \
                    _scored(tcm.breakdown(tc, tp, **kw))
                for chunk in (None, 4096.0):
                    jb = jcm.pipelined_breakdown(jc, jp, chunk_bytes=chunk, **kw)
                    tb = tcm.pipelined_breakdown(tc, tp, chunk_bytes=chunk, **kw)
                    assert _scored(jb) == _scored(tb)
                for pipe in (False, True):
                    jo, jb = jcm.decide_offload(jc, jp, pipeline=pipe, **kw)
                    to, tb = tcm.decide_offload(tc, tp, pipeline=pipe, **kw)
                    assert jo == to and _scored(jb) == _scored(tb)


def test_staging_legs_clamps_subnormal_chunk():
    """The reference raises OverflowError here (cost_model.py:157); the port
    clamps to MAX_PIPELINE_CHUNKS equal legs, like any other over-deep
    split, and agrees with the reference wherever the reference returns."""
    with pytest.raises(OverflowError):
        jcm.staging_legs(1.0, 5e-324)
    legs = tcm.staging_legs(1.0, 5e-324)
    assert len(legs) == tcm.MAX_PIPELINE_CHUNKS
    assert sum(legs) == pytest.approx(1.0) and all(x > 0 for x in legs)
    for staged, chunk in [(0.0, 1.0), (10.0, 3.0), (1e6, 1.0), (5.0, 0.0),
                          (7.0, 7.0), (1e9, 4 << 20)]:
        assert jcm.staging_legs(staged, chunk) == tcm.staging_legs(staged, chunk)


# Direct gemm dispatches: (m, k, n, dtype, pinned handle name or None).
CALLS = [
    (8, 8, 8, "float32", None),
    (7, 64, 64, "float32", None),
    (64, 64, 64, "bfloat16", None),
    (128, 128, 128, "float32", "weights"),
    (16, 128, 32, "bfloat16", None),
    (128, 128, 128, "float32", "weights"),
    (1, 64, 8, "float32", None),
]


def _ticket(t):
    return (t.op, t.shape_key, t.offload_s, t.issue_s, t.copy_ready_s,
            t.copy_done_s, t.complete_s, t.compute_start_s, t.kind,
            t.resident_fraction, t.device_id)


def _record(r):
    return (r.op, r.shape_key, r.dtype, BACKEND.get(r.backend, r.backend),
            _d(r.cost), _d(r.regions), r.zero_copy, r.note, r.count,
            r.device_id, r.resident_fraction)


def _run(pkg, mode, num_devices):
    rng = np.random.default_rng(0)
    if pkg == "ref":
        policy = jpolicy(mode=mode, num_devices=num_devices,
                         scheduler="cost-aware", platform="tpu-v5e",
                         use_pallas=True, interpret=True)
        trace, blas, eng = jtrace(), jblas, jengine

        def arr(x, dt):
            return jnp.asarray(x, getattr(jnp, dt))
    else:
        policy = tpolicy(mode=mode, num_devices=num_devices,
                         scheduler="cost-aware", platform="tpu-v5e",
                         use_kernels=True)
        trace, blas, eng = ttrace(), tblas, tengine

        def arr(x, dt):
            return torch.from_numpy(x).to(getattr(torch, dt))
    with policy, trace as tr:
        handles = {}
        for m, k, n, dt, hname in CALLS:
            a = rng.normal(size=(m, k)).astype(np.float32)
            b = rng.normal(size=(k, n)).astype(np.float32)
            if hname and hname not in handles:
                handles[hname] = eng().pin_handle(hname, 4.0 * k * n)
            blas.gemm(arr(a, dt), arr(b, dt), handle=handles.get(hname))
        tickets = [[_ticket(t) for t in d.inflight] for d in eng().devices]
        clocks = [(d.dma_free_s, d.compute_free_s) for d in eng().devices]
        for h in handles.values():
            eng().release_handle(h)
    return [_record(r) for r in tr.records], tickets, clocks


@pytest.mark.parametrize("mode", ["host", "device", "auto"])
@pytest.mark.parametrize("num_devices", [1, 4])
def test_dispatch_records_and_tickets_equal(mode, num_devices):
    ref = _run("ref", mode, num_devices)
    port = _run("port", mode, num_devices)
    assert port[0] == ref[0]          # records, backend names mapped
    assert port[1] == ref[1]          # per-device ticket event clocks
    assert port[2] == ref[2]          # per-device stream clocks
    if mode == "device":
        assert {r[3] for r in port[0]} == {"device", "device-kernel"}
