"""``repro_torch.hnp`` against ``repro.hnp`` on the same numpy inputs.

The contracts of ``tests/test_frontend.py`` (values, fusion, CSE,
batching into ``gemm_batched``, residency and zero readback, the
``offload_region`` shared across forces, the per-graph rollup, pinned
leaves, cross-wave prefetch, unknown names) run through both packages:
the port on the CPU (``device="cpu"``), both under ``platform="tpu-v5e"``,
the reference's kernels in interpret mode.  Values are held to
``test_frontend``'s tolerances (f32 2e-5, bf16 6e-2, scaled by max |want|);
modeled outputs are held equal: every ``NodeReport`` field (node ids
relative to the graph's first node), ``nodes_eliminated``,
``prefetched_bytes`` and the trace records per (op, backend, device).
"""

import dataclasses
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
import repro.hnp as jhnp
import repro_torch.core as tcore
import repro_torch.hnp as thnp
from repro_torch.convert import tensor_from_numpy

RENAME = {"device-pallas": "device-kernel"}
# Records whose shape key is a handle name (region name + node id): the two
# packages number regions and nodes from their own counters.
HANDLE_OPS = {"d2d_copy", "prefetch_stage"}

RNG = np.random.default_rng(11)

BACKENDS = {
    "host": (dict(mode="host"), dict(mode="host")),
    "device": (dict(mode="device"), dict(mode="device")),
    "kernel": (dict(mode="device", use_pallas=True, interpret=True),
               dict(mode="device", use_kernels=True)),
}


def _pkg(name):
    """The names a scenario needs from one package."""
    if name == "ref":
        return types.SimpleNamespace(
            name=name, hnp=jhnp, blas=jcore.blas, engine=jcore.engine,
            trace=jcore.offload_trace,
            arr=lambda a: jnp.asarray(a),
            policy=lambda backend="device", **kw: jcore.offload_policy(
                platform="tpu-v5e", **{**BACKENDS[backend][0], **kw}),
            leaf=lambda: jhnp.array(jnp.zeros(1)).node.id)
    return types.SimpleNamespace(
        name=name, hnp=thnp, blas=tcore.blas, engine=tcore.engine,
        trace=tcore.offload_trace,
        arr=tensor_from_numpy,
        policy=lambda backend="device", **kw: tcore.offload_policy(
            platform="tpu-v5e", **{**BACKENDS[backend][1], **kw}),
        leaf=lambda: thnp.array(torch.zeros(1)).node.id)


REF, PORT = _pkg("ref"), _pkg("port")


@pytest.fixture(autouse=True)
def _clean_engines():
    for p in (REF, PORT):
        p.engine().reset()
    yield
    for p in (REF, PORT):
        p.engine().reset()


def _np(shape, dtype="float32"):
    """Inputs as numpy, already rounded to ``dtype`` (bf16 as ml_dtypes)."""
    return np.asarray(jnp.asarray(RNG.normal(size=shape), dtype))


def _f32(x):
    return np.asarray(x, np.float32)


def _assert_close(got, want, dtype="float32", msg=""):
    tol = 6e-2 if dtype == "bfloat16" else 2e-5
    scale = max(1.0, float(np.max(np.abs(_f32(want)))))
    np.testing.assert_allclose(_f32(got) / scale, _f32(want) / scale,
                               rtol=tol, atol=tol, err_msg=msg)


def _report(region, base):
    return [(r.node_id - base, r.op, RENAME.get(r.backend, r.backend),
             r.device_id, r.resident_fraction, r.staged_in_bytes,
             r.readback_bytes, r.fused, r.batched)
            for r in region.report.launches]


def _records(trace):
    return [(r.op, RENAME.get(r.backend, r.backend), r.device_id,
             "" if r.op in HANDLE_OPS else r.shape_key, r.dtype, r.count,
             r.resident_fraction, r.staged_bytes_charged, r.regions.offload_s,
             r.note)
            for r in trace.records]


def _run(scenario, inputs, **policy):
    """Run ``scenario(pkg, *arrays)`` through both packages under the same
    policy; returns {"ref": ..., "port": ...} of (outputs, region, trace,
    first node id)."""
    out = {}
    for p in (REF, PORT):
        p.engine().reset()
        arrays = [p.arr(a) for a in inputs]
        with p.policy(**policy), p.trace() as t:
            base = p.leaf() + 1
            res, region = scenario(p, *arrays)
        out[p.name] = (res, region, t, base)
    return out


def _assert_same_model(runs):
    (_, jr, jt, jb), (_, tr, tt, tb) = runs["ref"], runs["port"]
    if jr is not None:
        assert _report(tr, tb) == _report(jr, jb)
        assert tr.report.nodes_eliminated == jr.report.nodes_eliminated
        assert tr.report.prefetched_bytes == jr.report.prefetched_bytes
    assert _records(tt) == _records(jt)


# ---------------------------------------------------------------------------
# 1. Parity
# ---------------------------------------------------------------------------

def _mlp_chain(p, x, w1, b, w2):
    with p.hnp.offload_region("chain") as region:
        y = p.hnp.tanh(p.hnp.linear(p.hnp.array(x), w1, b)) @ w2
        return p.hnp.asnumpy(y), region


@settings(max_examples=4, deadline=None)
@given(
    m=st.integers(min_value=8, max_value=48),
    k=st.integers(min_value=8, max_value=40),
    n=st.integers(min_value=8, max_value=32),
)
def test_graph_parity_mlp_chain(m, k, n):
    """tanh(x @ w1 + b) @ w2 matches NumPy and the reference's report on
    every backend x dtype."""
    for dtype in ("float32", "bfloat16"):
        ins = [_np((m, k), dtype), _np((k, n), dtype), _np((n,), dtype),
               _np((n, k), dtype)]
        x, w1, b, w2 = map(_f32, ins)
        want = np.tanh(x @ w1 + b) @ w2
        for backend in BACKENDS:
            runs = _run(_mlp_chain, ins, backend=backend)
            _assert_close(runs["port"][0], want, dtype, f"{backend} {dtype}")
            _assert_same_model(runs)


def test_graph_parity_elementwise_reductions():
    def scenario(p, x, y):
        a, b = p.hnp.array(x), p.hnp.array(y)
        return [p.hnp.asnumpy((a * 2.0 + b / 3.0 - 1.0).sum(axis=1)),
                p.hnp.asnumpy(p.hnp.maximum(a, b).mean()),
                p.hnp.asnumpy(p.hnp.relu(a).T),
                p.hnp.asnumpy(p.hnp.minimum(a, 0.5).max(axis=0,
                                                        keepdims=True)),
                p.hnp.asnumpy(p.hnp.sigmoid(a) * p.hnp.gelu(b)
                              + p.hnp.silu(a) - abs(-b) ** 2),
                p.hnp.asnumpy(p.hnp.exp(a).min() + p.hnp.sqrt(b * b))], None

    x, y = _np((6, 10)), _np((6, 10))
    runs = _run(scenario, [x, y])
    for got, want in zip(runs["port"][0], runs["ref"][0]):
        assert got.shape == np.shape(want)
        _assert_close(got, want)
    _assert_close(runs["port"][0][0], (x * 2.0 + y / 3.0 - 1.0).sum(axis=1))
    _assert_same_model(runs)


def test_registered_ops_appear_in_hnp_for_free():
    """Seam contract: anything in the op registry is graph-capturable by
    name, and the port registers every op the reference's hnp reaches on
    this slice's path."""
    from repro_torch.core import dispatch as dsp

    names = set(dsp.registered_ops())
    assert names == set(thnp.registry_ops())
    assert all(callable(getattr(thnp, name)) for name in names)
    assert {"gemm_batched", "attention", "syrk", "gemv", "dot", "axpy",
            "scal", "nrm2"} <= names

    def scenario(p, sq, v):
        return [p.hnp.asnumpy(p.hnp.syrk(p.hnp.array(sq))),
                p.hnp.asnumpy(p.hnp.axpy(2.0, p.hnp.array(v), p.hnp.array(v))),
                p.hnp.asnumpy(p.hnp.gemv(p.hnp.array(sq), p.hnp.array(v[:16]))),
                p.hnp.asnumpy(p.hnp.dot(p.hnp.array(v), p.hnp.array(v))),
                p.hnp.asnumpy(p.hnp.scal(3.0, p.hnp.array(v))),
                p.hnp.asnumpy(p.hnp.nrm2(p.hnp.array(v)))], None

    sq, v = _np((24, 16)), _np((32,))
    runs = _run(scenario, [sq, v])
    for got, want in zip(runs["port"][0], runs["ref"][0]):
        _assert_close(got, want)
    _assert_close(runs["port"][0][0], sq @ sq.T)
    _assert_close(runs["port"][0][1], 3.0 * v)
    _assert_same_model(runs)


def test_unknown_hnp_attribute_raises():
    with pytest.raises(AttributeError, match="registered ops"):
        thnp.cholesky  # noqa: B018


@pytest.mark.parametrize("opname,args,kwargs", [
    ("gemm", [(12, 8), (12, 10)], dict(transpose_a=True)),
    ("gemm_batched", [(3, 8, 16), (3, 16, 8)], {}),
    ("matmul", [(2, 5, 16), (16, 8)], {}),
    ("mlp_block", [(6, 16), (16, 32), (32, 16)],
     dict(gate="arr:16,32", kind="swiglu")),
    ("qkv_project", [(2, 5, 16), (16, 16), (16, 8), (16, 8)], {}),
    ("attention", [(2, 4, 6, 8), (2, 2, 9, 8), (2, 2, 9, 8)],
     dict(causal=True, window=4)),
    ("decode_attention", [(2, 4, 1, 8), (2, 2, 9, 8), (2, 2, 9, 8)],
     dict(lo=0, hi=5)),
    ("syrk", [(12, 8)], {}),
    ("rmsnorm_scale", [(3, 16), (16,)], dict(eps=1e-5)),
    ("sum", [(4, 6)], dict(axis=1, keepdims=True)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_meta_shape_inference_matches_eval_shape(opname, args, kwargs, dtype):
    """A registry node's shape and dtype come from its host lowering run on
    meta tensors, and equal the reference's ``jax.eval_shape`` result."""
    kw = dict(kwargs)
    pos = [_np(s, dtype) for s in args]
    if opname == "decode_attention":
        pos += [kw.pop("lo"), kw.pop("hi")]
    if "gate" in kw:
        kw["gate"] = _np(tuple(int(d) for d in kw["gate"][4:].split(",")),
                         dtype)
    jn = jhnp.__getattr__(opname)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in pos],
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}).node
    tn = thnp.__getattr__(opname)(
        *[tensor_from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in pos],
        **{k: tensor_from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}).node
    assert tn.shape == jn.shape
    assert str(tn.dtype).removeprefix("torch.") == np.dtype(jn.dtype).name
    assert tn.nbytes == jn.nbytes


# ---------------------------------------------------------------------------
# 2. Fusion and CSE
# ---------------------------------------------------------------------------

def test_elementwise_chain_fuses_into_producer_launch():
    ins = [_np((32, 64)), _np((64, 48)), _np((48,)), _np((48, 16))]

    def scenario(p, x, w1, b, w2):
        with p.hnp.offload_region("fuse") as region:
            h = p.hnp.tanh(p.hnp.linear(p.hnp.array(x), w1, b))
            return p.hnp.asnumpy(h @ w2), region

    runs = _run(scenario, ins)
    got, region, t, _ = runs["port"]
    ops = [r.op for r in t.records]
    assert ops.count("gemm") == 2 and len(
        [o for o in ops if o != "d2d_copy"]) == 2
    assert region.report.launches[0].fused == ("add", "tanh")
    x, w1, b, w2 = map(_f32, ins)
    _assert_close(got, np.tanh(x @ w1 + b) @ w2)
    _assert_same_model(runs)


def test_cse_duplicate_subtree_launches_once():
    ins = [_np((24, 32)), _np((32, 24))]

    def scenario(p, x, w):
        a = p.hnp.array(x)
        y1 = p.hnp.tanh(a @ w)
        y2 = p.hnp.tanh(a @ w)          # distinct nodes, identical structure
        with p.hnp.offload_region("cse") as region:
            got = p.hnp.asnumpy(y1 + y2)
        return (got, p.hnp.asnumpy(y2)), region

    runs = _run(scenario, ins)
    (got, dup), region, t, _ = runs["port"]
    assert [r.op for r in t.records if r.op != "d2d_copy"] == ["gemm"]
    assert region.report.nodes_eliminated >= 2
    x, w = map(_f32, ins)
    _assert_close(got, 2.0 * np.tanh(x @ w))
    _assert_close(dup, np.tanh(x @ w))   # the collapsed duplicate's value
    _assert_same_model(runs)


def test_cse_keeps_distinct_leaves_apart():
    ins = [_np((16, 16)), _np((16, 16)), _np((16, 16))]

    def scenario(p, x1, x2, w):
        return p.hnp.asnumpy(p.hnp.array(x1) @ w + p.hnp.array(x2) @ w), None

    runs = _run(scenario, ins)
    x1, x2, w = map(_f32, ins)
    _assert_close(runs["port"][0], x1 @ w + x2 @ w)
    _assert_same_model(runs)


# ---------------------------------------------------------------------------
# 3. Batching into gemm_batched
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["device", "kernel"])
def test_block_all_batches_across_roots(backend):
    ins = [_np((16, 32)), _np((32, 16)), _np((32, 16))]

    def scenario(p, x, w1, w2):
        a = p.hnp.array(x)
        y1, y2 = a @ w1, a @ w2
        with p.hnp.offload_region("roots") as region:
            p.hnp.block_all(y1, y2)
        return (p.hnp.asnumpy(y1), p.hnp.asnumpy(y2)), region

    runs = _run(scenario, ins, backend=backend)
    (y1, y2), region, t, _ = runs["port"]
    assert [r.op for r in t.records if r.op != "d2d_copy"] == ["gemm_batched"]
    assert {r.backend for r in t.records if r.op == "gemm_batched"} == {
        "device-kernel" if backend == "kernel" else "device"}
    x, w1, w2 = map(_f32, ins)
    _assert_close(y1, x @ w1)
    _assert_close(y2, x @ w2)
    _assert_same_model(runs)


def test_independent_same_shape_gemms_batch_into_one_launch():
    ins = [_np((24, 32)) for _ in range(3)] + [_np((32, 24))]

    def scenario(p, x0, x1, x2, w):
        with p.hnp.offload_region("batch") as region:
            ys = [p.hnp.array(x) @ w for x in (x0, x1, x2)]
            return p.hnp.asnumpy(ys[0] + ys[1] + ys[2]), region

    runs = _run(scenario, ins, backend="kernel")
    got, region, t, _ = runs["port"]
    assert [r.op for r in t.records if r.op != "d2d_copy"] == ["gemm_batched"]
    assert len(region.report.launches) == 3
    assert all(r.batched for r in region.report.launches)
    w = _f32(ins[3])
    _assert_close(got, sum(_f32(x) @ w for x in ins[:3]))
    _assert_same_model(runs)


# ---------------------------------------------------------------------------
# 4. Residency threading
# ---------------------------------------------------------------------------

def _graph_chain(p, x, ws):
    h = p.hnp.tanh(p.hnp.array(x) @ ws[0])
    h = p.hnp.tanh(h @ ws[1])
    return h @ ws[2]


def test_on_device_intermediate_records_zero_host_readback():
    ins = [_np((64, 128)), _np((128, 128)), _np((128, 128)), _np((128, 64))]

    def scenario(p, x, *ws):
        with p.hnp.offload_region("resident") as region:
            return p.hnp.asnumpy(_graph_chain(p, x, ws)), region

    runs = _run(scenario, ins, num_devices=1)
    got, region, t, _ = runs["port"]
    launches = region.report.launches
    assert len(launches) == 3
    assert all(r.readback_bytes == 0.0 for r in launches[:-1])
    assert launches[-1].readback_bytes > 0.0
    recs = [r for r in t.records if r.op != "d2d_copy"]
    assert recs[1].resident_fraction > 0.0 and recs[2].resident_fraction > 0.0
    x, w0, w1, w2 = map(_f32, ins)
    _assert_close(got, np.tanh(np.tanh(x @ w0) @ w1) @ w2)
    _assert_same_model(runs)


def test_fused_graph_beats_eager_chain_on_staging_and_modeled_time():
    ins = [_np((128, 256)), _np((256, 256)), _np((256, 256)), _np((256, 128))]
    eager_traces = {}

    def scenario(p, x, *ws):
        with p.trace() as t_eager:
            h = torch.tanh(p.blas.matmul(x, ws[0])) if p is PORT else \
                jnp.tanh(p.blas.matmul(x, ws[0]))
            tanh = torch.tanh if p is PORT else jnp.tanh
            h = tanh(p.blas.matmul(h, ws[1]))
            eager = p.blas.matmul(h, ws[2])
        eager_traces[p.name] = t_eager
        p.engine().reset()
        with p.hnp.offload_region("chain") as region:
            return (p.hnp.asnumpy(_graph_chain(p, x, ws)), eager), region

    runs = _run(scenario, ins, num_devices=2, scheduler="cost-aware")
    (graph, eager), _, t_graph, _ = runs["port"]
    t_eager = eager_traces["port"]
    _assert_close(graph, eager.numpy())
    assert t_graph.total_staged_bytes_charged() < \
        t_eager.total_staged_bytes_charged()

    def modeled_time(t):
        copy, fork, comp, _ = t.totals()
        return copy + fork + comp + t.total_d2d_s()

    assert modeled_time(t_graph) < modeled_time(t_eager)
    assert t_graph.cluster_makespan_s() <= t_eager.cluster_makespan_s()
    assert modeled_time(t_graph) == modeled_time(runs["ref"][2])
    assert _records(t_eager) == _records(eager_traces["ref"])
    _assert_same_model(runs)


def test_offload_region_shares_residency_across_forces():
    ins = [_np((32, 64)), _np((64, 64)), _np((64, 32))]

    def scenario(p, x, w1, w2):
        with p.hnp.offload_region("shared") as region:
            h = p.hnp.array(x) @ w1
            first = p.hnp.asnumpy(h)          # forces h, stays resident
            second = p.hnp.asnumpy(h @ w2)    # reuses the resident value
        assert p.engine().handles_on(0) == []  # region released its pins
        return (first, second), region

    runs = _run(scenario, ins, num_devices=1)
    (first, second), _, t, _ = runs["port"]
    recs = [r for r in t.records if r.op != "d2d_copy"]
    assert recs[1].resident_fraction > 0.0
    x, w1, w2 = map(_f32, ins)
    _assert_close(first, x @ w1)
    _assert_close(second, (x @ w1) @ w2)
    _assert_same_model(runs)


def test_per_graph_rollup_in_accounting():
    ins = [_np((16, 32)), _np((32, 16))]

    def scenario(p, x, w):
        with p.hnp.offload_region("g1"):
            p.hnp.asnumpy(p.hnp.array(x) @ w)
        p.blas.matmul(x, w)               # eager call outside any graph
        return None, None

    runs = _run(scenario, ins)
    groups = runs["port"][2].by_graph()
    assert set(groups) == {"g1", ""}
    assert groups["g1"].calls == 1
    assert groups["g1"].staged_bytes_charged <= groups["g1"].staged_bytes
    ref_groups = runs["ref"][2].by_graph()
    for name in groups:
        assert groups[name].calls == ref_groups[name].calls
        assert groups[name].staged_bytes_charged == \
            ref_groups[name].staged_bytes_charged
    _assert_same_model(runs)


def test_pinned_leaf_weights_credit_residency():
    ins = [_np((32, 64)), _np((64, 32))]

    def scenario(p, x, w):
        wa = p.hnp.array(w, pin=True)
        return p.hnp.asnumpy(p.hnp.array(x) @ wa), None

    runs = _run(scenario, ins, num_devices=2, scheduler="cost-aware")
    (rec,) = [r for r in runs["port"][2].records if r.op != "d2d_copy"]
    assert rec.resident_fraction > 0.0
    x, w = map(_f32, ins)
    _assert_close(runs["port"][0], x @ w)
    _assert_same_model(runs)


# ---------------------------------------------------------------------------
# 5. Cross-wave prefetch (tests/test_pipelined_staging.py:350-390)
# ---------------------------------------------------------------------------

def test_prefetch_stages_next_wave_operands():
    rng = np.random.default_rng(7)
    ins = [rng.normal(size=(64, 64)).astype(np.float32) for _ in range(3)]

    def scenario(p, x, w0, w1):
        with p.hnp.offload_region("prefetch-chain") as region:
            h = p.hnp.array(x) @ w0
            return p.hnp.asnumpy(h @ w1), region

    runs = _run(scenario, ins, num_devices=2, scheduler="cost-aware",
                prefetch_staging=True)
    out, region, t, _ = runs["port"]
    assert [r for r in t.records if r.op == "prefetch_stage"]
    assert region.report.prefetched_bytes >= ins[2].nbytes
    consumer = region.report.launches[-1]
    assert consumer.resident_fraction > 0.5
    assert consumer.staged_in_bytes < ins[2].nbytes
    np.testing.assert_allclose(out, ins[0] @ ins[1] @ ins[2],
                               rtol=2e-4, atol=2e-4)
    _assert_same_model(runs)


def test_prefetch_off_by_default_no_records():
    ins = [_np((32, 32)), _np((32, 32))]

    def scenario(p, x, w):
        return p.hnp.asnumpy(p.hnp.array(x) @ w @ w), None

    runs = _run(scenario, ins, num_devices=2)
    assert not [r for r in runs["port"][2].records
                if r.op == "prefetch_stage"]
    _assert_same_model(runs)


# ---------------------------------------------------------------------------
# 6. Departures of the port (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

def test_result_dtype_matches_reference_for_float_graphs():
    """For f32 / bf16 operands (and Python scalars, which are weak) node
    dtypes — and so every byte count of a report — agree."""
    cases = [("float32", "float32"), ("bfloat16", "bfloat16"),
             ("bfloat16", "float32"), ("float16", "bfloat16")]
    for da, db in cases:
        ja, jb = (jhnp.array(jnp.ones((2, 3), d)) for d in (da, db))
        ta, tb = (thnp.array(torch.ones(2, 3, dtype=getattr(torch, d)))
                  for d in (da, db))
        for jx, tx in ((ja + jb, ta + tb), (ja * 2.0, ta * 2.0),
                       (2.5 - jb, 2.5 - tb)):
            assert np.dtype(jx.dtype).name == str(tx.dtype)[6:]
            assert jx.nbytes == tx.nbytes


def test_result_dtype_departures_from_reference():
    """Where the packages differ, stated: the reference promotes node
    dtypes with numpy's rule (int32 + float32 -> float64, though its value
    is float32), the port with torch's (float32, as its value is); a numpy
    float64 leaf is float64 in both, and the port also computes in it."""
    ji = jhnp.array(jnp.ones((2, 2), jnp.int32))
    jf = jhnp.array(jnp.ones((2, 2), jnp.float32))
    ti = thnp.array(torch.ones(2, 2, dtype=torch.int32))
    tf = thnp.array(torch.ones(2, 2, dtype=torch.float32))
    assert np.dtype((ji + jf).dtype) == np.float64
    assert (ti + tf).dtype == torch.float32
    assert np.asarray(ti + tf).dtype == np.float32
    f64 = np.ones(3)
    assert jhnp.array(f64).dtype == np.float64
    assert thnp.array(f64, device="cpu").dtype == torch.float64
    assert np.asarray(thnp.array(f64, device="cpu") * 2.0).dtype == np.float64


def test_asnumpy_of_bf16_is_float32_values():
    """numpy has no bfloat16: the port returns the bf16 result's values
    exactly as float32; the reference returns an ml_dtypes bfloat16 array
    with the same values."""
    x, w = _np((8, 16), "bfloat16"), _np((16, 8), "bfloat16")
    want = jhnp.asnumpy(jhnp.array(jnp.asarray(x)) @ jnp.asarray(w))
    got = thnp.asnumpy(thnp.array(tensor_from_numpy(x))
                       @ tensor_from_numpy(w))
    assert want.dtype.name == "bfloat16" and got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_leaves_land_on_the_card_unless_told():
    """hnp.array(numpy) goes to the card unless device="cpu", a numpy
    operand joins its graph's device, and asking for a missing card
    raises."""
    x = np.ones((4, 4), np.float32)
    a = thnp.array(x, device="cpu")
    assert a.node.value.device.type == "cpu"
    y = a @ np.ones((4, 2), np.float32)
    assert all(i.value.device.type == "cpu" for i in y.node.inputs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            thnp.array(x)
        with pytest.raises(RuntimeError, match="cuda"):
            thnp.tanh(x)


def test_validate_and_placement_wait_for_their_slices():
    """Both came with their slices.  ``validate=True`` runs
    ``repro_torch.analysis.graph`` before the graph dispatches (a clean
    graph gives the unvalidated value; tests/test_torch_analysis.py holds
    the rules).  A plan with no sub-launches (here an object without any)
    launches as the unplaced call does, as in the reference
    (tests/test_torch_placement.py holds the fan-out itself)."""
    from repro_torch.analysis.graph import GraphVerificationError
    from repro_torch.core.dispatch import dispatch_placed

    a = torch.ones(8, 8)
    placed, placed_launch = dispatch_placed("gemm", a, a, placement=object())
    assert torch.equal(placed, a @ a)
    assert placed_launch.backend in ("host", "device")
    with thnp.offload_region("v", validate=True):
        got = thnp.asnumpy(thnp.array(a) @ a)
    np.testing.assert_array_equal(got, (a @ a).numpy())
    with thnp.offload_region("v", validate=True):
        y = thnp.array(a) @ a
        y.node.shape = (8, 9)
        with pytest.raises(GraphVerificationError, match="shape-mismatch"):
            thnp.asnumpy(y)
    out, launch = dispatch_placed("gemm", a, a)
    assert launch.backend in ("host", "device") and out.shape == (8, 8)


# ---------------------------------------------------------------------------
# 7. The handle lifecycle the scheduler drives (core/hero.py)
# ---------------------------------------------------------------------------

def _handle_story(p):
    eng = p.engine()
    out = []
    with p.policy(num_devices=3, scheduler="cost-aware"), p.trace() as t:
        h = eng.pin_handle("w", 4096.0, device_id=0)
        out.append(eng.migrate_handle(h, 2))
        out.append(eng.migrate_handle(h, 2))          # already there: no-op
        pf = eng.prefetch_stage("x", 1 << 20, device_id=1)
        with eng.handle_scope():
            eng.pin_handle("tmp", 64.0, device_id=1)
            eng.prefetch_stage("tmp2", 128.0)
            inside = sorted(n for n in ("w", "x", "tmp", "tmp2")
                            if eng.handle(n) is not None)
        after = sorted(n for n in ("w", "x", "tmp", "tmp2")
                       if eng.handle(n) is not None)
        eng.unstage_handle(pf)
        state = (h.device_id, pf.device_id, pf.valid, eng.handle("x") is pf,
                 inside, after)
        with pytest.raises(RuntimeError, match="unstaged"):
            eng.migrate_handle(pf, 0)
        clocks = [(d.dma_free_s, d.compute_free_s, d.completed_launches,
                   [(tk.kind, tk.issue_s, tk.copy_done_s, tk.complete_s)
                    for tk in d.inflight])
                  for d in eng.devices]
    return out, state, clocks, t


def test_handle_lifecycle_matches_reference():
    """migrate_handle (d2d on the destination's DMA stream),
    prefetch_stage, handle_scope and unstage_handle write the reference's
    records and leave the same stream clocks under platform tpu-v5e."""
    j_out, j_state, j_clocks, jt = _handle_story(REF)
    t_out, t_state, t_clocks, tt = _handle_story(PORT)
    assert [dataclasses.astuple(b) for b in t_out] == \
        [dataclasses.astuple(b) for b in j_out]
    assert t_out[0].d2d_s > 0.0 and t_out[1].d2d_s == 0.0
    assert t_state == j_state == (2, -1, False, True,
                                  ["tmp", "tmp2", "w", "x"], ["w", "x"])
    assert t_clocks == j_clocks
    assert _records(tt) == _records(jt)
    assert [r.op for r in tt.records] == [
        "d2d_copy", "prefetch_stage", "prefetch_stage"]


def test_scheduler_spans_match_reference():
    """The graph scheduler's spans (graph:, wave{i}, fuse, gemm-batch, the
    per-dispatch phases and the d2d flows) are the reference's, in order,
    with the same modeled times."""
    from repro.obs.spans import span_trace as jspan_trace
    from repro_torch.obs.spans import span_trace as tspan_trace

    ins = [_np((32, 64)), _np((64, 48)), _np((48,)), _np((32, 40)),
           _np((40, 48)), _np((48, 16))]

    def scenario(p, x, w1, b, c, w2, w3):
        tracer = jspan_trace if p is REF else tspan_trace
        with tracer() as tr, p.hnp.offload_region("spans") as region:
            h1 = p.hnp.tanh(p.hnp.linear(p.hnp.array(x), w1, b))
            h2 = p.hnp.tanh(p.hnp.linear(p.hnp.array(c), w2, b))
            p.hnp.block_all(h1 @ w3, h2 @ w3)
        # handle names carry node ids, which each package counts itself:
        # number them by first appearance
        ids = {}

        def name(s):
            return re.sub(r"n(\d+)", lambda m: "n%d" % ids.setdefault(
                m.group(1), len(ids)), s.name.replace(region.name, "R"))

        return [(name(s), s.cat, s.lane, s.t0_s, s.t1_s, s.kind)
                for s in tr.spans], region

    runs = _run(scenario, ins, num_devices=2, scheduler="cost-aware")
    spans = runs["port"][0]
    names = [n for n, *_ in spans]
    assert {"graph:R", "wave0", "fuse", "gemm-batch"} <= set(names)
    assert spans == runs["ref"][0]
    _assert_same_model(runs)
