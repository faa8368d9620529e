"""The port's MoE path against the reference on the CPU, on the same numpy
inputs: the expert GEMM's plain version, the ``expert_matmul`` and
``moe_expert_ffn`` descriptors, ``moe_ffn`` (grouped and global, with and
without dropped copies), arctic's dense residual, the router's tie order
and the dispatch's stable sort, and the reduced qwen3-moe-30b-a3b forward
(eager and graph), decode steps, ``serve_batch`` and ``serve_cluster``.

Tolerances are the reference's own: the expert GEMM 2e-5
(``tests/test_kernels.py:60-66``), the MoE layer 2e-4
(``tests/test_moe.py:49``), logits those of ``tests/test_torch_forward.py``
and ``tests/test_torch_serve.py``.  Both packages run under their kernel
policy with ``platform="tpu-v5e"``: the reference's Pallas kernels in
interpret mode, the port's wrappers on their plain versions (the tensors
lie on the CPU).
"""

import dataclasses
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import blas as jblas
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import offload_policy as jpolicy
from repro.kernels import ops as jops
from repro.launch.serve import serve_batch as jserve_batch
from repro.launch.serve import serve_cluster as jserve_cluster
from repro.models import build_model as jbuild
from repro.models import moe as JM
from repro.obs import metrics as jmetrics
from repro_torch.configs import get_arch as tget_arch
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import blas as tblas
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.kernels.ref import moe_gemm_ref
from repro_torch.launch.serve import main as tserve_main
from repro_torch.launch.serve import serve_batch as tserve_batch
from repro_torch.launch.serve import serve_cluster as tserve_cluster
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as TM
from repro_torch.obs import metrics as tmetrics

ARCH = "qwen3-moe-30b-a3b"
GEMM_TOL = 2e-5                                # tests/test_kernels.py:64
MOE_TOL = 2e-4                                 # tests/test_moe.py:49
TOL = {"float32": 2e-4, "bfloat16": 6e-2}      # tests/test_models.py
LOGIT_TOL = 1e-4                               # tests/test_torch_serve.py
RENAME = {"device-pallas": "device-kernel"}
BATCH = 8


def _rng(seed=0):
    return np.random.default_rng(seed)


def _ref_policy(**kw):
    return jpolicy(mode="device", use_pallas=True, interpret=True,
                   platform="tpu-v5e", **kw)


def _port_policy(use_kernels=True, **kw):
    return tpolicy(mode="device", use_kernels=use_kernels,
                   platform="tpu-v5e", **kw)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _cfgs(arch=ARCH, **kw):
    return (dataclasses.replace(jget_arch(arch).reduced(), **kw),
            dataclasses.replace(tget_arch(arch).reduced(), **kw))


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return _t(tree)


def _layer(cfg, seed=0, dtype=jnp.float32):
    """One MoE layer's reference params and their port twins."""
    jp = JM.init_moe(jax.random.PRNGKey(seed), cfg, dtype)
    return jp, _tree_to_torch(jp)


def _skew(jp, tp):
    """Steer every token to expert 0 (so a capacity factor of 1.25 drops
    copies): a large positive router column, positive inputs."""
    router = np.asarray(jp["router"]).copy()
    router[:, 0] = np.abs(router[:, 0]) * 4.0
    jp = {**jp, "router": jnp.asarray(router)}
    return jp, {**tp, "router": torch.from_numpy(router)}


def _totals(records, ref=False):
    """Count-weighted totals per (op, backend).  The reference's scanned
    forward has a traced window, so its attention records are on
    ``device`` where the port's int window takes the kernel
    (tests/test_torch_forward.py)."""
    out = defaultdict(lambda: [0.0, 0.0])
    for r in records:
        backend = RENAME.get(r.backend, r.backend)
        if ref and r.op == "attention" and backend == "device":
            backend = "device-kernel"
        out[(r.op, backend)][0] += r.count
        out[(r.op, backend)][1] += r.count * r.cost.flops
    return dict(out)


# ---------------------------------------------------------------------------
# The expert GEMM and the grouped expert FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,c,d,f", [(4, 32, 48, 56), (8, 16, 64, 96),
                                     (3, 8, 40, 24)])
def test_moe_gemm_ref_matches_reference_kernel(e, c, d, f):
    x = _rng(1).normal(size=(e, c, d)).astype(np.float32)
    w = _rng(2).normal(size=(e, d, f)).astype(np.float32)
    want = np.asarray(jops.moe_gemm(jnp.asarray(x), jnp.asarray(w),
                                    interpret=True))
    got = moe_gemm_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=GEMM_TOL,
                               atol=GEMM_TOL)


def test_moe_rows_lower_to_the_batched_gemm():
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels.gemm import gemm_batched

    assert tops.kernel_lowering("moe_gemm") is gemm_batched
    assert tops.kernel_lowering("moe_expert_ffn") is gemm_batched
    assert set(jops.PALLAS_LOWERINGS) == set(tops.KERNEL_LOWERINGS)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_expert_descriptors_match_reference(use_kernels):
    """``expert_matmul`` and ``moe_expert_ffn`` on (E, G, C, d) operands:
    values at 2e-5 and the same records (op, backend) on both backends."""
    e, g, c, d, f = 4, 2, 8, 32, 24
    x = (_rng(3).normal(size=(e, g, c, d)) * 0.5).astype(np.float32)
    ws = [(_rng(4 + i).normal(size=s) * 0.2).astype(np.float32)
          for i, s in enumerate([(e, d, f), (e, d, f), (e, f, d)])]
    jpol = (_ref_policy() if use_kernels
            else jpolicy(mode="device", platform="tpu-v5e"))
    with jpol, jtrace() as jt:
        jm = jblas.expert_matmul(jnp.asarray(x), jnp.asarray(ws[0]))
        jf = jblas.moe_expert_ffn(jnp.asarray(x), *map(jnp.asarray, ws))
    with _port_policy(use_kernels), ttrace() as tt:
        tm = tblas.expert_matmul(torch.from_numpy(x), torch.from_numpy(ws[0]))
        tf = tblas.moe_expert_ffn(torch.from_numpy(x),
                                  *map(torch.from_numpy, ws))
    assert tm.shape == (e, g, c, f) and tf.shape == x.shape
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=GEMM_TOL,
                               atol=GEMM_TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=GEMM_TOL,
                               atol=GEMM_TOL)
    assert _totals(tt.records) == _totals(jt.records)
    backend = "device-kernel" if use_kernels else "device"
    assert {(r.op, r.backend) for r in tt.records} == {
        ("moe_gemm", backend), ("moe_expert_ffn", backend)}


def test_moe_expert_ffn_kernel_path_runs_the_batched_gemm_three_times(
        monkeypatch):
    """The kernel adapter launches the ``moe_expert_ffn`` lowering three
    times (gate, up, down) and calls no torch matmul itself."""
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels.gemm import gemm_batched

    calls = []

    def counted(a, b, **kw):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return gemm_batched(a, b, **kw)

    monkeypatch.setitem(tops.KERNEL_LOWERINGS, "moe_expert_ffn", counted)
    for name in ("bmm", "matmul", "einsum"):
        monkeypatch.setattr(torch, name, _forbidden(name), raising=True)
    x = torch.randn(4, 2, 8, 32)
    wg, wu = torch.randn(4, 32, 24), torch.randn(4, 32, 24)
    wd = torch.randn(4, 24, 32)
    # (the plain version inside the wrapper is the CPU's stand-in for the
    # kernel; it is not the adapter)
    monkeypatch.setattr("repro_torch.kernels.gemm.gemm_batched_ref",
                        lambda a, b, out_dtype=None: torch.zeros(
                            a.shape[0], a.shape[1], b.shape[2],
                            dtype=out_dtype))
    with _port_policy():
        out = tblas.moe_expert_ffn(x, wg, wu, wd)
    assert out.shape == x.shape
    assert calls == [((4, 16, 32), (4, 32, 24))] * 2 + [((4, 16, 24),
                                                         (4, 24, 32))]


def _forbidden(name):
    def fn(*a, **k):
        raise AssertionError(f"torch.{name} on the kernel path")
    return fn


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

def _moe_pair(jcfg, tcfg, jp, tp, x):
    jm, tm = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    with _ref_policy(), jmetrics.collect(jm):
        jo, ja = JM.moe_ffn(jp, jnp.asarray(x), jcfg)
    jtr = JM.last_moe_step()
    with _port_policy(), tmetrics.collect(tm), torch.no_grad():
        to, ta = TM.moe_ffn(tp, torch.from_numpy(x), tcfg)
    ttr = TM.last_moe_step()
    return (jo, ja, jtr, jm.rollup()), (to, ta, ttr, tm.rollup())


@pytest.mark.parametrize("mode", ["grouped", "global", "auto"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_moe_ffn_matches_reference(mode, capacity_factor):
    """Values at 2e-4; the step record and the counters equal.  At the
    default capacity factor the router is steered so copies drop."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor, moe_dispatch=mode)
    jp, tp = _layer(jcfg)
    x = (_rng(5).normal(size=(4, 16, jcfg.d_model)) * 0.3).astype(np.float32)
    if capacity_factor < 2:
        jp, tp = _skew(jp, tp)
        x = np.abs(x)
    (jo, ja, jtr, jroll), (to, ta, ttr, troll) = _moe_pair(jcfg, tcfg, jp,
                                                           tp, x)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=MOE_TOL,
                               atol=MOE_TOL)
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)
    assert dataclasses.astuple(ttr) == dataclasses.astuple(jtr)
    assert troll == jroll
    assert (ttr.tokens_dropped > 0) == (capacity_factor < 2)


def test_moe_ffn_bf16_matches_reference():
    jcfg, tcfg = _cfgs(capacity_factor=1.25)
    jp, tp = _layer(jcfg, dtype=jnp.bfloat16)
    x = (_rng(6).normal(size=(2, 16, jcfg.d_model)) * 0.3).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    jo, _ = JM.moe_ffn(jp, jnp.asarray(xb), jcfg)
    to, _ = TM.moe_ffn(tp, tensor_from_numpy(xb), tcfg)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


def test_dense_residual_arctic():
    """tests/test_moe.py:86: arctic's dense FFN adds to the MoE output; the
    port's sum equals the reference's."""
    jcfg, tcfg = _cfgs("arctic-480b", capacity_factor=8.0)
    jp, tp = _layer(jcfg)
    assert "dense" in tp and set(tp["dense"]) == set(jp["dense"])
    x = (_rng(7).normal(size=(1, 8, jcfg.d_model)) * 0.3).astype(np.float32)
    (jo, _, _, _), (to, _, _, _) = _moe_pair(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=MOE_TOL,
                               atol=MOE_TOL)
    tp_no = {k: v for k, v in tp.items() if k != "dense"}
    no_res, _ = TM.moe_ffn(tp_no, torch.from_numpy(x),
                           dataclasses.replace(tcfg, dense_residual=False))
    assert (to - no_res).abs().max().item() > 1e-6


def test_top_k_ties_go_to_the_lower_expert():
    """Exact ties in the router's probabilities resolve as ``lax.top_k``
    orders them: the lower expert index first."""
    logits = np.array([[1.0, 3.0, 3.0, 3.0, 0.0, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, 5.0, 1.0, 5.0, 1.0, 0.0]], np.float32)
    for k in (1, 2, 3, 4):
        jg, ji = JM._top_k_gates(jnp.asarray(logits), k)
        tg, ti = TM._top_k_gates(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("grouped", [True, False])
def test_capacity_drops_the_later_tokens(grouped):
    """Every copy routed to expert 1 past its capacity: the stable sort
    keeps the earliest tokens, as the reference's does; the output and the
    books equal the reference's."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    jp, tp = _layer(jcfg, seed=2)
    t, d, k = 32, jcfg.d_model, jcfg.experts_per_token
    x = (_rng(8).normal(size=(t, d)) * 0.3).astype(np.float32)
    idx = np.stack([np.ones(t, np.int32), np.arange(t, dtype=np.int32)
                    % 4], axis=1)
    idx[:, 1] = np.where(idx[:, 1] == 1, 3, idx[:, 1])
    gates = _rng(9).uniform(0.2, 0.8, size=(t, k)).astype(np.float32)
    jfn, tfn = ((JM._moe_grouped, TM._moe_grouped) if grouped
                else (JM._moe_global, TM._moe_global))
    want = jfn(jp, jnp.asarray(x), jnp.asarray(gates), jnp.asarray(idx), jcfg)
    jtr = JM.last_moe_step()
    got = tfn(tp, torch.from_numpy(x), torch.from_numpy(gates),
              torch.from_numpy(idx.astype(np.int64)), tcfg)
    ttr = TM.last_moe_step()
    assert ttr.dropped[1] > 0
    assert dataclasses.astuple(ttr) == dataclasses.astuple(jtr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)
    # The earliest tokens keep expert 1: a dropped copy contributes 0, so a
    # kept token's output moves when expert 1's weights move.
    bumped = {**tp, "we_down": tp["we_down"].clone()}
    bumped["we_down"][1] += 1.0
    moved = (tfn(bumped, torch.from_numpy(x), torch.from_numpy(gates),
                 torch.from_numpy(idx.astype(np.int64)), tcfg) - got
             ).abs().amax(dim=-1) > 0
    kept = moved.nonzero().flatten().tolist()
    g = TM._dispatch_groups(t, tcfg) if grouped else 1
    tg, cap = t // g, ttr.capacity
    assert kept == [grp * tg + i for grp in range(g) for i in range(cap)]


def test_unpack_is_the_same_on_every_run():
    """bf16 contributions summed in a fixed order: two runs equal bit for
    bit, and equal the reference's scatter-add in sorted-copy order."""
    jcfg, tcfg = _cfgs(capacity_factor=8.0)
    jp, tp = _layer(jcfg, dtype=jnp.bfloat16)
    x = (_rng(10).normal(size=(2, 16, jcfg.d_model))).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    a, _ = TM.moe_ffn(tp, tensor_from_numpy(xb), tcfg)
    b, _ = TM.moe_ffn(tp, tensor_from_numpy(xb), tcfg)
    assert torch.equal(a, b)


def test_expert_capacity_matches_reference():
    jcfg, tcfg = _cfgs()
    full_j, full_t = jget_arch(ARCH), tget_arch(ARCH)
    for t in (1, 8, 64, 1000, 4096):
        assert TM.expert_capacity(t, tcfg) == JM.expert_capacity(t, jcfg)
        assert TM.expert_capacity(t, full_t) == JM.expert_capacity(t, full_j)
        assert TM._dispatch_groups(t, full_t) == JM._dispatch_groups(t, full_j)
    # The published config's decode step (8 tokens: 8 groups of 1) and a
    # 2 x 512 forward (16 groups of 64) both give 8 slots an expert a group.
    assert TM._dispatch_groups(8, full_t) == 8
    assert TM.expert_capacity(1, full_t) == 8
    assert TM._dispatch_groups(1024, full_t) == 16
    assert TM.expert_capacity(64, full_t) == 8


def test_moe_ffn_rejects_an_unknown_mode():
    _, tcfg = _cfgs(moe_dispatch="shard")
    jcfg, _ = _cfgs()
    _, tp = _layer(jcfg)
    with pytest.raises(ValueError, match="moe_dispatch"):
        TM.moe_ffn(tp, torch.zeros(1, 8, tcfg.d_model), tcfg)


# ---------------------------------------------------------------------------
# The model: forward, decode, serving
# ---------------------------------------------------------------------------

def _params(arch=ARCH, dtype="float32", seed=0):
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), dtype=dtype)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_carries_moe_params(dtype):
    """Router (f32, (d, E)), expert stacks (E, d, f) / (E, f, d) and
    arctic's dense FFN cross per layer, bf16 bit for bit."""
    for arch in (ARCH, "arctic-480b"):
        jp, tp = _params(arch, dtype)
        cfg = jget_arch(arch).reduced()
        e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        assert len(tp["stack"]) == cfg.num_layers
        for i, layer in enumerate(tp["stack"]):
            ffn = layer["ffn"]
            assert ffn["router"].dtype == torch.float32
            assert tuple(ffn["router"].shape) == (d, e)
            assert tuple(ffn["we_gate"].shape) == (e, d, f)
            assert tuple(ffn["we_down"].shape) == (e, f, d)
            assert ffn["we_up"].dtype == getattr(torch, dtype)
            assert ("dense" in ffn) == cfg.dense_residual
            for name in ("we_gate", "we_up", "we_down"):
                want = np.asarray(jp["stack"]["ffn"][name][i])
                bits = (np.int16, torch.int16) if dtype == "bfloat16" else (
                    np.int32, torch.int32)
                assert np.array_equal(ffn[name].view(bits[1]).numpy(),
                                      want.view(bits[0]))


@pytest.mark.parametrize("mode", ["eager", "graph"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(mode, dtype):
    jp, tp = _params(dtype=dtype)
    jcfg, tcfg = _cfgs(dtype=dtype, forward_mode=mode)
    toks = _rng(0).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    with _ref_policy(), jtrace() as jt:
        jl, jaux = jbuild(jcfg).forward(jp, {"tokens": jnp.asarray(toks)})
    with _port_policy(), ttrace() as tt, torch.no_grad():
        tl, taux = tbuild(tcfg).forward(tp, torch.from_numpy(toks))
    jl = np.asarray(jl, np.float32)
    assert tl.shape == jl.shape and tl.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=TOL[dtype],
                               atol=TOL[dtype])
    # The aux loss follows the router's inputs: bf16 hidden states that
    # round apart move it at the bf16 bar.
    assert float(taux) == pytest.approx(
        float(jaux), rel=1e-5 if dtype == "float32" else TOL[dtype])
    assert float(taux) >= jcfg.num_layers * (1.0 - 1e-5)
    assert _totals(tt.records) == _totals(jt.records, ref=True)
    for op in ("gemm", "qkv_project", "attention", "moe_expert_ffn"):
        assert (op, "device-kernel") in _totals(tt.records)


def test_forward_eager_and_graph_agree():
    _, tp = _params()
    toks = torch.from_numpy(_rng(1).integers(0, 256, size=(2, 16)))
    out = {}
    for mode in ("eager", "graph"):
        _, tcfg = _cfgs(forward_mode=mode)
        with _port_policy(), torch.no_grad():
            out[mode] = tbuild(tcfg).forward(tp, toks)
    np.testing.assert_allclose(out["graph"][0].numpy(),
                               out["eager"][0].numpy(), rtol=1e-6, atol=1e-6)
    assert float(out["graph"][1]) == pytest.approx(float(out["eager"][1]),
                                                   rel=1e-6)


def test_eager_layer_loop_keeps_the_moe_books_per_layer():
    """A deliberate departure: the port's eager loop writes one
    ``MoEStepTrace`` per MoE layer of a forward, each counting every
    routed copy (the reference's jitted scan writes none)."""
    _, tp = _params()
    _, tcfg = _cfgs()
    toks = torch.from_numpy(_rng(2).integers(0, 256, size=(2, 16)))
    TM._MOE_STEPS.clear()
    with _port_policy(), torch.no_grad():
        tbuild(tcfg).forward(tp, toks)
    steps = TM.moe_step_trace()
    assert len(steps) == tcfg.num_layers
    assert all(s.tokens_routed == 2 * 16 * tcfg.experts_per_token
               for s in steps)


def test_decode_steps_match_reference():
    jp, tp = _params()
    jcfg, tcfg = _cfgs()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    steps = 10
    toks = _rng(3).integers(1, jcfg.vocab_size,
                            size=(steps, BATCH, 1)).astype(np.int32)
    jc = jm.init_decode_cache(BATCH, 16)
    tc = tm.init_decode_cache(BATCH, 16, device="cpu")
    jl, tl = [], []
    with _ref_policy(), jtrace() as jt:
        for s in range(steps):
            logits, jc = jm.decode_step(jp, jc, jnp.asarray(toks[s]),
                                        jnp.int32(s))
            jl.append(np.asarray(logits))
    with _port_policy(), ttrace() as tt, torch.no_grad():
        for s in range(steps):
            logits, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[s]), s)
            tl.append(logits.numpy())
    jl, tl = np.stack(jl), np.stack(tl)
    assert np.abs(tl - jl).max() <= LOGIT_TOL * np.abs(jl).max()
    jtot, ttot = _totals(jt.records), _totals(tt.records)
    assert ttot == jtot
    for op in ("gemm", "qkv_project", "attention", "moe_expert_ffn"):
        assert (op, "device-kernel") in ttot


def test_graph_decode_runs_the_moe_eagerly():
    """In graph mode an MoE decode step runs ``moe_ffn`` eagerly (no FFN
    graph is captured), so its logits equal eager mode's bit for bit."""
    from repro_torch.models import forward as tforward

    _, tp = _params()
    toks = torch.from_numpy(_rng(4).integers(1, 256, size=(BATCH, 1)))
    out = {}
    for mode in ("eager", "graph"):
        _, tcfg = _cfgs(forward_mode=mode)
        m = tbuild(tcfg)
        cache = m.init_decode_cache(BATCH, 8, device="cpu")
        with _port_policy(), torch.no_grad(), \
                tforward.capture_reports() as reports:
            out[mode], _ = m.decode_step(tp, cache, toks, 0)
        assert reports == []
    assert torch.equal(out["eager"], out["graph"])


class _BlockingJax:
    """``jax`` as the reference's serve module sees it, with every jitted
    step waited for (its ``_run_prefill`` races its token buffer otherwise:
    ROADMAP Queue 3)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kwargs):
        step = jax.jit(fn, **kwargs)
        return lambda *args: jax.block_until_ready(step(*args))


@pytest.mark.parametrize("arch", [ARCH, "arctic-480b"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_batch_greedy_tokens_match_reference(arch, use_kernels,
                                                   monkeypatch):
    import repro.launch.serve

    monkeypatch.setattr(repro.launch.serve, "jax", _BlockingJax())
    jp, tp = _params(arch)
    rng = _rng(5)
    prompts = [list(map(int, rng.integers(1, 200, size=4)))
               for _ in range(BATCH)]
    with _ref_policy():
        want = jserve_batch(arch, prompts, smoke=True, max_new_tokens=4,
                            params=jp)
    with _port_policy(use_kernels):
        got = tserve_batch(arch, prompts, smoke=True, max_new_tokens=4,
                           params=tp, device="cpu")
    assert got.tokens.shape == (BATCH, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("mode", ["eager", "graph"])
def test_serve_batch_graph_mode_gives_the_eager_tokens(mode):
    _, tp = _params()
    prompts = [[int(t) for t in _rng(6).integers(1, 200, size=3)]
               for _ in range(BATCH)]
    with _port_policy():
        got = tserve_batch(ARCH, prompts, max_new_tokens=3, params=tp,
                           device="cpu", forward_mode=mode)
        want = tserve_batch(ARCH, prompts, max_new_tokens=3, params=tp,
                            device="cpu")
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", [ARCH, "arctic-480b"])
def test_serve_cluster_matches_reference(arch, monkeypatch):
    """``serve_cluster`` on a reduced MoE arch: placements, modeled seconds
    and tokens equal the reference's (round-robin, 2 batches over 2
    devices)."""
    import repro.launch.serve

    monkeypatch.setattr(repro.launch.serve, "jax", _BlockingJax())
    jp, tp = _params(arch, seed=3)
    rng = _rng(3)
    batches = [[list(map(int, rng.integers(1, 200, size=3 + (b + i) % 3)))
                for i in range(BATCH)] for b in range(2)]
    kw = dict(smoke=True, max_new_tokens=3, cache_len=16, seed=3)
    pol = dict(mode="device", platform="tpu-v5e", num_devices=2,
               scheduler="round-robin")
    with jpolicy(**pol, use_pallas=True, interpret=True):
        want = jserve_cluster(arch, batches, **kw)   # weights from seed 3
    with tpolicy(**pol, use_kernels=True):
        got = tserve_cluster(arch, batches, params=tp, device="cpu", **kw)
    assert got.placements == want.placements
    assert got.prefill_placements == want.prefill_placements
    assert got.makespan_s == pytest.approx(want.makespan_s, rel=1e-12)
    for g, w in zip(got.results, want.results, strict=True):
        np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.parametrize("arch", [ARCH, "arctic-480b"])
def test_cli_serves_moe_on_the_kernels(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <moe> --device cpu``: the
    reduced config, every GEMM-family, attention and expert-FFN record on
    ``device-kernel``."""
    with ttrace() as tt:
        tserve_main(["--arch", arch, "--prompt-len", "3", "--max-new", "2",
                     "--device", "cpu"])
    backends = defaultdict(set)
    e = tget_arch(arch).reduced().num_experts
    for r in tt.records:
        # The reduced router's n (4 experts) is under the kernel gate's 8.
        router = r.op == "gemm" and r.shape_key.split(";")[1].endswith(
            f"x{e}:float32")
        backends["router" if router else r.op].add(r.backend)
    for op in ("qkv_project", "attention", "moe_expert_ffn", "gemm"):
        assert backends[op] == {"device-kernel"}, (op, backends[op])
    assert backends["router"] == {"device"}
    assert "tok/s" in capsys.readouterr().out
