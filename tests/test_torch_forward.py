"""The port's full-sequence forward (``Model.forward``, eager and graph) at
reduced yi-6b against the reference, on weights converted from the
reference's ``init_params``.

Tolerances are ``tests/test_models.py``'s: f32 2e-4, bf16 6e-2.  Both
packages run under their kernel policy (the reference's Pallas kernels in
interpret mode, the port's wrappers on their plain versions, the tensors
lying on the CPU) with ``platform="tpu-v5e"``.

Two departures are mapped, not hidden:
* the reference scans its layers, so its per-layer window is a traced
  scalar that its ``attention`` descriptor cannot hand to the Pallas
  kernel: its forward attention records are on ``device``, the port's
  (a Python int window) on ``device-kernel``;
* the reference traces one block and writes one ``GraphReport`` and one
  record per op with ``count = num_layers``; the port's eager loop writes
  one per layer.  One layer's report is compared directly, and record
  totals count-weighted.
"""

import dataclasses
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.hnp as jhnp
import repro_torch.hnp as thnp
from repro.configs import get_arch as jget_arch
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import engine as jengine
from repro.core.hero import offload_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models import forward as jforward
from repro_torch.configs import get_arch as tget_arch
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import engine as tengine
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.launch.serve import serve_batch as tserve_batch
from repro_torch.models import build_model as tbuild
from repro_torch.models import forward as tforward

ARCH = "yi-6b"
TOL = {"float32": 2e-4, "bfloat16": 6e-2}
RENAME = {"device-pallas": "device-kernel"}


def _cfgs(dtype, mode):
    j = dataclasses.replace(jget_arch(ARCH).reduced(), dtype=dtype,
                            forward_mode=mode)
    t = dataclasses.replace(tget_arch(ARCH).reduced(), dtype=dtype,
                            forward_mode=mode)
    return j, t


def _params(dtype):
    jcfg, _ = _cfgs(dtype, "eager")
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _ref_policy(**kw):
    return jpolicy(mode="device", use_pallas=True, interpret=True,
                   platform="tpu-v5e", **kw)


def _port_policy(**kw):
    return tpolicy(mode="device", use_kernels=True, platform="tpu-v5e", **kw)


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _totals(records, ref=False):
    """Count-weighted record totals per (op, backend); the reference's
    forward attention is mapped to the backend its static-window twin
    takes (see the module docstring)."""
    out = defaultdict(lambda: [0.0, 0.0])
    for r in records:
        backend = RENAME.get(r.backend, r.backend)
        if ref and r.op == "attention" and backend == "device":
            backend = "device-kernel"
        out[(r.op, backend)][0] += r.count
        out[(r.op, backend)][1] += r.count * r.cost.flops
    return dict(out)


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
    jtot, ttot = _totals(jt.records, ref=True), _totals(tt.records)
    assert ttot == jtot
    for op in ("gemm", "qkv_project", "mlp_block", "attention"):
        assert (op, "device-kernel") in ttot
    assert {r.backend for r in jt.records if r.op == "attention"} == {"device"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_eager_and_graph_agree(dtype):
    _, tp = _params(dtype)
    toks = torch.from_numpy(_tokens(_cfgs(dtype, "eager")[1]))
    out = {}
    for mode in ("eager", "graph"):
        with _port_policy(), torch.no_grad():
            out[mode] = tbuild(_cfgs(dtype, mode)[1]).forward(tp, toks)[0]
    torch.testing.assert_close(out["graph"], out["eager"], rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("window", [None, 5])
def test_one_layer_graph_report_matches_reference(window):
    """One block captured as an hnp graph on both packages, with the same
    static window: every NodeReport field (node ids relative to the
    block's first node), and every record, equal."""
    jp, tp = _params("float32")
    jcfg, tcfg = _cfgs("float32", "graph")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (2, 12, jcfg.d_model)), np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
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
        with pol(num_devices=2, scheduler="cost-aware"), trace() as t, \
                fwd.capture_reports() as reps:
            base = base_leaf() + 1
            y, _ = fwd.graph_block(*args, "attn", False, window=window,
                                   rope_theta=jcfg.rope_theta, **kw)
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
    assert trep == jrep and tsum == jsum and trec == jrec
    assert [r[1] for r in trep] == ["rmsnorm_scale", "qkv_project",
                                    "attention", "matmul", "rmsnorm_scale",
                                    "mlp_block"]
    assert trep[3][7] == ("add",)    # the residual rides the wo launch


def test_graph_forward_fuses_and_threads_residency():
    """The graph forward exploits the graph: a fused epilogue in every
    block, strictly fewer staged bytes than eager under mode=device, and
    one captured report per layer (the reference: one per forward)."""
    _, tp = _params("float32")
    _, tcfg = _cfgs("float32", "eager")
    toks = torch.from_numpy(_tokens(tcfg))
    with _port_policy(num_devices=2, scheduler="cost-aware"), torch.no_grad():
        tengine().reset()
        with ttrace() as t_eager:
            tbuild(tcfg).forward(tp, toks)
        tengine().reset()
        with tforward.capture_reports() as reports, ttrace() as t_graph:
            tbuild(dataclasses.replace(tcfg, forward_mode="graph")).forward(
                tp, toks)
    assert len(reports) == tcfg.num_layers
    assert all(sum(1 for r in rep.launches if r.fused) >= 1
               for rep in reports)
    assert t_graph.total_staged_bytes_charged() < \
        t_eager.total_staged_bytes_charged()


def test_graph_decode_steps_match_reference():
    """Graph-mode decode (the dense FFN captured, residual fused) against
    the reference's graph-mode decode: logits and count-weighted records."""
    jp, tp = _params("float32")
    jcfg, tcfg = _cfgs("float32", "graph")
    toks = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, size=(6, 8, 1)).astype(np.int32)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jc, tc = jm.init_decode_cache(8, 8), tm.init_decode_cache(8, 8,
                                                              device="cpu")
    jl, tl = [], []
    with _ref_policy(), jtrace() as jt:
        for s in range(len(toks)):
            logits, jc = jm.decode_step(jp, jc, jnp.asarray(toks[s]),
                                        jnp.int32(s))
            jl.append(np.asarray(logits))
    with _port_policy(), ttrace() as tt, torch.no_grad():
        for s in range(len(toks)):
            logits, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[s]), s)
            tl.append(logits.numpy())
    jl, tl = np.stack(jl), np.stack(tl)
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    assert _totals(tt.records) == _totals(jt.records)


def test_graph_mode_serve_gives_the_eager_tokens():
    _, tp = _params("float32")
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, 200, size=4))) for _ in range(8)]
    out = {}
    for mode in ("eager", "graph"):
        with _port_policy():
            out[mode] = tserve_batch(ARCH, prompts, max_new_tokens=4,
                                     params=tp, device="cpu",
                                     forward_mode=mode).tokens
    assert out["graph"].shape == (8, 4)
    np.testing.assert_array_equal(out["graph"], out["eager"])


def test_cli_forward_mode_graph(capsys):
    from repro_torch.launch.serve import main

    with ttrace() as tt:
        main(["--arch", ARCH, "--device", "cpu", "--prompt-len", "2",
              "--max-new", "2", "--forward-mode", "graph"])
    ops = {r.op for r in tt.records}
    assert "mlp_block" in ops and "tok/s" in capsys.readouterr().out


def test_graph_hybrid_and_moe_blocks_equal_eager():
    """Mamba blocks run in graph mode since the SSM slice
    (tests/test_torch_ssm.py), MoE blocks since the MoE slice and hybrid
    stacks since the jamba slice: a graph MoE block equals its eager twin,
    and a hybrid stack (jamba's Mamba sub-layers beside attention and MoE
    sub-layers) builds, applies in graph mode as in eager mode, and
    decodes."""
    from repro_torch.models import transformer as T

    hybrid = dataclasses.replace(tget_arch("jamba-1.5-large-398b").reduced(),
                                 forward_mode="graph")
    gen = torch.Generator().manual_seed(0)
    stack = T.init_stack(gen, hybrid, torch.float32, device="cpu")
    assert len(stack) == hybrid.num_layers // 8
    assert sorted(stack[0]) == [f"sub{j}" for j in range(8)]
    x = torch.randn(2, 16, hybrid.d_model, generator=gen)
    pos = torch.arange(16).expand(2, 16)
    eager = dataclasses.replace(hybrid, forward_mode="eager")
    with _port_policy(), torch.no_grad():
        got, aux = T.apply_stack(stack, x, hybrid, positions=pos)
        want, want_aux = T.apply_stack(stack, x, eager, positions=pos)
        cache = T.init_decode_cache(hybrid, 2, 4, torch.float32,
                                    device="cpu")
        y, _ = T.decode_stack(stack, cache, x[:, :1], 0, hybrid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    assert float(aux) > 0 and torch.isfinite(y).all()
    moe = tget_arch("qwen3-moe-30b-a3b").reduced()
    p = T.init_stack(gen, moe, torch.float32, device="cpu")[0]
    x = torch.randn(2, 8, moe.d_model, generator=gen)
    pos = torch.arange(8).expand(2, 8)
    with _port_policy(), torch.no_grad():
        got, aux = tforward.graph_block(p, x, moe, "attn", True,
                                        positions=pos, window=1 << 30)
        want, want_aux = T._apply_block(p, x, moe, "attn", True,
                                        positions=pos, window=1 << 30,
                                        rope_theta=moe.rope_theta)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    assert float(aux) > 0
