"""The tensor-, expert- and head-parallel plans of the BLAS seam and the
expert-parallel MoE, on a (data 2, model 4) emulated mesh, against the
reference's unsharded functions (its own sharded runs are multi-device
subprocesses that do not run here, ROADMAP Queue 3).

Bars are the reference tests': ``tests/test_sharding.py``'s TP_NUMERICS
(tp_mode 1e-4, the reduced qwen2-72b forward 3e-2, the MoE 2e-4) and the
SSD's 1e-4 (``tests/test_kernels.py:169``).  The port runs its kernel
policy; on the CPU each plan body's kernels are their plain versions at
the local shape.  Inputs come from a seeded numpy generator or the
reference's own ``init_params`` (converted)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.models import moe as JM
from repro_torch import tree
from repro_torch.configs import get_arch as tget_arch
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import blas
from repro_torch.core.accounting import offload_trace
from repro_torch.core.hero import offload_policy
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as TM
from repro_torch.sharding.spmd import Mesh

SSD_TOL = 1e-4


def _mesh():
    return Mesh((2, 4), ("data", "model"))


def _kernels(**kw):
    return offload_policy(mode="device", use_kernels=True,
                          platform="tpu-v5e", **kw)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


@pytest.mark.parametrize("mode", ["row", "col"])
def test_tp_mode_matches_reference_product(mode):
    rng = np.random.default_rng(5)
    xx = rng.standard_normal((4, 8, 64)).astype(np.float32)
    ww = rng.standard_normal((64, 32)).astype(np.float32)
    want = np.asarray(jnp.asarray(xx) @ jnp.asarray(ww))
    mesh = _mesh()
    with _kernels(), offload_trace() as tr, mesh:
        got = blas.matmul(torch.from_numpy(xx), torch.from_numpy(ww),
                          tp_mode=mode)
    assert np.abs(got.numpy() - want).max() < 1e-4
    assert [r.note for r in tr.records] == ["tp-plan"]
    # row: one psum a device; col: none.
    assert mesh.collective_totals() == (
        {"psum": {"calls": 8, "bytes": 8 * (2 * 8 * 32 * 4)}}
        if mode == "row" else {})


def test_tp_mode_without_a_model_axis_is_the_plain_matmul():
    x = torch.ones(2, 4, 16)
    w = torch.ones(16, 8)
    with offload_trace() as tr, Mesh((2, 1), ("data", "model")):
        y = blas.matmul(x, w, tp_mode="row")
    assert torch.equal(y, x @ w) and tr.records[0].note != "tp-plan"


def _qwen2_cfgs():
    kw = dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=256, num_microbatches=1)
    return (dataclasses.replace(jget_arch("qwen2-72b").reduced(), **kw),
            dataclasses.replace(tget_arch("qwen2-72b").reduced(), **kw))


def test_tp_forward_matches_reference_unsharded():
    """TP_NUMERICS: qwen2-72b reduced, the whole forward under the mesh
    (qkv, wo and mlp planned in each layer) against the reference's
    unsharded forward; then the loss gradients against the reference's."""
    jcfg, tcfg = _qwen2_cfgs()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, size=(4, 16)).astype(np.int32)
    labels = rng.integers(0, 256, size=(4, 16)).astype(np.int32)
    ref, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    mesh = _mesh()
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()}
    with _kernels(), offload_trace() as tr, mesh:
        got, _ = tm.forward(tp, batch)
    assert np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max() \
        < 3e-2
    notes = [r.note for r in tr.records]
    assert notes.count("tp-plan") == 3 * tcfg.num_layers
    assert {r.op for r in tr.records if r.note == "tp-plan"} == \
        {"qkv_project", "gemm", "mlp_block"}

    jgrad = jax.grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)}))(jp)
    jg = params_from_jax(jax.tree.map(np.asarray, jgrad))
    req = tree.tree_map(lambda a: a.detach().clone().requires_grad_(True), tp)
    with _kernels(), mesh:
        tm.loss(req, batch).backward()
    for (path, g), want in zip(tree.leaves_with_paths(req),
                               tree.leaves(jg)):
        scale = max(float(want.abs().max()), 1e-6)
        err = float((g.grad - want).abs().max()) / scale
        assert err < 1e-4, (path, err)


def test_kill_switches_keep_the_blocks_unplanned(monkeypatch):
    _, tcfg = _qwen2_cfgs()
    tm = tbuild(tcfg)
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros(4, 8, dtype=torch.long)
    monkeypatch.setenv("REPRO_DISABLE_TP_MLP", "1")
    monkeypatch.setenv("REPRO_DISABLE_TP_ATTN", "1")
    with _kernels(), offload_trace() as tr, _mesh():
        tm.forward(tp, tokens)
    assert not [r for r in tr.records if r.note == "tp-plan"]


def test_ep_moe_matches_reference_grouped():
    """The expert-parallel shard_map MoE (``moe_dispatch="auto"`` under
    the mesh) against the reference's grouped dispatch with no mesh."""
    kw = dict(capacity_factor=8.0, num_experts=4, experts_per_token=2)
    jcfg = dataclasses.replace(jget_arch("qwen3-moe-30b-a3b").reduced(), **kw)
    tcfg = dataclasses.replace(tget_arch("qwen3-moe-30b-a3b").reduced(), **kw)
    jp = JM.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 16, jcfg.d_model)) * 0.3)
    want, _ = JM.moe_ffn(jp, jnp.asarray(x), jcfg)
    mesh = _mesh()
    with _kernels(), offload_trace() as tr, mesh:
        got, aux = TM.moe_ffn(tp, torch.from_numpy(x.copy()), tcfg)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-4
    assert torch.isfinite(aux)
    # one all-to-all each way a device, and the expert FFN planned.
    assert mesh.collectives["all_to_all"]["calls"] == [2] * 8
    assert [r.op for r in tr.records if r.note == "tp-plan"] == \
        ["moe_expert_ffn"]


def test_ep_moe_gradients_match_the_grouped_path():
    kw = dict(capacity_factor=8.0, num_experts=4, experts_per_token=2)
    tcfg = dataclasses.replace(tget_arch("qwen3-moe-30b-a3b").reduced(), **kw)
    p = TM.init_moe(torch.Generator().manual_seed(0), tcfg, torch.float32,
                    device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, tcfg.d_model)).astype(np.float32) * 0.3)
    grads = []
    for mesh in (None, _mesh()):
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        with _kernels():
            if mesh is None:
                out, _ = TM.moe_ffn(pp, xx, tcfg)
            else:
                with mesh:
                    out, _ = TM.moe_ffn(pp, xx, tcfg)
        (out ** 2).sum().backward()
        grads.append([xx.grad] + [pp[k].grad for k in sorted(pp)
                                  if k != "router"])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_head_sharded_ssm_forward_matches_reference():
    jcfg = jget_arch("mamba2-370m").reduced()
    tcfg = tget_arch("mamba2-370m").reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(4, 32)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    mesh = _mesh()
    with _kernels(), offload_trace() as tr, mesh:
        got, _ = tm.forward(tp, torch.from_numpy(tokens).long())
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=SSD_TOL,
                               atol=SSD_TOL * np.abs(want).max())
    planned = [r.op for r in tr.records if r.note == "tp-plan"]
    assert planned == ["ssd_scan", "gemm"] * tcfg.num_layers


def test_psum_cast_dtype_by_device():
    assert blas.psum_cast_dtype(torch.bfloat16, "cpu") == torch.float32
    assert blas.psum_cast_dtype(torch.float32, "cpu") == torch.float32
    assert blas.psum_cast_dtype(torch.bfloat16, "cuda") == torch.bfloat16


def _meta(*shape):
    return torch.empty(shape, device="meta")


PLANNED = {
    "matmul": lambda: blas.matmul(_meta(4, 8, 64), _meta(64, 32),
                                  tp_mode="row"),
    "mlp_block": lambda: blas.mlp_block(_meta(4, 8, 64), _meta(64, 128),
                                        _meta(128, 64), gate=_meta(64, 128)),
    "qkv_project": lambda: blas.qkv_project(_meta(4, 32, 64), _meta(64, 64),
                                            _meta(64, 32), _meta(64, 32)),
    "moe_expert_ffn": lambda: blas.moe_expert_ffn(
        _meta(8, 4, 16, 64), _meta(8, 64, 96), _meta(8, 64, 96),
        _meta(8, 96, 64)),
    "ssd_scan": lambda: blas.ssd_scan(
        _meta(2, 32, 8, 16), _meta(2, 32, 8), _meta(8), _meta(2, 32, 8, 16),
        _meta(2, 32, 8, 16), _meta(8), chunk=8),
}


@pytest.mark.parametrize("op", sorted(PLANNED))
def test_a_plan_body_off_the_cpu_launches_the_kernel_or_raises(op):
    """A plan body on tensors that are not on the CPU (here the meta
    device; on the card, CUDA tensors) reaches the kernel wrapper, which
    launches or raises: it never takes the plain version.  With the
    kernels off the same body runs the plain version there."""
    mesh = Mesh((2, 4), ("data", "model"), device="meta")
    with _kernels(), mesh, pytest.raises(ValueError, match="no kernel for "
                                         "device meta"):
        PLANNED[op]()
    with offload_policy(mode="device", use_kernels=False), mesh:
        assert PLANNED[op]().device.type == "meta"
