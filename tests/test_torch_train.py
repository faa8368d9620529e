"""The port's training path against the reference: ``Model.loss``, the
train step (microbatch split, accumulation, the optimizer's update), the
kernels' autograd Functions, the train CLI and the restart loop.

Same numpy inputs, reference weights carried across with
``params_from_jax``'s layer split, reduced f32 configs, the reference's
tolerances (f32 2e-5).  The reference runs its default policy (plain ops,
gradients by tracing).  The port runs its plain path and, on the CPU, its
kernel path: every launch of the forward inside an autograd Function whose
forward is the kernel's plain version, so each Function's backward runs
here.

Two comparisons are not elementwise at 2e-5, and why:
* the parameters after a step: the first AdamW step moves a weight by
  about lr·sign(g), so a gradient of 1e-9 whose sign differs between the
  two packages moves it by 2·lr.  The optimizer is held instead on *shared*
  gradients (the reference's, fed to both), within 1e-6;
* the train step's records: the reference traces its microbatch body once
  and scales the records by the microbatch count; the port's eager loop
  records every microbatch.  Count-weighted totals are compared.
"""

import dataclasses
import functools
import pathlib
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import offload_policy as jpolicy
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import tree
from repro_torch.analysis.lint import RULES, FileView, run_lint
from repro_torch.configs import get_arch as tget_arch
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import blas
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.kernels import autograd as kgrad
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train as ttrain
from repro_torch.models import build_model as tbuild
from repro_torch.models.model import cross_entropy as tcross_entropy
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.optim import warmup_cosine as twarmup_cosine
from repro_torch.runtime import WorkerFailure, run_with_recovery

ROOT = pathlib.Path(__file__).resolve().parents[1]
PARITY_ARCHS = ("yi-6b", "mamba2-370m", "qwen3-moe-30b-a3b")
ARCHS = [a for a in list_archs() if a != "paper-gemm"]
TOL = 2e-5
OPT_TOL = 1e-6
OPTS = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _cfgs(arch, nmb=1, **kw):
    j = dataclasses.replace(jget_arch(arch).reduced(), num_microbatches=nmb,
                            **kw)
    t = dataclasses.replace(tget_arch(arch).reduced(), num_microbatches=nmb,
                            **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def _params_np(arch):
    """The reference's reduced init as numpy (a read-only cache: callers
    convert, never mutate)."""
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jbuild(jcfg).init_params(
        jax.random.PRNGKey(0)))


def _jparams(arch):
    return jax.tree.map(jnp.asarray, _params_np(arch))


def _tparams(arch):
    return params_from_jax(_params_np(arch))


def _batch_np(cfg, b=4, s=16, seed=0):
    """Inputs and labels for ``cfg`` from numpy: tokens (or frame
    embeddings), M-RoPE's three position streams where the arch has them."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    else:
        batch["embeds"] = (rng.standard_normal((b, s, cfg.d_model)) * 0.1
                           ).astype(np.float32)
    if cfg.mrope:
        batch["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (3, b, s)).copy()
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np_tree(t):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), t)


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(arch, nmb):
    """The reference train step's loss and gradients before its update:
    its microbatch split, ``value_and_grad`` of ``Model.loss`` per
    microbatch, the sum in ``accum_dtype`` and the mean (the body of
    ``src/repro/launch/steps.py::make_train_step``)."""
    jcfg, _ = _cfgs(arch, nmb)
    model = jbuild(jcfg)
    batch = _jbatch(_batch_np(jcfg))
    vg = jax.jit(jax.value_and_grad(model.loss))
    params = _jparams(arch)
    if nmb == 1:
        loss, grads = vg(params, batch)
    else:
        mbs = jsteps._split_microbatches(batch, nmb)
        acc, losses = None, []
        for j in range(nmb):
            l, g = vg(params, {k: v[j] for k, v in mbs.items()})
            g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
            losses.append(l)
        grads = jax.tree.map(lambda g: g / nmb, acc)
        loss = jnp.mean(jnp.stack(losses))
    return float(loss), _np_tree(grads)


@functools.lru_cache(maxsize=None)
def _ref_step_loss(arch, nmb):
    jcfg, _ = _cfgs(arch, nmb)
    model = jbuild(jcfg)
    opts = jsteps.TrainOptions(**OPTS)
    params = _jparams(arch)
    opt_state, _ = jsteps.init_train_state(model, params, opts)
    step = jax.jit(jsteps.make_train_step(model, opts))
    _, _, _, m = step(params, opt_state, None, _jbatch(_batch_np(jcfg)))
    return float(m["loss"])


def _assert_grads_close(tgrads, jgrads_np, tol=TOL):
    want = tree.leaves(params_from_jax(jgrads_np))
    got = tree.leaves(tgrads)
    assert len(got) == len(want)
    for (path, g), w in zip(tree.leaves_with_paths(tgrads), want):
        assert g.shape == w.shape, path
        scale = float(w.abs().max()) or 1.0
        err = float((g.float() - w).abs().max())
        assert err <= tol * scale, (path, err, scale)


# ---------------------------------------------------------------------------
# cross entropy and Model.loss
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_reference():
    from repro.models.model import cross_entropy as jcross_entropy

    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 5, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (2, 5)).astype(np.int32)
    want = float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = tcross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= TOL * abs(want)
    # bf16 logits are widened to fp32 before the log-sum-exp
    got16 = tcross_entropy(torch.from_numpy(logits).bfloat16(),
                           torch.from_numpy(labels))
    assert got16.dtype == torch.float32


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_model_loss_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    batch = _batch_np(jcfg)
    want = float(jbuild(jcfg).loss(_jparams(arch), _jbatch(batch)))
    with torch.no_grad():
        got = tbuild(tcfg).loss(_tparams(arch), _tbatch(batch))
    assert abs(float(got) - want) <= TOL * abs(want)


# ---------------------------------------------------------------------------
# the train step: loss and gradients, the optimizer on shared gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("nmb", [1, 2])
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_train_step_loss_and_grads_match_reference(arch, nmb, kernels):
    _, tcfg = _cfgs(arch, nmb)
    model = tbuild(tcfg)
    batch = _tbatch(_batch_np(tcfg))
    params = _tparams(arch)
    opts = tsteps.TrainOptions(**OPTS)
    opt_state, err = tsteps.init_train_state(model, params, opts)
    with tpolicy(mode="device", use_kernels=kernels):
        _, _, _, metrics = tsteps.make_train_step(model, opts)(
            params, opt_state, err, batch)
        loss, grads = tsteps._loss_and_grads(model, params, batch)
    want_loss, want_grads = _ref_loss_and_grads(arch, nmb)
    assert abs(float(metrics["loss"]) - _ref_step_loss(arch, nmb)) \
        <= TOL * abs(want_loss)
    assert float(loss) == float(metrics["loss"])
    assert abs(float(loss) - want_loss) <= TOL * abs(want_loss)
    accum = torch.float32 if nmb > 1 else getattr(torch, tcfg.dtype)
    assert {g.dtype for g in tree.leaves(grads)} == {accum}
    _assert_grads_close(grads, want_grads)


def _ref_update(arch, optimizer, grads_np):
    jcfg, _ = _cfgs(arch, optimizer=optimizer)
    init, update = jmake_optimizer(jcfg, jwarmup_cosine(**_sched_kw()))
    params = _jparams(arch)
    state = init(params)
    grads = jax.tree.map(jnp.asarray, grads_np)
    new_p, new_s = jax.jit(update)(grads, state, params)
    return new_p, new_s


def _sched_kw():
    return dict(peak_lr=OPTS["peak_lr"], warmup_steps=OPTS["warmup_steps"],
                total_steps=OPTS["total_steps"])


def _moments_np(state_tree, optimizer):
    """A moment tree as fp32 numpy leaves (the 8-bit ones dequantized)."""
    if optimizer == "adamw":
        return _np_tree(state_tree)
    from repro.optim.adamw import QTensor, _dequantize

    return jax.tree.map(
        lambda qt: np.asarray(_dequantize(qt, qt.q.shape), np.float32),
        state_tree, is_leaf=lambda x: isinstance(x, QTensor))


def _tmoments(state_tree, optimizer):
    if optimizer == "adamw":
        return state_tree
    from repro_torch.optim.adamw import QTensor, _dequantize

    return tree.tree_map(lambda qt: _dequantize(qt, qt.q.shape), state_tree,
                         is_leaf=lambda x: isinstance(x, QTensor))


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_optimizer_on_shared_grads_matches_reference(arch, optimizer):
    """Both optimizers fed the reference's gradients (2 microbatches: fp32)
    give params, mu and nu within 1e-6.  The 8-bit moments are compared
    dequantized, each element within 1e-6 plus one int8 step of its block:
    moments that agree within 1e-7 may round to neighbouring levels."""
    _, grads_np = _ref_loss_and_grads(arch, 2)
    jp, js = _ref_update(arch, optimizer, grads_np)
    _, tcfg = _cfgs(arch, optimizer=optimizer)
    init, update = tmake_optimizer(tcfg, twarmup_cosine(**_sched_kw()))
    params = _tparams(arch)
    state = init(params)
    tp, ts = update(params_from_jax(grads_np), state, params)
    assert int(ts.step) == int(js.step) == 1
    pairs = [(tp, _np_tree(jp)),
             (_tmoments(ts.mu, optimizer), _moments_np(js.mu, optimizer)),
             (_tmoments(ts.nu, optimizer), _moments_np(js.nu, optimizer))]
    for got_tree, want_np in pairs:
        want = tree.leaves(params_from_jax(want_np))
        got = tree.leaves(got_tree)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            atol = OPT_TOL
            if optimizer == "adamw8bit" and got_tree is not tp:
                atol = OPT_TOL + _int8_step(w)
            diff = (g.float() - w).abs()
            assert bool((diff <= atol + OPT_TOL * w.abs()).all()), \
                float((diff - atol).max())


def _int8_step(w: torch.Tensor) -> torch.Tensor:
    """One int8 level of each element's quantization block (the 8-bit
    moments' axis-aligned blocks along the last dim)."""
    from repro_torch.optim.adamw import _qblock_for

    x = w.reshape(1) if w.ndim == 0 else w
    qb = _qblock_for(x.shape[-1])
    g = x.reshape(*x.shape[:-1], x.shape[-1] // qb, qb)
    step = g.abs().amax(dim=-1, keepdim=True) / 127.0
    return step.expand_as(g).reshape(w.shape)


def test_train_step_records_match_reference_count_weighted():
    """The eager loop records each microbatch once (no ``scaled``): the
    count-weighted record totals of one step equal the reference's."""
    arch, nmb = "yi-6b", 2
    jcfg, tcfg = _cfgs(arch, nmb)
    batch = _batch_np(jcfg)
    jmodel = jbuild(jcfg)
    jopts = jsteps.TrainOptions(**OPTS)
    jp = _jparams(arch)
    js, _ = jsteps.init_train_state(jmodel, jp, jopts)
    with jpolicy(mode="device", platform="tpu-v5e"):
        with jtrace() as jt:
            jax.jit(jsteps.make_train_step(jmodel, jopts))(
                jp, js, None, _jbatch(batch))
    tmodel = tbuild(tcfg)
    topts = tsteps.TrainOptions(**OPTS)
    tp = _tparams(arch)
    ts, _ = tsteps.init_train_state(tmodel, tp, topts)
    with tpolicy(mode="device", platform="tpu-v5e"):
        with ttrace() as tt:
            tsteps.make_train_step(tmodel, topts)(tp, ts, None,
                                                  _tbatch(batch))

    def totals(records):
        out = defaultdict(lambda: [0.0, 0.0])
        for r in records:
            out[(r.op, r.backend)][0] += r.count
            out[(r.op, r.backend)][1] += r.count * r.cost.flops
        return dict(out)

    jtot, ttot = totals(jt.records), totals(tt.records)
    assert ttot == jtot
    assert ttot[("mlp_block", "device")][0] == 2 * tcfg.num_layers
    assert {r.count for r in tt.records} == {1.0}


def test_split_microbatches_interleaves_like_the_reference():
    b, s, nmb = 6, 4, 3
    tokens = np.arange(b * s, dtype=np.int32).reshape(b, s)
    positions = np.arange(3 * b * s, dtype=np.int32).reshape(3, b, s)
    batch = {"tokens": tokens, "positions": positions}
    want = jsteps._split_microbatches(_jbatch(batch), nmb)
    got = tsteps._split_microbatches(_tbatch(batch), nmb)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # microbatch j holds rows b·nmb + j
    np.testing.assert_array_equal(got["tokens"][1].numpy(), tokens[1::nmb])
    with pytest.raises(ValueError):
        tsteps._split_microbatches(_tbatch({"tokens": tokens}), 4)


def test_graph_forward_mode_refuses_to_train():
    _, tcfg = _cfgs("yi-6b", forward_mode="graph")
    with pytest.raises(ValueError, match="forward_mode"):
        tsteps.make_train_step(tbuild(tcfg))


def test_compressed_grads_step_matches_reference():
    """``compress_grads``: one step's loss equals the reference's, and its
    error buffers (each gradient leaf's int8 rounding residue) equal the
    reference's ``compress_decompress`` run on the same leaves within one
    int8 step of the leaf: gradients that agree within 2e-5 may still round
    to neighbouring levels.  The leaves are the port's: one per layer,
    where the reference's stacked leaf shares one scale over all layers
    (a departure, ROADMAP Queue 3)."""
    from repro.optim import compress_decompress as jcompress

    arch = "yi-6b"
    jcfg, tcfg = _cfgs(arch)
    batch = _batch_np(jcfg)
    opts = dict(OPTS, compress_grads=True)
    jmodel = jbuild(jcfg)
    jp = _jparams(arch)
    js, jerr = jsteps.init_train_state(jmodel, jp, jsteps.TrainOptions(**opts))
    _, _, _, jm = jax.jit(jsteps.make_train_step(
        jmodel, jsteps.TrainOptions(**opts)))(jp, js, jerr, _jbatch(batch))
    tmodel = tbuild(tcfg)
    tp = _tparams(arch)
    ts, terr = tsteps.init_train_state(tmodel, tp, tsteps.TrainOptions(**opts))
    assert terr is not None
    _, _, terr2, tm = tsteps.make_train_step(
        tmodel, tsteps.TrainOptions(**opts))(tp, ts, terr, _tbatch(batch))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * float(jm["loss"])
    _, grads_np = _ref_loss_and_grads(arch, 1)
    split = params_from_jax(grads_np)          # the port's leaves
    jsplit = tree.tree_map(lambda t: jnp.asarray(t.numpy()), split)
    _, jerr_split = jcompress(jsplit, jax.tree.map(jnp.zeros_like, jsplit))
    want = [torch.from_numpy(np.array(e)) for e in tree.leaves(jerr_split)]
    got = tree.leaves(terr2)
    assert len(got) == len(want)
    for g, w, leaf in zip(got, want, tree.leaves(split)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        step = float(leaf.abs().max()) / 127.0
        assert float((g - w).abs().max()) <= step * (1 + 1e-3) + 1e-7


# ---------------------------------------------------------------------------
# the kernels' autograd Functions (CPU: their forwards are the plain
# versions, their backwards run as on the card)
# ---------------------------------------------------------------------------

def test_every_lowering_row_has_a_gradient_rule():
    assert set(kgrad._RULES) == set(kops.KERNEL_LOWERINGS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_under_grad_carries_the_gemm_function(dtype):
    """With ``use_kernels=True``, on CPU tensors that require grad,
    ``blas.matmul``'s output carries the GEMM Function's ``grad_fn``, and
    its gradients equal the plain path's (autograd of the plain math)."""
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(2, 12, 16, generator=gen).to(dtype)
    w0 = torch.randn(16, 24, generator=gen).to(dtype)
    dy = torch.randn(2, 12, 24, generator=gen).to(dtype)
    grads = {}
    for kernels in (False, True):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        with tpolicy(mode="device", use_kernels=kernels):
            y = blas.matmul(x, w)
        assert y.requires_grad
        assert ("_GemmBackward" in _graph_nodes(y)) == kernels
        y.backward(dy)
        grads[kernels] = (y.detach(), x.grad, w.grad)
    for plain, kern in zip(grads[False], grads[True]):
        assert kern.dtype == plain.dtype
        torch.testing.assert_close(kern, plain, rtol=0, atol=0)


def _graph_nodes(t):
    """Names of the autograd nodes behind ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or type(fn).__name__ in seen:
            continue
        seen.add(type(fn).__name__)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return seen


def test_gemm_function_needs_only_the_grads_asked_for():
    a = torch.randn(20, 8).requires_grad_(True)
    b = torch.randn(8, 12)            # a frozen weight: no dB product
    calls = []

    def counted(x, y, *, out_dtype=None):
        calls.append((tuple(x.shape), tuple(y.shape)))
        return kref.gemm_ref(x, y, out_dtype=out_dtype)

    y = kgrad._gemm_call(counted)(a, b)
    y.sum().backward()
    assert calls == [((20, 8), (8, 12)), ((20, 12), (12, 8))]
    torch.testing.assert_close(a.grad, torch.ones(20, 12) @ b.T)


def test_gemm_function_weight_grad_reads_a_row_major_activation():
    """dB = Aᵀ·dC hands the kernel a row-major copy of Aᵀ (a column-major A
    would leave the bf16 tensor-core route); dA = dC·Bᵀ reads Bᵀ in place
    as a K-major view."""
    a = torch.randn(24, 16).requires_grad_(True)
    b = torch.randn(16, 8).requires_grad_(True)
    seen = []

    def spy(x, y, *, out_dtype=None):
        seen.append((x.stride(), y.stride()))
        return kref.gemm_ref(x, y, out_dtype=out_dtype)

    kgrad._gemm_call(spy)(a, b).sum().backward()
    fwd, d_a, d_b = seen
    assert d_a == ((8, 1), (1, 8))      # dC row-major, Bᵀ K-major view
    assert d_b == ((24, 1), (8, 1))     # Aᵀ copied row-major, dC row-major


def test_gemm_batched_function_matches_plain_autograd():
    gen = torch.Generator().manual_seed(1)
    a0 = torch.randn(3, 10, 8, generator=gen)
    b0 = torch.randn(3, 8, 6, generator=gen)
    dy = torch.randn(3, 10, 6, generator=gen)
    a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
    kgrad.lowering("gemm_batched")(a, b).backward(dy)
    a2, b2 = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
    kref.gemm_batched_ref(a2, b2).backward(dy)
    torch.testing.assert_close(a.grad, a2.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(b.grad, b2.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [None, 3])
def test_attention_function_backward_is_the_plain_recompute(window):
    gen = torch.Generator().manual_seed(2)
    q0 = torch.randn(1, 4, 6, 8, generator=gen)
    k0 = torch.randn(1, 2, 6, 8, generator=gen)
    v0 = torch.randn(1, 2, 6, 8, generator=gen)
    do = torch.randn(1, 4, 6, 8, generator=gen)
    ins = [t.clone().requires_grad_(True) for t in (q0, k0, v0)]
    out = kgrad.lowering("attention")(*ins, causal=True, window=window)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    out.backward(do)
    ref_ins = [t.clone().requires_grad_(True) for t in (q0, k0, v0)]
    kref.attention_ref(*ref_ins, causal=True, window=window).backward(do)
    for got, want in zip(ins, ref_ins):
        torch.testing.assert_close(got.grad, want.grad, rtol=0, atol=0)


def test_ssd_function_backward_is_the_plain_recompute():
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn(2, 2, 8, 4, generator=gen)
    a0 = torch.cumsum(-0.1 * torch.rand(2, 2, 8, generator=gen), dim=-1)
    b0 = torch.randn(2, 2, 8, 5, generator=gen)
    c0 = torch.randn(2, 2, 8, 5, generator=gen)
    dy = torch.randn(2, 2, 8, 4, generator=gen)
    ins = [t.clone().requires_grad_(True) for t in (x0, a0, b0, c0)]
    y = kgrad.lowering("ssd_chunk_diag")(*ins)
    assert type(y.grad_fn).__name__ == "_SsdChunkDiagBackward"
    y.backward(dy)
    ref_ins = [t.clone().requires_grad_(True) for t in (x0, a0, b0, c0)]
    kref.ssd_chunk_diag_ref(*ref_ins).backward(dy)
    for got, want in zip(ins, ref_ins):
        torch.testing.assert_close(got.grad, want.grad, rtol=0, atol=0)


def test_decode_attention_refuses_grad():
    q = torch.randn(2, 4, 8).requires_grad_(True)
    k = torch.randn(2, 2, 5, 8)
    lo = torch.zeros(2, dtype=torch.int32)
    hi = torch.full((2,), 5, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        kgrad.lowering("decode_attention")(q, k, k, lo, hi)
    with torch.no_grad():
        out = kgrad.lowering("decode_attention")(q, k, k, lo, hi)
    assert out.shape == (2, 4, 8)


def test_no_grad_launches_skip_the_functions():
    a = torch.randn(20, 8).requires_grad_(True)
    with torch.no_grad():
        y = kgrad.lowering("gemm")(a, torch.randn(8, 4))
    assert y.grad_fn is None
    y = kgrad.lowering("gemm")(torch.randn(20, 8), torch.randn(8, 4))
    assert y.grad_fn is None


# ---------------------------------------------------------------------------
# twins of tests/test_models.py and tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_one_train_step(arch):
    """Reduced config, one forward and one train step on the CPU, output
    shapes and no NaNs (``test_models.py``'s test), through the kernel
    path."""
    _, tcfg = _cfgs(arch)
    model = tbuild(tcfg)
    params = _tparams(arch)
    batch = _tbatch(_batch_np(tcfg, b=2, s=16))
    with tpolicy(mode="device", use_kernels=True):
        with torch.no_grad():
            logits, aux = model.forward(params, batch)
        assert logits.shape == (2, 16, tcfg.vocab_size)
        assert not bool(torch.isnan(logits).any())
        assert not bool(torch.isnan(aux))
        opts = tsteps.TrainOptions()
        opt_state, err = tsteps.init_train_state(model, params, opts)
        p2, o2, _, metrics = tsteps.make_train_step(model, opts)(
            params, opt_state, err, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(o2.step) == 1
    for new, old in zip(tree.leaves(p2), tree.leaves(params)):
        assert new.shape == old.shape and new.dtype == old.dtype
        assert bool(torch.isfinite(new).all())


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b",
                                  "hubert-xlarge"])
def test_loss_decreases(arch):
    _, tcfg = _cfgs(arch)
    model = tbuild(tcfg)
    params = _tparams(arch)
    batch = _tbatch(_batch_np(tcfg, b=4, s=16))
    opts = tsteps.TrainOptions(**OPTS)
    opt_state, err = tsteps.init_train_state(model, params, opts)
    step = tsteps.make_train_step(model, opts)
    losses = []
    with tpolicy(mode="device", use_kernels=True):
        for _ in range(5):
            params, opt_state, err, m = step(params, opt_state, err, batch)
            losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def _recovery_run(root, inject_failure_at=None, num_steps=12):
    """``run_with_recovery`` around the real train step and a
    ``Checkpointer`` (``tests/test_fault_tolerance.py``'s harness)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticLM

    _, tcfg = _cfgs("yi-6b")
    model = tbuild(tcfg)
    opts = tsteps.TrainOptions(**OPTS)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    opt_state, _ = tsteps.init_train_state(model, params, opts)
    data = SyntheticLM(tcfg.vocab_size, 16, 4, seed=5)
    step_fn_ = tsteps.make_train_step(model, opts)
    ck = Checkpointer(root / ("fail" if inject_failure_at else "clean"),
                      keep=3)
    state = {"params": params, "opt": opt_state}
    failed = {"done": False}

    def step_fn(step):
        if (inject_failure_at is not None and step == inject_failure_at
                and not failed["done"]):
            failed["done"] = True
            raise WorkerFailure(f"injected pod failure at step {step}")
        batch = {k: torch.from_numpy(v) for k, v in data.batch(step).items()}
        with tpolicy(mode="device", use_kernels=True):
            p, o, _, m = step_fn_(state["params"], state["opt"], None, batch)
        state["params"], state["opt"] = p, o
        return float(m["loss"]), 0.0

    def save_fn(step):
        ck.save(step, (state["params"], state["opt"]))

    def restore_fn():
        (state["params"], state["opt"]), step = ck.restore(
            (state["params"], state["opt"]))
        return step

    save_fn(0)
    final, log, restarts = run_with_recovery(
        num_steps=num_steps, start_step=0, step_fn=step_fn,
        save_fn=save_fn, restore_fn=restore_fn, checkpoint_every=4)
    return [m for _, m in log], restarts


def test_restart_bitwise_identical(tmp_path):
    """A run with an injected failure and a restart from the checkpoint
    gives the uninterrupted run's losses bit for bit."""
    clean, r0 = _recovery_run(tmp_path)
    faulty, r1 = _recovery_run(tmp_path, inject_failure_at=6)
    assert r0 == 0 and r1 == 1
    assert len(faulty) == len(clean) + 2      # steps 4 and 5 replayed
    assert faulty[-6:] == clean[-6:]
    assert faulty[:6] == clean[:6]


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_resumes_and_descends(tmp_path, capsys):
    ck = tmp_path / "ck"
    argv = ["--arch", "yi-6b", "--steps", "8", "--global-batch", "4",
            "--seq-len", "32", "--device", "cpu", "--ckpt-dir", str(ck),
            "--ckpt-every", "4"]
    train_main(argv)
    out = capsys.readouterr().out
    assert "step     0" in out and "step     7" in out
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000004",
                                                    "step_00000008"]
    train_main(argv)
    assert "resumed from step 8" in capsys.readouterr().out
    losses = ttrain("yi-6b", steps=8, global_batch=4, seq_len=32,
                    device="cpu", ckpt_dir=None)
    assert len(losses) == 8 and losses[-1] < losses[0], losses


def test_train_matches_reference_losses(tmp_path):
    """``train`` on the reference's weights is not possible (each package
    draws its own), so the data path is held instead: the reference's
    ``SyntheticLM`` batches at seed 17 drive the port's train step to the
    reference's losses within 2e-5 for three steps."""
    from repro.data import SyntheticLM as JSynthetic
    from repro_torch.data import SyntheticLM as TSynthetic

    arch = "yi-6b"
    jcfg, tcfg = _cfgs(arch)
    jdata = JSynthetic(jcfg.vocab_size, 16, 4, seed=17)
    tdata = TSynthetic(tcfg.vocab_size, 16, 4, seed=17)
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg)
    jo = jsteps.TrainOptions(**OPTS)
    to = tsteps.TrainOptions(**OPTS)
    jp = _jparams(arch)
    tp = _tparams(arch)
    js, _ = jsteps.init_train_state(jmodel, jp, jo)
    ts, _ = tsteps.init_train_state(tmodel, tp, to)
    jstep = jax.jit(jsteps.make_train_step(jmodel, jo))
    tstep = tsteps.make_train_step(tmodel, to)
    for step in range(3):
        jb, tb = jdata.batch(step), tdata.batch(step)
        np.testing.assert_array_equal(jb["tokens"], tb["tokens"])
        jp, js, _, jm = jstep(jp, js, None, _jbatch(jb))
        with tpolicy(mode="device", use_kernels=True):
            tp, ts, _, tm = tstep(tp, ts, None, _tbatch(tb))
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= TOL * float(jm["loss"])


def test_train_without_a_card_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain("yi-6b", steps=1, global_batch=2, seq_len=8, ckpt_dir=None)
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--arch", "yi-6b", "--steps", "1", "--ckpt-dir", ""])


def test_num_layers_cuts_depth_at_published_widths(tmp_path):
    seen = []
    ttrain("yi-6b", steps=2, global_batch=2, seq_len=8, device="cpu",
           ckpt_dir=None, num_layers=1,
           on_step=lambda step, loss, s: seen.append((step, loss, s)))
    assert [s for s, _, _ in seen] == [0, 1]
    assert all(np.isfinite(loss) and sec > 0 for _, loss, sec in seen)


# ---------------------------------------------------------------------------
# the port's form of the lint rule models-no-dot-general
# ---------------------------------------------------------------------------

# The one-step SSM decode's small einsums (one token's state update and
# read-out) are not GEMMs; the reference's rule leaves ``einsum`` alone.

def _raw_gemm_sites(path):
    """(line, form) of every raw GEMM the lint rule
    ``models-no-raw-matmul`` (``repro_torch.analysis.lint``) finds."""
    (rule,) = [r for r in RULES if r.name == "models-no-raw-matmul"]
    for v in rule.check(FileView.load(path, ROOT)):
        yield int(v.where.rsplit(":", 1)[1]), v.message.split("(")[1].split(")")[0]


@pytest.mark.parametrize(
    "path", sorted((ROOT / "src" / "repro_torch" / "models").glob("*.py")),
    ids=lambda p: p.name)
def test_models_route_every_gemm_through_blas(path):
    """No ``torch.matmul`` / ``torch.mm`` / ``torch.bmm`` and no ``@``
    under ``models/``: every GEMM goes through ``core/blas``, so the loss
    reaches the kernels (the reference's lint rule
    ``models-no-dot-general``; here the port's ``models-no-raw-matmul``)."""
    bad = list(_raw_gemm_sites(path))
    assert not bad, f"{path.name}: raw GEMMs at {bad}"
    assert run_lint(ROOT, paths=[path], repo_rules=False) == []


def test_raw_gemm_walk_finds_each_form(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import torch\n"
                 "def f(x, w):\n"
                 "    a = x @ w\n"
                 "    b = torch.matmul(x, w)\n"
                 "    c = torch.bmm(x, w)\n"
                 "    x @= w\n"
                 "    return torch.einsum('ij,jk->ik', x, w)\n")
    assert sorted(_raw_gemm_sites(f)) == [(3, "@"), (4, "torch.matmul"),
                                          (5, "torch.bmm"), (6, "@")]
