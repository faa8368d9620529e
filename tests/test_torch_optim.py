"""The port's optimizers, schedules and gradient compression against the
reference (``src/repro/optim``): twins of ``tests/test_optim.py`` (less
``test_compressed_psum_over_real_axis``, which needs a mesh) and the same
numpy inputs through both packages, f32, within 1e-6."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
import hypothesis.strategies as st

from repro import optim as J
from repro_torch import optim as T
from repro_torch import tree
from repro_torch.optim.adamw import QBLOCK, _dequantize, _quantize

# The modules (each package's ``optim.adamw`` attribute is the function).
jadamw = importlib.import_module("repro.optim.adamw")
tadamw = importlib.import_module("repro_torch.optim.adamw")

TOL = 1e-6


def _params():
    return {"w": torch.tensor([[1.0, -2.0], [3.0, 0.5]]),
            "b": torch.tensor([0.1, -0.1])}


# ---------------------------------------------------------------------------
# twins of tests/test_optim.py
# ---------------------------------------------------------------------------

def test_adamw_first_step_matches_reference():
    lr, b1, b2, eps, wd = 0.1, 0.9, 0.95, 1e-8, 0.0
    init, update = T.adamw(T.constant(lr), b1=b1, b2=b2, eps=eps,
                           weight_decay=wd, max_grad_norm=1e9)
    p = _params()
    st_ = init(p)
    g = tree.tree_map(torch.ones_like, p)
    p2, st2 = update(g, st_, p)
    # bias-corrected first step of Adam with unit grads = lr * 1/(1+eps')
    for a, b in zip(tree.leaves(p), tree.leaves(p2)):
        np.testing.assert_allclose((a - b).numpy(), lr, rtol=1e-4)
    assert int(st2.step) == 1
    # functional, as the reference: the arguments are untouched
    assert torch.equal(p["w"], _params()["w"])


def test_weight_decay_pulls_to_zero():
    init, update = T.adamw(T.constant(0.1), weight_decay=0.5,
                           max_grad_norm=1e9)
    p = {"w": torch.tensor([10.0])}
    st_ = init(p)
    p2, _ = update({"w": torch.tensor([0.0])}, st_, p)
    assert float(p2["w"][0]) < 10.0


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = T.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(gn), 20.0, rtol=1e-5)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-5)


@given(st.integers(1, 2000), st.floats(0.01, 100.0))
@settings(max_examples=20, deadline=None)
def test_quantize_roundtrip_error_bounded(n, scale):
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.normal(size=(n,)) * scale).astype(np.float32))
    qt = _quantize(x)
    y = _dequantize(qt, x.shape)
    bound = float(x.abs().max()) / 127.0 * 0.5 + 1e-6
    assert bool(((y - x).abs() <= bound).all())
    assert qt.q.shape == x.shape and qt.q.dtype == torch.int8
    assert x.shape[-1] % qt.scale.shape[-1] == 0


def test_adamw8bit_tracks_fp32_closely():
    init32, up32 = T.adamw(T.constant(0.05), max_grad_norm=1e9)
    init8, up8 = T.adamw8bit(T.constant(0.05), max_grad_norm=1e9)
    p32 = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(512,)).astype(np.float32))}
    p8 = tree.tree_map(torch.clone, p32)
    s32, s8 = init32(p32), init8(p8)
    for i in range(5):
        g = {"w": torch.from_numpy(np.random.default_rng(i).normal(
            size=(512,)).astype(np.float32))}
        p32, s32 = up32(g, s32, p32)
        p8, s8 = up8(g, s8, p8)
    diff = float((p32["w"] - p8["w"]).abs().max())
    scale = float(p32["w"].abs().max()) + 1e-9
    assert diff / scale < 0.05, diff


def test_error_feedback_preserves_sum():
    rng = np.random.default_rng(0)
    true_sum = np.zeros(64, np.float32)
    applied_sum = np.zeros(64, np.float32)
    err = T.init_error_buffer({"w": torch.zeros(64)})
    for i in range(50):
        g = rng.normal(size=64).astype(np.float32) * (1 + i % 3)
        true_sum += g
        cg, err = T.compress_decompress({"w": torch.from_numpy(g)}, err)
        applied_sum += cg["w"].numpy()
    resid = np.abs(true_sum - applied_sum).max()
    assert resid < np.abs(true_sum).max() * 0.02 + 0.5


def test_warmup_cosine_shape():
    fn = T.warmup_cosine(1.0, 10, 100)
    assert fn(0) == 0.0
    assert fn(10) == pytest.approx(1.0, rel=1e-3)
    assert fn(100) == pytest.approx(0.1, rel=1e-2)
    assert fn(55) > fn(90)


# ---------------------------------------------------------------------------
# the same inputs through both packages
# ---------------------------------------------------------------------------

def _tree_np(seed):
    """A params-like tree: a nested dict, a list of per-layer dicts, a 0-d
    leaf and a last dim no power of two divides past 4 (12)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": f(33, 8), "stack": [{"wq": f(8, 12), "norm": f(8)}
                                         for _ in range(2)],
            "head": {"w": f(8, 512), "b": f(512)}, "scalar": f()}


def _to_t(t_np):
    return tree.tree_map(lambda a: torch.from_numpy(np.array(a)), t_np)


def _to_j(t_np):
    return jax.tree.map(jnp.asarray, t_np)


def _close(got, want, tol=TOL):
    g, w = tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.float().numpy(), b, rtol=tol, atol=tol)


def test_leaf_order_is_the_references():
    t_np = _tree_np(0)
    got = [tuple(x.shape) for x in tree.leaves(_to_t(t_np))]
    want = [tuple(x.shape) for x in jax.tree.leaves(_to_j(t_np))]
    assert got == want


@pytest.mark.parametrize("max_norm", [1.0, 1e9])
def test_clip_matches_reference(max_norm):
    t_np = _tree_np(1)
    tg, tn = T.clip_by_global_norm(_to_t(t_np), max_norm)
    jg, jn = J.clip_by_global_norm(_to_j(t_np), max_norm)
    assert abs(float(tn) - float(jn)) <= TOL * float(jn)
    _close(tg, jg)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_schedules_match_reference(step):
    tw = T.warmup_cosine(3e-4, 10, 100)
    jw = J.warmup_cosine(3e-4, 10, 100)
    want = float(jw(jnp.int32(step)))
    assert abs(tw(step) - want) <= 1e-7 * abs(want) + 1e-12
    assert T.constant(3e-4)(step) == float(J.constant(3e-4)(jnp.int32(step)))


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_three_updates_match_reference(optimizer):
    """Three steps of each optimizer on the same params and gradients (a
    schedule in warmup, then cosine; clipping active): params, mu and nu
    within 1e-6 (8-bit moments dequantized, plus one int8 step)."""
    sched = dict(peak_lr=1e-2, warmup_steps=1, total_steps=4)
    tinit, tup = getattr(T, optimizer)(T.warmup_cosine(**sched))
    jinit, jup = getattr(J, optimizer)(J.warmup_cosine(**sched))
    p_np = _tree_np(2)
    tp, jp = _to_t(p_np), _to_j(p_np)
    ts, js = tinit(tp), jinit(jp)
    jup = jax.jit(jup)
    for i in range(3):
        g_np = jax.tree.map(lambda a: a * (3.0 - i), _tree_np(10 + i))
        tp, ts = tup(_to_t(g_np), ts, tp)
        jp, js = jup(_to_j(g_np), js, jp)
        _close(tp, jp)
        if optimizer == "adamw":
            _close(ts.mu, js.mu)
            _close(ts.nu, js.nu)
        else:
            for tq, jq in zip(tree.leaves(ts.mu, tadamw._is_qt) +
                              tree.leaves(ts.nu, tadamw._is_qt),
                              jax.tree.leaves(js.mu, is_leaf=_jqt) +
                              jax.tree.leaves(js.nu, is_leaf=_jqt)):
                np.testing.assert_allclose(tq.scale.numpy(),
                                           np.asarray(jq.scale),
                                           rtol=TOL, atol=1e-12)
                dq = (tq.q.numpy().astype(np.int32)
                      - np.asarray(jq.q).astype(np.int32))
                assert np.abs(dq).max() <= 1
    assert int(ts.step) == int(js.step) == 3


def _jqt(x):
    return isinstance(x, jadamw.QTensor)


@pytest.mark.parametrize("shape", [(), (7,), (3, 512), (2, 3, 384), (5, 12)])
def test_quantize_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    tq = _quantize(torch.from_numpy(np.array(x)))
    jq = jadamw._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(
        _dequantize(tq, shape).numpy(),
        np.asarray(jadamw._dequantize(jq, shape)))
    assert QBLOCK == jadamw.QBLOCK
    assert tadamw._qblock_for(shape[-1] if shape else 1) == \
        jadamw._qblock_for(shape[-1] if shape else 1)


def test_compress_decompress_matches_reference():
    g_np = _tree_np(4)
    e_np = jax.tree.map(lambda a: a * 1e-3, _tree_np(5))
    tg, te = T.compress_decompress(_to_t(g_np), _to_t(e_np))
    jg, je = J.compress_decompress(_to_j(g_np), _to_j(e_np))
    _close(tg, jg)
    _close(te, je)
    zeros = T.init_error_buffer(_to_t(g_np))
    assert all(z.dtype == torch.float32 and not bool(z.any())
               for z in tree.leaves(zeros))


def test_compress_keeps_the_gradient_dtype():
    g = {"w": torch.randn(16, 8).bfloat16()}
    cg, err = T.compress_decompress(g, T.init_error_buffer(g))
    assert cg["w"].dtype == torch.bfloat16 and err["w"].dtype == torch.float32


def test_make_optimizer_follows_the_config():
    from repro_torch.configs import get_arch

    st8 = T.make_optimizer(get_arch("jamba-1.5-large-398b"), 1e-3)[0](
        {"w": torch.zeros(4, 8)})
    assert isinstance(st8.mu["w"], tadamw.QTensor)
    st = T.make_optimizer(get_arch("yi-6b"), 1e-3)[0]({"w": torch.zeros(4)})
    assert st.mu["w"].dtype == torch.float32
    assert set(T.__all__) == set(J.__all__)
