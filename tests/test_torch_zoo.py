"""The rest of the model zoo on the port, against the reference: jamba's
hybrid stack (Mamba, attention and MoE sub-layers in period-8
super-blocks), gemma3's 5:1 local:global windows, danube's sliding window
and rolling cache, qwen2's qkv bias, qwen2-vl's M-RoPE on embedding inputs
and hubert's bidirectional LayerNorm / GELU encoder.

Reduced configs in f32, on weights converted from the reference's
``init_params`` by ``params_from_jax``.  Tolerances are
``tests/test_models.py``'s: forward 2e-4, decode against forward 2e-2;
decode steps against the reference's 1e-4 of max |logit|, as
``tests/test_torch_serve.py`` holds yi-6b.  Both packages run under their
kernel policy (the reference's Pallas kernels in interpret mode, the
port's wrappers on their plain versions, the tensors lying on the CPU)
with ``platform="tpu-v5e"``.

The departure mapped in ``tests/test_torch_forward.py`` holds here too:
where the reference scans a uniform stack its per-layer window is a traced
scalar, so its forward attention records are on ``device``; the port's
(a Python int window) are on ``device-kernel``.  A hybrid stack passes no
window, so both packages' forward attention records are on the kernel.
"""

import dataclasses
from collections import defaultdict

from config_parity import assert_config_equal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import offload_policy as jpolicy
from repro.launch.serve import serve_batch as jserve_batch
from repro.launch.steps import make_prefill_step as jprefill
from repro.models import build_model as jbuild
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.convert import params_from_jax
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.launch.serve import serve_batch as tserve_batch
from repro_torch.launch.steps import make_prefill_step as tprefill
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T

JAMBA = "jamba-1.5-large-398b"
ZOO = [JAMBA, "gemma3-27b", "h2o-danube-1.8b", "qwen2-72b", "qwen2-vl-72b",
       "hubert-xlarge"]
DECODERS = [a for a in ZOO if a != "hubert-xlarge"]
SERVED = [JAMBA, "gemma3-27b", "h2o-danube-1.8b", "qwen2-72b"]
TOL = 2e-4                   # tests/test_models.py, f32
DECODE_VS_FORWARD = 2e-2     # tests/test_models.py::test_decode_matches_forward
LOGIT_TOL = 1e-4             # tests/test_torch_serve.py, x max |logit|
RENAME = {"device-pallas": "device-kernel"}
BATCH = 8                    # decode GEMMs have m = batch; the gate is >= 8


def _cfgs(arch, mode="eager", **over):
    j = dataclasses.replace(jget_arch(arch).reduced(), forward_mode=mode,
                            **over)
    t = dataclasses.replace(tget_arch(arch).reduced(), forward_mode=mode,
                            **over)
    return j, t


_PARAMS = {}


def _params(arch, **over):
    """The reference's weights for the reduced arch, and the port's copy
    (cached per arch: the reference's init is the slow part)."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _PARAMS:
        jcfg, _ = _cfgs(arch, **over)
        jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
        _PARAMS[key] = (jp, params_from_jax(jax.tree.map(np.asarray, jp)))
    return _PARAMS[key]


def _ref_policy(**kw):
    return jpolicy(mode="device", use_pallas=True, interpret=True,
                   platform="tpu-v5e", **kw)


def _port_policy(**kw):
    return tpolicy(mode="device", use_kernels=True, platform="tpu-v5e", **kw)


def _positions(b, s):
    """Three distinct M-RoPE streams: temporal, height, width of a 4-wide
    patch grid."""
    t = np.arange(s, dtype=np.int32)
    return np.stack([np.broadcast_to(t, (b, s)),
                     np.broadcast_to(t // 4, (b, s)),
                     np.broadcast_to(t % 4, (b, s))]).astype(np.int32)


def _batch(cfg, b=2, s=16, seed=0):
    """numpy inputs of one forward: tokens, or embeddings (B, S, D) with
    (3, B, S) positions for M-RoPE."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        out = {"tokens": rng.integers(0, cfg.vocab_size,
                                      size=(b, s)).astype(np.int32)}
    else:
        out = {"embeds": rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)}
    if cfg.mrope:
        out["positions"] = _positions(b, s)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _totals(records, ref=False):
    """Count-weighted record totals per (op, backend); the reference's
    forward attention on ``device`` (a traced window) is mapped to the
    kernel its static-window twin takes (see the module docstring)."""
    out = defaultdict(lambda: [0.0, 0.0])
    for r in records:
        backend = RENAME.get(r.backend, r.backend)
        if ref and r.op == "attention" and backend == "device":
            backend = "device-kernel"
        out[(r.op, backend)][0] += r.count
        out[(r.op, backend)][1] += r.count * r.cost.flops
    return dict(out)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    """Every arch of the reference is registered, every field of every
    config (and of its reduced twin) equals the reference's, and each field
    only the port has holds its default."""
    assert tlist_archs() == jlist_archs()
    for arch in jlist_archs():
        for j, t in ((jget_arch(arch), tget_arch(arch)),
                     (jget_arch(arch).reduced(), tget_arch(arch).reduced())):
            assert_config_equal(t, j, arch)
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
            assert t.uniform_stack == j.uniform_stack


def test_jamba_layer_pattern():
    cfg = tget_arch(JAMBA)
    kinds = [cfg.layer_kind(i) for i in range(8)]
    assert kinds.count("attn") == 1 and kinds[4] == "attn"
    assert [cfg.layer_is_moe(i) for i in range(4)] == [False, True, False,
                                                       True]
    assert not cfg.uniform_stack


def test_gemma3_local_global_pattern():
    cfg = tget_arch("gemma3-27b")
    kinds = [cfg.layer_window(i, 10**6) for i in range(12)]
    assert kinds[:5] == [1024] * 5 and kinds[5] > 10**5
    assert kinds[6:11] == [1024] * 5 and kinds[11] > 10**5
    thetas = [cfg.layer_rope_theta(i) for i in range(6)]
    assert thetas[:5] == [1.0e4] * 5 and thetas[5] == 1.0e6
    windows, thetas = T._layer_data(cfg, 2048)
    assert sum(w == 1024 for w in windows) == 52 and len(windows) == 62


def test_swa_rolling_cache_bounded():
    """Danube's rolling cache stays at window size whatever the decode
    length; a hybrid cache keeps every slot (no rolling buffer)."""
    cfg = tget_arch("h2o-danube-1.8b").reduced()
    cache = tbuild(cfg).init_decode_cache(1, 1024, device="cpu")
    assert cache["k"].shape[3] == cfg.sliding_window
    jamba = tget_arch(JAMBA).reduced()
    cache = tbuild(jamba).init_decode_cache(1, 1024, device="cpu")
    assert cache["k"].shape[3] == 1024


@pytest.mark.parametrize("arch", ZOO)
def test_param_counts_match_billing(arch):
    """param_count() within 35 % of the advertised size, as the reference's
    test holds it; and the built model's parameters, counted, equal it."""
    billed = {JAMBA: 398e9, "gemma3-27b": 27e9, "h2o-danube-1.8b": 1.8e9,
              "qwen2-72b": 72e9, "qwen2-vl-72b": 72e9,
              "hubert-xlarge": 1e9}[arch]
    got = tget_arch(arch).param_count()
    assert abs(got - billed) / billed < 0.35, f"{arch}: {got:.2e}"
    cfg = tget_arch(arch).reduced()
    p = tbuild(cfg).init_params(torch.Generator().manual_seed(0),
                                device="meta")
    # param_count() leaves out the norms, biases, the Mamba conv and the
    # dt / A / D vectors: the 2-D and 3-D weights but conv_w are all it
    # counts.
    mats = sum(t.numel()
               for sb in p["stack"] for path, t in _leaves(sb)
               if t.ndim >= 2 and path[-1] != "conv_w")
    mats += sum(p[k].numel() for k in ("embed", "head") if k in p)
    assert mats == cfg.param_count()


def test_cache_shapes_match_reference():
    """The decode cache of every decoder: the same names, shapes and
    dtypes as the reference's (jamba: k/v a super-block, SSM and conv
    states a Mamba sub-layer)."""
    for arch in DECODERS:
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = _cfgs(arch, dtype=dtype)
            jc = jbuild(jcfg).init_decode_cache(3, 24)
            tc = tbuild(tcfg).init_decode_cache(3, 24, device="cpu")
            assert set(tc) == set(jc)
            for name in jc:
                assert tuple(tc[name].shape) == jc[name].shape, (arch, name)
                assert str(tc[name].dtype).removeprefix("torch.") == \
                    jc[name].dtype.name
    jcfg, tcfg = _cfgs(JAMBA)
    tc = tbuild(tcfg).init_decode_cache(3, 24, device="cpu")
    n_sb = tcfg.num_layers // 8
    assert tc["ssm"].shape[:2] == (n_sb, 7) and tc["k"].shape[0] == n_sb


def test_moe_every_kth_layer_without_an_attention_period_raises():
    """A non-hybrid stack with MoE every k-th layer is not uniform, and the
    reference's decode divides by its attn_layer_period of 0: the port
    names it and does not guess a period."""
    cfg = dataclasses.replace(tget_arch("qwen3-moe-30b-a3b").reduced(),
                              moe_layer_period=2)
    assert not cfg.uniform_stack
    with pytest.raises(ValueError, match="attn_layer_period"):
        T.init_decode_cache(cfg, 1, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="attn_layer_period"):
        T.decode_stack([], {}, torch.zeros(1, 1, cfg.d_model), 0, cfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layer_norm_matches_reference():
    from repro.models import layers as JL

    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 2.0, size=(2, 5, 48)).astype(np.float32)
    p = {"scale": rng.normal(size=48).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    for dtype in (jnp.float32, jnp.bfloat16):
        jx = jnp.asarray(x, dtype)
        jp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
        want = np.asarray(JL.layer_norm(jx, jp, 1e-6), np.float32)
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        got = TL.apply_norm(torch.from_numpy(x).to(tdt),
                            {k: torch.from_numpy(v).to(tdt)
                             for k, v in p.items()}, 1e-6, "layernorm")
        assert got.dtype == tdt
        tol = 1e-5 if dtype == jnp.float32 else 1e-2
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("d", [16, 32, 128])
def test_mrope_matches_reference(d):
    """M-RoPE's 2:3:3 bands of the half-dim (the last band takes the
    remainder) on three distinct streams; identical streams reduce it to
    RoPE."""
    from repro.models import layers as JL

    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 12, 3, d)).astype(np.float32)
    pos = _positions(2, 12)
    want = np.asarray(JL.mrope(jnp.asarray(x), jnp.asarray(pos), 1.0e6))
    got = TL.mrope(torch.from_numpy(x), torch.from_numpy(pos), 1.0e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    same = np.broadcast_to(pos[0], (3, 2, 12))
    torch.testing.assert_close(
        TL.mrope(torch.from_numpy(x), torch.from_numpy(same.copy()), 1.0e6),
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos[0].copy()), 1.0e6))


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,dtype", [(JAMBA, "bfloat16"),
                                        ("hubert-xlarge", "bfloat16"),
                                        ("qwen2-72b", "float32"),
                                        (JAMBA, "float32")])
def test_params_from_jax_carries_every_leaf(arch, dtype):
    """Every reference leaf crosses bit for bit with its dtype: jamba's
    super-blocks (``sub0``..``sub7`` of each), hubert's LayerNorm and GELU
    MLP biases, qwen2's qkv biases; the port's own init has the same
    tree."""
    jp, tp = _params(arch, dtype=dtype)
    _, tcfg = _cfgs(arch, dtype=dtype)
    period = 8 if arch == JAMBA else 1
    assert len(tp["stack"]) == tcfg.num_layers // period
    names = set()
    for i, layer in enumerate(tp["stack"]):
        for path, leaf in _leaves(layer):
            names.add(path)
            ref = jp["stack"]
            for k in path:
                ref = ref[k]
            ref = np.asarray(ref)[i]
            assert tuple(leaf.shape) == ref.shape
            assert str(leaf.dtype).removeprefix("torch.") == ref.dtype.name
            bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}
            tv, nv = bits[ref.dtype.itemsize]
            assert np.array_equal(leaf.view(tv).numpy(), ref.view(nv)), path
    if arch == JAMBA:
        assert {p[0] for p in names} == {f"sub{j}" for j in range(8)}
        assert ("sub4", "mixer", "wq") in names          # attention
        assert ("sub0", "mixer", "wx") in names          # Mamba
        assert ("sub1", "ffn", "router") in names        # MoE
        assert ("sub0", "ffn", "w_gate") in names        # dense
    if arch == "hubert-xlarge":
        assert ("norm1", "bias") in names and ("ffn", "b_up") in names
        assert "embed" not in tp and "head" in tp
    if arch == "qwen2-72b":
        assert {("mixer", "bq"), ("mixer", "bk"), ("mixer", "bv")} <= names
    own = tbuild(tcfg).init_params(torch.Generator().manual_seed(0),
                                   device="meta")
    assert [sorted(p for p, _ in _leaves(sb)) for sb in own["stack"]] == \
        [sorted(p for p, _ in _leaves(sb)) for sb in tp["stack"]]
    assert set(own) == set(tp)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eager", "graph"])
@pytest.mark.parametrize("arch", ZOO)
def test_forward_matches_reference(arch, mode):
    jp, tp = _params(arch)
    jcfg, tcfg = _cfgs(arch, mode)
    batch = _batch(jcfg)
    with _ref_policy():
        with jtrace() as jt:
            jl, jaux = jbuild(jcfg).forward(jp, _jbatch(batch))
    with _port_policy(), torch.no_grad():
        with ttrace() as tt:
            tl, taux = tbuild(tcfg).forward(tp, _tbatch(batch))
    jl = np.asarray(jl, np.float32)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    assert abs(float(taux) - float(jaux)) <= TOL * max(1.0, abs(float(jaux)))
    assert (float(taux) > 0) == (arch == JAMBA)
    ttot, jtot = _totals(tt.records), _totals(jt.records, ref=True)
    key = ("attention", "device-kernel")
    assert ttot.pop(key)[1] == _windowed_attention_flops(jcfg, batch)
    assert jtot.pop(key)[0] == tcfg.num_layers // (8 if arch == JAMBA else 1)
    assert ttot == jtot
    ops = {op for op, backend in _totals(tt.records)
           if backend == "device-kernel"}
    assert {"qkv_project", "attention"} <= ops
    if arch == JAMBA:
        assert {"ssd_scan", "moe_expert_ffn"} <= ops


def _windowed_attention_flops(jcfg, batch):
    """The forward's attention FLOPs with each layer's window, by the
    reference's cost model.  Its scanned forward passes traced windows,
    which its cost does not clip, so its records count gemma3's and
    danube's windowed layers as full; the port's int windows are
    clipped."""
    from repro.core import cost_model as jcm

    lead = batch.get("tokens", batch.get("embeds"))
    b, s = lead.shape[0], lead.shape[1]
    if jcfg.uniform_stack:
        windows = [jcfg.layer_window(i, s) for i in range(jcfg.num_layers)]
    else:
        windows = [None] * (jcfg.num_layers // 8)
    return sum(jcm.attention_cost(
        b, s, s, jcfg.num_heads, jcfg.head_dim, 4,
        window=w if w and w < s else None).flops for w in windows)


@pytest.mark.parametrize("arch", ZOO)
def test_forward_eager_and_graph_agree(arch):
    _, tp = _params(arch)
    batch = _tbatch(_batch(_cfgs(arch)[1]))
    out = {}
    for mode in ("eager", "graph"):
        with _port_policy(), torch.no_grad():
            out[mode] = tbuild(_cfgs(arch, mode)[1]).forward(tp, batch)
    torch.testing.assert_close(out["graph"][0], out["eager"][0], rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(out["graph"][1], out["eager"][1], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge"])
def test_prefill_step_takes_embeddings(arch):
    """An embedding-input model has a prefill step: the batch dict with
    ``embeds`` (and qwen2-vl's (3, B, S) positions)."""
    jp, tp = _params(arch)
    jcfg, tcfg = _cfgs(arch)
    batch = _batch(jcfg, s=24)
    with _ref_policy():
        want = jprefill(jbuild(jcfg))(jp, _jbatch(batch))
    with _port_policy(), torch.no_grad():
        got = tprefill(tbuild(tcfg))(tp, _tbatch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_forward_takes_tokens_and_positions_beside_them():
    """``forward(params, tokens)`` and ``forward(params, tokens,
    positions=...)`` keep working beside the batch dict."""
    _, tp = _params("qwen2-72b")
    _, tcfg = _cfgs("qwen2-72b")
    toks = torch.from_numpy(_batch(tcfg)["tokens"])
    pos = torch.arange(3, 19, dtype=torch.int32).expand(2, 16)
    m = tbuild(tcfg)
    with _port_policy(), torch.no_grad():
        a = m.forward(tp, toks)[0]
        b = m.forward(tp, {"tokens": toks})[0]
        c = m.forward(tp, toks, positions=pos)[0]
        d = m.forward(tp, {"tokens": toks, "positions": pos})[0]
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# decode and serve
# ---------------------------------------------------------------------------

def _decode_both(arch, steps, mode="eager", **over):
    """``steps`` decode steps of BATCH rows on both packages: tokens, or
    for an embedding-input arch (qwen2-vl) embeddings (B, 1, D).  Returns
    the stacked logits and the traces."""
    jp, tp = _params(arch, **over)
    jcfg, tcfg = _cfgs(arch, mode, **over)
    rng = np.random.default_rng(0)
    if jcfg.embed_inputs:
        xs = rng.integers(1, jcfg.vocab_size,
                          size=(steps, BATCH, 1)).astype(np.int32)
    else:
        xs = rng.normal(size=(steps, BATCH, 1, jcfg.d_model)).astype(
            np.float32)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jc = jm.init_decode_cache(BATCH, 16)
    tc = tm.init_decode_cache(BATCH, 16, device="cpu")
    jl, tl = [], []
    with _ref_policy(), jtrace() as jt:
        for s in range(steps):
            logits, jc = jm.decode_step(jp, jc, jnp.asarray(xs[s]),
                                        jnp.int32(s))
            jl.append(np.asarray(logits))
    with _port_policy(), ttrace() as tt, torch.no_grad():
        for s in range(steps):
            logits, tc = tm.decode_step(tp, tc, torch.from_numpy(xs[s]), s)
            tl.append(logits.numpy())
    return np.stack(jl), np.stack(tl), jt, tt


def test_danube_decode_past_the_wrap_matches_forward():
    """Decoding 20 tokens through danube's 8-slot rolling buffer (wrapped
    twice) gives the forward's logits at every position: the window of 8
    the forward applies is what the buffer holds."""
    _, tp = _params("h2o-danube-1.8b")
    _, tcfg = _cfgs("h2o-danube-1.8b")
    toks = torch.from_numpy(_batch(tcfg, s=20)["tokens"])
    m = tbuild(tcfg)
    with _port_policy(), torch.no_grad():
        fwd = m.forward(tp, toks)[0]
        cache = m.init_decode_cache(2, 64, device="cpu")
        assert cache["k"].shape[3] == tcfg.sliding_window == 8
        for t in range(20):
            lg, cache = m.decode_step(tp, cache, toks[:, t:t + 1], t)
            torch.testing.assert_close(lg, fwd[:, t], rtol=DECODE_VS_FORWARD,
                                       atol=DECODE_VS_FORWARD)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_forward(arch):
    """Prefill through the decode path reproduces the forward's last
    logits (``tests/test_models.py::test_decode_matches_forward``)."""
    _, tp = _params(arch)
    _, tcfg = _cfgs(arch)
    batch = _batch(tcfg)
    # Decode gives every M-RoPE stream the token's index: the forward's
    # default positions, identical streams.
    batch.pop("positions", None)
    m = tbuild(tcfg)
    with _port_policy(), torch.no_grad():
        fwd = m.forward(tp, _tbatch(batch))[0]
        cache = m.init_decode_cache(2, 16, device="cpu")
        for t in range(16):
            if tcfg.embed_inputs:
                x = torch.from_numpy(batch["tokens"][:, t:t + 1])
            else:
                x = torch.from_numpy(batch["embeds"][:, t:t + 1])
            lg, cache = m.decode_step(tp, cache, x, t)
    torch.testing.assert_close(lg, fwd[:, -1], rtol=DECODE_VS_FORWARD,
                               atol=DECODE_VS_FORWARD)


class _BlockingJax:
    """``jax`` as the reference's serve module sees it, with every jitted
    step waited for (its ``_run_prefill`` races its token buffer on the
    CPU; ROADMAP Queue 3)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kwargs):
        step = jax.jit(fn, **kwargs)
        return lambda *args: jax.block_until_ready(step(*args))


@pytest.mark.parametrize("mode", ["eager", "graph"])
@pytest.mark.parametrize("arch", SERVED)
def test_serve_batch_greedy_tokens_match_reference(arch, mode, monkeypatch):
    import repro.launch.serve

    monkeypatch.setattr(repro.launch.serve, "jax", _BlockingJax())
    jp, tp = _params(arch)
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, 200, size=6)))
               for _ in range(BATCH)]
    # The reference's serve_batch builds its config by name: hand it the
    # reduced config in this forward mode (smoke=False takes it as it is).
    jcfg, _ = _cfgs(arch, mode)
    real = repro.launch.serve.get_arch
    monkeypatch.setattr(repro.launch.serve, "get_arch",
                        lambda name: jcfg if name == arch else real(name))
    with _ref_policy():
        want = jserve_batch(arch, prompts, smoke=False, max_new_tokens=6,
                            params=jp)
    with _port_policy():
        got = tserve_batch(arch, prompts, max_new_tokens=6, params=tp,
                           device="cpu", forward_mode=mode)
    assert got.tokens.shape == (BATCH, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", SERVED)
def test_cli_serves_the_new_archs(arch, capsys):
    from repro_torch.launch.serve import main

    with ttrace() as tt:
        main(["--arch", arch, "--device", "cpu", "--prompt-len", "2",
              "--max-new", "2"])
    backends = defaultdict(set)
    e = tget_arch(arch).reduced().num_experts
    for r in tt.records:
        # jamba's reduced router (n = 4 experts) is under the gate's 8.
        router = e and r.op == "gemm" and r.shape_key.split(";")[1].endswith(
            f"x{e}:float32")
        backends["router" if router else r.op].add(r.backend)
    ops = ["gemm", "qkv_project", "attention"] + (
        ["moe_expert_ffn"] if e else ["mlp_block"])
    for op in ops:
        assert backends[op] == {"device-kernel"}, (op, backends[op])
    assert backends["router"] == ({"device"} if e else set())
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("arch,match", [("qwen2-vl-72b", "token-input"),
                                        ("hubert-xlarge", "token-input")])
def test_serve_refuses_embedding_input_archs(arch, match):
    """As the reference refuses them: qwen2-vl and hubert take embeddings
    (and hubert is an encoder with no decode step)."""
    from repro_torch.launch.serve import main

    with pytest.raises(ValueError, match=match):
        tserve_batch(arch, [[1, 2]], max_new_tokens=1, device="cpu")
    with pytest.raises(ValueError, match=match):
        jserve_batch(arch, [[1, 2]], max_new_tokens=1)
    with pytest.raises(ValueError, match=match):
        main(["--arch", arch, "--device", "cpu", "--prompt-len", "2",
              "--max-new", "1"])


def test_serve_batch_takes_a_config():
    """``serve_batch`` takes a config in place of a registered name (a
    published config cut in depth to fit the card): the reduced config
    served as itself gives the tokens of serving the name's reduced
    twin."""
    _, tp = _params("qwen2-72b")
    prompts = [[3, 1, 4, 1], [5, 9, 2, 6]] * 4
    with _port_policy():
        by_name = tserve_batch("qwen2-72b", prompts, max_new_tokens=3,
                               params=tp, device="cpu")
        by_cfg = tserve_batch(tget_arch("qwen2-72b").reduced(), prompts,
                              smoke=False, max_new_tokens=3, params=tp,
                              device="cpu")
    np.testing.assert_array_equal(by_cfg.tokens, by_name.tokens)
