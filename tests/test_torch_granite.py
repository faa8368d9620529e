"""granite-4.0-h on the port, in float32 on the CPU at a small size: the
configuration file's ``ArchConfig`` (run as the registered hybrid with the
file's fields), the dropless MoE route against a plain per-expert loop, the
new fields at their defaults changing nothing of a yi-6b forward, prefill
and decode through the hybrid cache against the benchmark's plain
reference (``portbench/reference/granitemoehybrid.py``), and graph mode
refusing the new fields."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from portbench import cells, harness
from portbench.conftest import cut
from portbench.weights import layout, make_params, rules
from repro_torch.configs import get_arch
from repro_torch.configs.base import PORT_ONLY_FIELDS
from repro_torch.core.hero import offload_policy
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.obs import metrics

GRANITE = "granite-4.0-h-small"


def _file():
    return cells.load_config(GRANITE)


def _tiny(dtype="float32"):
    """The file cut by its ``cpu_cut`` (one whole period of 10 layers)."""
    cfg = cut(_file(), cells.HERE / "configs" / f"{GRANITE}.json")
    return dict(cfg, torch_dtype=dtype)


def _plain():
    return offload_policy(mode="device", use_kernels=False)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_port_arch_holds_the_published_value_of_every_field_it_reads():
    """Every field the forward reads has the published value, none left
    over from the registered hybrid (jamba) the file starts from."""
    arch = cells.port_arch(_file())
    jamba = get_arch("jamba-1.5-large-398b")
    want = dict(
        d_model=4096, num_layers=20, num_heads=32, num_kv_heads=8,
        head_dim=128, qkv_bias=False, d_ff=1536, moe_d_ff=768,
        num_experts=72, experts_per_token=10, moe_layer_period=1,
        dense_residual=True, moe_dropless=True, attn_layer_period=10,
        attn_layer_offset=5, position_embedding="nope",
        attention_multiplier=0.0078125, embedding_multiplier=12,
        residual_multiplier=0.22, logits_scaling=16, ssm_state_dim=128,
        ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4, ssm_chunk=256,
        ssm_num_groups=1, vocab_size=100352, norm_eps=1e-5,
        tie_embeddings=True, dtype="bfloat16", mlp_kind="swiglu",
        norm_kind="rmsnorm", causal=True, embed_inputs=True,
        sliding_window=0, local_global_period=0, mrope=False,
        forward_mode="eager", family="hybrid")
    for field, value in want.items():
        assert getattr(arch, field) == value, field
    # Jamba's differ where granite's do: nothing carried over.
    assert jamba.ssm_num_groups == 8 and jamba.moe_layer_period == 2
    kinds = _file()["layer_types"]
    assert len(kinds) == arch.num_layers == 20
    assert [arch.layer_kind(i) for i in range(20)] == \
        ["attn" if k == "attention" else "mamba" for k in kinds]
    assert all(arch.layer_is_moe(i) for i in range(20))
    assert arch.ssm_num_heads == _file()["mamba_n_heads"] == 128
    assert arch.d_inner == 8192


def test_graph_mode_refuses_the_new_fields():
    granite = dataclasses.replace(cells.port_arch(_tiny()),
                                  forward_mode="graph")
    with pytest.raises(ValueError, match="forward_mode='eager'"):
        build_model(granite).param_specs()
    yi = get_arch("yi-6b").reduced()
    changed = {"moe_dropless": True, "position_embedding": "nope",
               "attention_multiplier": 0.5, "embedding_multiplier": 2.0,
               "residual_multiplier": 0.5, "logits_scaling": 2.0}
    assert set(changed) == set(PORT_ONLY_FIELDS)
    build_model(dataclasses.replace(yi, forward_mode="graph")).param_specs()
    for field, value in changed.items():
        cfg = dataclasses.replace(yi, forward_mode="graph", **{field: value})
        with pytest.raises(ValueError, match=field):
            build_model(cfg).param_specs()


# ---------------------------------------------------------------------------
# the new fields at their defaults
# ---------------------------------------------------------------------------

class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten ops a forward runs, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _yi_forward(**fields):
    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), **fields)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(3),
                               device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(4))
    with _plain(), torch.no_grad(), _Ops() as ops:
        logits = model.forward(params, tokens)[0]
    return logits, ops.ops, cfg


def test_new_fields_at_their_defaults_change_no_yi_6b_forward():
    """The defaults launch nothing: a multiplier away from 1 adds exactly
    its own multiply (or divide), and at 1 none; a softmax scale written
    out as head_dim ** -0.5 gives the same bits as the default 0."""
    base, ops, cfg = _yi_forward()
    same, same_ops, _ = _yi_forward(
        attention_multiplier=cfg.head_dim ** -0.5, embedding_multiplier=1.0,
        residual_multiplier=1.0, logits_scaling=1.0,
        position_embedding="rope", moe_dropless=False)
    assert torch.equal(base, same) and same_ops == ops
    layers = cfg.num_layers
    for fields, extra in (({"embedding_multiplier": 2.0}, {"mul": 1}),
                          ({"residual_multiplier": 0.5}, {"mul": 2 * layers}),
                          ({"logits_scaling": 2.0}, {"div": 1})):
        _, more, _ = _yi_forward(**fields)
        assert len(more) == len(ops) + sum(extra.values()), fields
        for op, n in extra.items():
            assert more.count(f"aten.{op}") == ops.count(f"aten.{op}") + n


# ---------------------------------------------------------------------------
# the dropless MoE
# ---------------------------------------------------------------------------

def _moe_cfg(k=2, e=4):
    return dataclasses.replace(
        get_arch("qwen3-moe-30b-a3b").reduced(), num_experts=e,
        experts_per_token=k, moe_dropless=True, dense_residual=False)


def _moe_params(cfg, forced: bool, seed=5):
    g = torch.Generator().manual_seed(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {"router": torch.randn(d, e, generator=g) * d ** -0.5,
         "we_gate": torch.randn(e, d, f, generator=g) * d ** -0.5,
         "we_up": torch.randn(e, d, f, generator=g) * d ** -0.5,
         "we_down": torch.randn(e, f, d, generator=g) * f ** -0.5}
    if forced:
        # With positive inputs, expert 0 is every token's first choice and
        # the last expert nobody's.
        p["router"][:, 0] = 1.0
        p["router"][:, -1] = -1.0
    return p


def _per_expert_loop(p, x, cfg):
    """Each expert's rows through its own SwiGLU, weighted by the
    renormalised top-k softmax gates, summed over the token's experts."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf @ p["router"], dim=-1)
    top, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in range(cfg.num_experts):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        h = F.silu(xf[tok] @ p["we_gate"][e]) * (xf[tok] @ p["we_up"][e])
        out.index_add_(0, tok, (h @ p["we_down"][e]) * gates[tok, slot, None])
    return out.reshape(x.shape), torch.bincount(idx.reshape(-1),
                                                minlength=cfg.num_experts)


@pytest.mark.parametrize("forced", [False, True], ids=["ragged", "forced"])
def test_dropless_moe_matches_a_per_expert_loop(forced):
    """Ragged counts; forced: one expert takes a copy of every token (far
    past the capped route's capacity) and one expert none.  Nothing is
    dropped, repeated runs agree bit for bit, and the books hold the
    counts."""
    cfg = _moe_cfg()
    p = _moe_params(cfg, forced)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 24, cfg.d_model, generator=g)
    if forced:
        x = x.abs() + 0.1
    want, counts = _per_expert_loop(p, x, cfg)
    with metrics.collect() as reg, _plain(), torch.no_grad():
        got, _ = M.moe_ffn(p, x, cfg)
        again, _ = M.moe_ffn(p, x, cfg)
    assert torch.equal(got, again)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * float(
        want.abs().max()))
    step = M.last_moe_step()
    assert step.tokens_dropped == 0 and step.counts == tuple(counts.tolist())
    assert step.tokens_routed == 48 * cfg.experts_per_token
    roll = reg.rollup()
    assert roll["moe.tokens_routed"] == 2 * 48 * cfg.experts_per_token
    assert roll["moe.tokens_dropped"] == 0
    assert roll["moe.expert_rows_max"] == int(counts.max())
    if forced:
        assert counts[0] == 48 and counts[-1] == 0
        # The capped route drops copies of the same routing.
        capped = dataclasses.replace(cfg, moe_dropless=False,
                                     moe_dispatch="global")
        with _plain(), torch.no_grad():
            M.moe_ffn(p, x, capped)
        assert M.last_moe_step().tokens_dropped > 0


def test_dropless_route_reaches_the_ragged_expert_gemm(monkeypatch):
    """The descriptor's ragged route: the expert FFN's three products run
    on ``gemm_grouped`` (its plain version on the CPU), over rows sorted by
    expert with offsets that end at T·k."""
    from repro_torch.kernels import gemm as kg

    seen = []
    real = kg.gemm_grouped

    def spy(a, b, offsets, **kw):
        seen.append((tuple(a.shape), tuple(b.shape), offsets.tolist()))
        return real(a, b, offsets, **kw)

    monkeypatch.setattr(kg, "gemm_grouped", spy)
    cfg = _moe_cfg()
    p = _moe_params(cfg, forced=True)
    x = torch.randn(1, 10, cfg.d_model,
                    generator=torch.Generator().manual_seed(2)).abs()
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        M.moe_ffn(p, x, cfg)
    assert [s[:2] for s in seen] == [
        ((20, cfg.d_model), (4, cfg.d_model, cfg.moe_d_ff))] * 2 + [
        ((20, cfg.moe_d_ff), (4, cfg.moe_d_ff, cfg.d_model))]
    offsets = seen[0][2]
    assert offsets[0] == 0 and offsets[-1] == 20
    assert offsets[1] - offsets[0] == 10 and offsets[-1] == offsets[-2]


# ---------------------------------------------------------------------------
# against the plain reference
# ---------------------------------------------------------------------------

def _granite(seed=2 ** 33 + 5):
    cfg = _tiny()
    model = build_model(cells.port_arch(cfg))
    params = make_params(layout(cfg), seed, "cpu", rules(cfg))
    return cfg, model, params


def test_prefill_then_decode_through_the_hybrid_cache_match_the_reference():
    """A forward over 8 tokens, and the same 8 fed one by one through the
    decode step (the serve loop's prefill) then 4 more decode steps, each
    against the reference's full forward over all 12 tokens."""
    cfg, model, params = _granite()
    tokens = torch.randint(0, cfg["vocab_size"], (2, 12),
                           generator=torch.Generator().manual_seed(9))
    want = harness.reference_of(cfg).forward(params, tokens, cfg)
    scale = float(want.abs().max())
    with _plain(), torch.no_grad():
        prefill = model.forward(params, tokens[:, :8])[0]
        cache = model.init_decode_cache(2, 16, device="cpu")
        steps = []
        for i in range(12):
            logits, cache = model.decode_step(params, cache,
                                              tokens[:, i:i + 1], i)
            steps.append(logits)
    assert float((prefill - want[:, :8]).abs().max()) <= 2e-5 * scale
    got = torch.stack(steps, dim=1)
    assert float((got - want).abs().max()) <= 2e-5 * scale
