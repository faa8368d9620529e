"""Jamba's hybrid stack on the port against the reference: period-8
super-blocks (Mamba sub-layers 0-3 and 5-7, attention at 4, an MoE FFN on
the odd sub-layers), the mixed decode cache (k/v a super-block, SSM and
conv states a Mamba sub-layer), graph mode (blocks captured in the
forward, every FFN eager in decode) and B/C groups repeated over several
heads.  Reduced config in f32; helpers, weights and tolerances are
``tests/test_torch_zoo.py``'s."""

import numpy as np
import torch

from repro.models import build_model as jbuild
from repro_torch.models import build_model as tbuild
from repro_torch.models import forward as TF
from test_torch_zoo import (JAMBA, LOGIT_TOL, TOL, _batch, _cfgs,
                            _decode_both, _jbatch, _params, _port_policy,
                            _ref_policy, _tbatch, _totals)


def test_decode_steps_match_reference():
    jl, tl, jt, tt = _decode_both(JAMBA, 6)
    assert tl.shape == jl.shape == (6, 8, 256)
    assert np.abs(tl - jl).max() <= LOGIT_TOL * np.abs(jl).max()
    ttot = _totals(tt.records)
    assert ttot == _totals(jt.records)
    for op in ("attention", "moe_expert_ffn", "qkv_project"):
        assert (op, "device-kernel") in ttot


def test_decode_writes_the_mixed_cache_in_place():
    """Each super-block's k/v gets the new token's slot; each Mamba
    sub-layer's SSM and conv states move; the cache tensors are the ones
    passed in."""
    _, tp = _params(JAMBA)
    _, tcfg = _cfgs(JAMBA)
    m = tbuild(tcfg)
    cache = m.init_decode_cache(2, 8, device="cpu")
    ids = {k: v.data_ptr() for k, v in cache.items()}
    with _port_policy(), torch.no_grad():
        _, out = m.decode_step(tp, cache, torch.tensor([[3], [5]]), 0)
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == ids
    n_sb = tcfg.num_layers // 8
    for sb in range(n_sb):
        assert out["k"][sb, :, :, 0].abs().sum() > 0
        assert out["k"][sb, :, :, 1:].abs().sum() == 0
        for mi in range(7):
            assert out["ssm"][sb, mi].abs().sum() > 0
            assert out["conv"][sb, mi, :, -1].abs().sum() > 0


def test_graph_decode_keeps_the_hybrid_ffn_eager():
    """In graph mode a hybrid decode runs every FFN eagerly (the
    reference's ``mlp_apply`` / ``moe_ffn``; no ``ffn-block`` graph is
    captured): logits and records equal the reference's graph-mode
    decode, and the logits equal the port's eager decode bit for bit."""
    with TF.capture_reports() as reports:
        jl, tl, jt, tt = _decode_both(JAMBA, 3, "graph")
    assert reports == []
    assert np.abs(tl - jl).max() <= LOGIT_TOL * np.abs(jl).max()
    assert _totals(tt.records) == _totals(jt.records)
    _, tp = _params(JAMBA)
    _, tcfg = _cfgs(JAMBA)
    m = tbuild(tcfg)
    cache = m.init_decode_cache(8, 16, device="cpu")
    xs = np.random.default_rng(0).integers(
        1, tcfg.vocab_size, size=(3, 8, 1)).astype(np.int32)
    with _port_policy(), torch.no_grad():
        for s in range(3):
            lg, cache = m.decode_step(tp, cache, torch.from_numpy(xs[s]), s)
            np.testing.assert_array_equal(lg.numpy(), tl[s])


def test_graph_forward_captures_every_sub_layer():
    """The graph forward captures one block per sub-layer (attention and
    Mamba mixers, dense and MoE FFNs) and equals the eager forward."""
    _, tp = _params(JAMBA)
    _, tcfg = _cfgs(JAMBA, "graph")
    batch = _tbatch(_batch(tcfg))
    with _port_policy(), torch.no_grad(), TF.capture_reports() as reports:
        got, aux = tbuild(tcfg).forward(tp, batch)
    assert len(reports) == tcfg.num_layers
    with _port_policy(), torch.no_grad():
        want, want_aux = tbuild(_cfgs(JAMBA)[1]).forward(tp, batch)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert float(aux) == float(want_aux) > 0


def test_grouped_b_and_c_match_reference():
    """Two B/C groups over 8 SSM heads (rep 4 with groups > 1, as the full
    width's 8 groups over 256 heads): forward and decode against the
    reference."""
    over = dict(ssm_num_groups=2)
    jp, tp = _params(JAMBA, **over)
    jcfg, tcfg = _cfgs(JAMBA, **over)
    assert tcfg.ssm_num_heads // tcfg.ssm_num_groups == 4
    batch = _batch(jcfg)
    with _ref_policy():
        jl, jaux = jbuild(jcfg).forward(jp, _jbatch(batch))
    with _port_policy(), torch.no_grad():
        tl, taux = tbuild(tcfg).forward(tp, _tbatch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    assert abs(float(taux) - float(jaux)) <= TOL * float(jaux)
    jd, td, _, _ = _decode_both(JAMBA, 4, **over)
    assert np.abs(td - jd).max() <= LOGIT_TOL * np.abs(jd).max()
