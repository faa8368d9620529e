"""Expert placement in the port against the reference: the policy, its
seeded Zipf workload and sweep (``platform="tpu-v5e"`` pinned: the port
defaults to ``h100-sxm``), the cluster's replica handles and per-expert
fan-out, ``dispatch_placed(placement=...)``, and the placed MoE layer,
which equals the unplaced one bit for bit.

Everything compared here is modeled, pure Python: equal means equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import accounting as jacct
from repro.core import hero as jhero
from repro.core import placement as JP
from repro.models import moe as JM
from repro_torch.configs import get_arch as tget_arch
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import accounting as tacct
from repro_torch.core import blas as tblas
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import hero as thero
from repro_torch.core import placement as TP
from repro_torch.kernels.gemm import gemm_batched
from repro_torch.models import moe as TM

ARCH = "qwen3-moe-30b-a3b"
V5E = "tpu-v5e"


def _ticket(t):
    return (t.op, t.shape_key, t.kind, t.issue_s, t.copy_done_s,
            t.complete_s)


def _record(r):
    return (r.op, r.shape_key, r.dtype, r.backend, r.device_id, r.note,
            r.count, dataclasses.astuple(r.regions), r.resident_fraction)


def _run_pair(**kw):
    want = JP.run_skewed_workload(**kw)
    got = TP.run_skewed_workload(**kw, platform=V5E)
    return got, want


@pytest.mark.parametrize("zipf_s,seed,dynamic", [
    (1.2, 0, True), (1.2, 0, False), (1.8, 0, True), (0.6, 7, True),
    (1.2, 11, True)])
def test_run_skewed_workload_matches_reference(zipf_s, seed, dynamic):
    got, want = _run_pair(zipf_s=zipf_s, seed=seed, dynamic=dynamic,
                          steps=48)
    for field in ("makespan_s", "migrations", "replications",
                  "tokens_routed", "tokens_processed", "tokens_dropped",
                  "decision_log", "num_lanes"):
        assert getattr(got, field) == getattr(want, field), field
    assert ([dataclasses.astuple(e) for e in got.migration_edges]
            == [dataclasses.astuple(e) for e in want.migration_edges])
    assert got.ticket_streams.keys() == want.ticket_streams.keys()
    for lane, tickets in want.ticket_streams.items():
        assert [_ticket(t) for t in got.ticket_streams[lane]] == [
            _ticket(t) for t in tickets]
    assert got.tokens_routed == got.tokens_processed + got.tokens_dropped


def test_replication_fires_and_dynamic_beats_static():
    """The reference's headline laws hold in the port (tests/
    test_expert_placement.py)."""
    got_dyn, _ = _run_pair(zipf_s=1.8, seed=0, dynamic=True)
    got_stat, _ = _run_pair(zipf_s=1.8, seed=0, dynamic=False)
    assert got_dyn.replications >= 1
    assert got_dyn.tokens_dropped < got_stat.tokens_dropped
    dyn, _ = _run_pair(zipf_s=1.2, seed=0, dynamic=True)
    stat, _ = _run_pair(zipf_s=1.2, seed=0, dynamic=False)
    assert stat.makespan_s / dyn.makespan_s >= 1.2
    for edge in dyn.migration_edges:
        assert edge.migrate_issue_s >= edge.src_drain_s - 1e-9


def test_placement_sweep_matches_reference():
    import json

    kw = dict(zipf_points=(0.6, 1.2), steps=24, tokens_per_step=512)
    got = TP.placement_sweep(**kw, platform=V5E)
    assert got == JP.placement_sweep(**kw)
    json.dumps(got)
    assert TP.placement_sweep(**kw)["platform"] == "h100-sxm"


def test_zipf_and_token_split_match_reference():
    import random

    for e, s in ((16, 1.2), (128, 0.6), (5, 1.8)):
        assert TP.zipf_shares(e, s) == JP.zipf_shares(e, s)
        assert (TP.zipf_histogram(random.Random(3), e, s, 777)
                == JP.zipf_histogram(random.Random(3), e, s, 777))
    for args in ((1000, 2, 256), (100, 2, 256), (7, 1, None), (5, 3, 1)):
        assert TP._split_tokens(*args) == JP._split_tokens(*args)


def _policy_pair(e=8, **cfg_kw):
    """(port, reference) policies attached over 4 fresh tpu-v5e lanes,
    with the scopes left open for the caller."""
    jscope = jhero.offload_policy(mode="device", platform=V5E, num_devices=4)
    tscope = thero.offload_policy(mode="device", platform=V5E, num_devices=4)
    jpol = JP.ExpertPlacementPolicy(JP.PlacementConfig(num_experts=e,
                                                       **cfg_kw),
                                    jscope.__enter__())
    tpol = TP.ExpertPlacementPolicy(TP.PlacementConfig(num_experts=e,
                                                       **cfg_kw),
                                    tscope.__enter__())
    jpol.attach()
    tpol.attach()
    return (tpol, tscope), (jpol, jscope)


def test_hysteresis_and_plan_match_reference():
    e, tokens = 16, 1024
    hot = [tokens - 15 * 20] + [20] * (e - 1)
    cold = [20] + [(tokens - 20) // (e - 1)] * (e - 1)
    (tpol, ts), (jpol, js) = _policy_pair(e)
    try:
        for i in range(64):
            h = hot if i % 2 == 0 else cold
            assert ([d.key for d in tpol.step(h)]
                    == [d.key for d in jpol.step(h)])
        tplan, jplan = tpol.plan(hot, capacity=96), jpol.plan(hot, capacity=96)
        assert tpol.counters() == jpol.counters()
        assert tpol.home == jpol.home and tpol.share == jpol.share
    finally:
        ts.__exit__(None, None, None)
        js.__exit__(None, None, None)
    moves = [d for d in tpol.decisions if d.kind == "migrate" and
             d.expert == 0]
    assert len(moves) <= 1
    assert ([dataclasses.astuple(s) for s in tplan.sub_launches]
            == [dataclasses.astuple(s) for s in jplan.sub_launches])
    assert (tplan.tokens_routed, tplan.tokens_processed, tplan.tokens_dropped,
            tplan.dropped_by_expert, tplan.capacity) == (
        jplan.tokens_routed, jplan.tokens_processed, jplan.tokens_dropped,
        jplan.dropped_by_expert, jplan.capacity)


def test_replicate_handle_and_launch_fanout_records_match_reference():
    """``replicate_handle`` / ``replicas_of`` and the per-expert fan-out of
    a plan over a replicated expert write the reference's records."""
    e = 8
    out = {}
    for name, hero, acct, pmod in (("t", thero, tacct, TP),
                                   ("j", jhero, jacct, JP)):
        with hero.offload_policy(mode="device", platform=V5E,
                                 num_devices=4) as cluster, \
                acct.offload_trace() as trace:
            pol = pmod.ExpertPlacementPolicy(
                pmod.PlacementConfig(num_experts=e), cluster)
            pol.attach()
            home = pol.home[0]
            lane = next(x for x in pol.lanes if x != home)
            replica = cluster.replicate_handle(pol.handles[0], lane)
            again = cluster.replicate_handle(pol.handles[0], lane)
            pol.replica_lanes[0].append(lane)
            plan = pol.plan([1000] + [10] * (e - 1), capacity=256)
            launch = cluster.launch_fanout(plan.sub_launches, dtype="bfloat16",
                                           note="fan-out")
            out[name] = dict(
                replica=(replica.name, replica.device_id, replica.nbytes,
                         replica.replica_of, replica.is_replica,
                         again is replica),
                replicas=[h.name for h in cluster.replicas_of(
                    pol.handles[0].name)],
                primary=pol.handles[0].is_replica,
                launch=(str(launch), launch.device_id),
                records=[_record(r) for r in trace.records],
                streams={d.device_id: [_ticket(t) for t in d.inflight]
                         for d in cluster.devices})
            with pytest.raises(ValueError, match="already lives"):
                cluster.replicate_handle(pol.handles[0], home)
    assert out["t"] == out["j"]
    assert out["t"]["replica"][3:] == ("moe/expert0", True, True)
    assert out["t"]["records"][0][5] == (
        f"handle replication 0->{out['t']['replica'][1]}")


def test_launch_fanout_names_the_kernel_when_the_policy_enables_it():
    """A departure: the reference's fan-out always names ``device`` and
    lowers on its plain form; the port's names ``device-kernel`` when the
    policy enables the kernels and the op is eligible, and the placed
    math runs the kernel lowering, as the unplaced call does."""
    with thero.offload_policy(mode="device", platform=V5E, num_devices=4,
                              use_kernels=True) as cluster, \
            tacct.offload_trace() as trace:
        pol = TP.ExpertPlacementPolicy(TP.PlacementConfig(num_experts=4),
                                       cluster)
        pol.attach()
        plan = pol.plan([9, 9, 9, 9], capacity=16)
        launch = cluster.launch_fanout(plan.sub_launches,
                                       kernel_eligible=True)
        plain = cluster.launch_fanout(plan.sub_launches)
    assert launch.backend == "device-kernel" and plain.backend == "device"
    assert {r.backend for r in trace.records} == {"device-kernel", "device"}


def test_dispatch_placed_with_a_plan_fans_out_and_lowers_once():
    e, c, d, f = 4, 8, 32, 24
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(e, 2, c, d, generator=gen)
    ws = [torch.randn(*s, generator=gen) * 0.2
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    with thero.offload_policy(mode="device", platform=V5E, num_devices=4,
                              use_kernels=True) as cluster, \
            tacct.offload_trace() as trace:
        pol = TP.ExpertPlacementPolicy(
            TP.PlacementConfig(num_experts=e, d_model=d, d_ff=f), cluster)
        pol.attach()
        plan = pol.plan([16, 8, 4, 4], capacity=2 * c)
        before = gemm_batched.launches
        want = tblas.moe_expert_ffn(x, *ws)
        got, launch = tblas.moe_expert_ffn_placed(x, *ws, placement=plan)
    assert torch.equal(got, want)
    assert launch.backend == "device-kernel"
    assert launch.device_id in pol.lanes
    fanned = [r for r in trace.records if r.note.startswith("expert-placed")]
    assert len(fanned) == len(plan.sub_launches) == 4
    assert {r.device_id for r in fanned} == set(pol.home)
    # CPU tensors: the wrapper's plain version, counted nowhere.
    assert gemm_batched.launches == before
    # validate=True runs the graph checks first: a clean call lowers as
    # before, operands that disagree raise before anything is recorded.
    from repro_torch.analysis.graph import GraphVerificationError

    checked, _ = tdispatch.dispatch_placed("moe_expert_ffn", x, *ws,
                                           validate=True)
    assert torch.equal(checked, want)
    with tacct.offload_trace() as trace, \
            pytest.raises(GraphVerificationError, match="shape-mismatch"):
        tdispatch.dispatch_placed("moe_expert_ffn", x[..., :-1], *ws,
                                  validate=True)
    assert trace.records == []


def _moe_setup(b=2, s=8, seed=0):
    cfg = dataclasses.replace(jget_arch(ARCH).reduced(),
                              moe_dispatch="grouped")
    jp = JM.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                     (b, s, cfg.d_model)) * 0.3)
    tcfg = dataclasses.replace(tget_arch(ARCH).reduced(),
                               moe_dispatch="grouped")
    return tcfg, tp, torch.from_numpy(np.array(x))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("policy", ["none", "disabled", "enabled"])
def test_placed_equals_unplaced_bit_for_bit(policy, use_kernels):
    """``moe_ffn_placed`` equals ``moe_ffn(moe_dispatch="grouped")`` bit for
    bit with no policy, a disabled one and a live one (which fans the
    expert FFN out over more than one lane)."""
    cfg, p, x = _moe_setup(b=4, s=16)
    with thero.offload_policy(mode="device", platform=V5E, num_devices=4,
                              use_kernels=use_kernels) as cluster, \
            torch.no_grad():
        want, aux_want = TM.moe_ffn(p, x, cfg)
        pol = None
        if policy != "none":
            pol = TP.ExpertPlacementPolicy(
                TP.PlacementConfig(num_experts=cfg.num_experts,
                                   enabled=policy == "enabled"), cluster)
            pol.attach()
        got, aux_got = TM.moe_ffn_placed(p, x, cfg, policy=pol)
        fanned = {d.device_id for d in cluster.devices for t in d.inflight
                  if t.op == "moe_expert_ffn"}
    assert torch.equal(got, want)
    assert torch.equal(aux_got, aux_want)
    if policy == "enabled":
        assert len(fanned) > 1
        assert pol.counters()["tokens_routed"] == 0   # plan(record=False)


def test_placed_layer_matches_reference_placed_layer():
    """The port's placed layer against the reference's on the same inputs
    (2e-4, tests/test_moe.py), and the two policies' decisions equal."""
    cfg = dataclasses.replace(jget_arch(ARCH).reduced(),
                              moe_dispatch="grouped")
    jp = JM.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model)) * 0.3
    tcfg, tp, tx = _moe_setup(b=4, s=16)
    (tpol, ts), (jpol, js) = _policy_pair(cfg.num_experts)
    try:
        want, _ = JM.moe_ffn_placed(jp, x, cfg, policy=jpol)
        got, _ = TM.moe_ffn_placed(tp, tx, tcfg, policy=tpol)
    finally:
        ts.__exit__(None, None, None)
        js.__exit__(None, None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert tpol.share == jpol.share and tpol.home == jpol.home
    assert tpol.decision_log == jpol.decision_log
