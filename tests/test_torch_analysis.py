"""``repro_torch.analysis`` against ``repro.analysis``.

Part 1 twins each test of ``tests/test_analysis_races.py`` (the
happens-before checker over ``LaunchTicket`` streams), of
``tests/test_analysis_graph.py`` (the ``hnp`` graph verifier and the
``validate=True`` surfaces) and the two race-rule tests of
``tests/test_expert_placement.py`` on the port, on the CPU
(``device="cpu"`` leaves, the plain lowerings).

Part 2 runs each seeded hazard through both packages (platform pinned to
``tpu-v5e``, the reference's default) and holds the list of
``Violation.rule`` equal, in order; clean runs give no violation in
either.  Each scenario is one function over a package namespace, so the
twin and the parity test run the same seeded corruption.
"""

import dataclasses
import re
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
import repro.hnp as jhnp
import repro_torch.core as tcore
import repro_torch.hnp as thnp
from repro.analysis import graph as JG
from repro.analysis import races as JR
from repro.core import dispatch as jdispatch
from repro.core import placement as JP
from repro.frontend import lazy as jlazy
from repro_torch.analysis import Violation
from repro_torch.analysis import graph as TG
from repro_torch.analysis import races as TR
from repro_torch.analysis.graph import (
    GraphVerificationError,
    WavePlan,
    check_plan,
    collect_nodes,
    plan_waves,
    verify_call,
    verify_graph,
)
from repro_torch.analysis.races import (
    StreamRaceError,
    assert_race_free,
    check_cluster,
    check_expert_migrations,
    check_ticket_streams,
    ticket_streams,
)
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import placement as TP
from repro_torch.frontend import lazy as tlazy


def _pkg(name, platform):
    """What a scenario needs from one package."""
    if name == "ref":
        return types.SimpleNamespace(
            name=name, hnp=jhnp, engine=jcore.engine, races=JR, graph=JG,
            dispatch=jdispatch, placement=JP, Node=jlazy.Node,
            array=jhnp.array, tensor=lambda x: x,
            dtype=lambda name: np.dtype(name),
            policy=lambda **kw: jcore.offload_policy(platform="tpu-v5e",
                                                     **kw))
    return types.SimpleNamespace(
        name=name, hnp=thnp, engine=tcore.engine, races=TR, graph=TG,
        dispatch=tdispatch, placement=TP, Node=tlazy.Node,
        array=lambda x: thnp.array(x, device="cpu"),
        tensor=torch.from_numpy,
        dtype=lambda name: getattr(torch, name),
        policy=lambda **kw: tcore.offload_policy(
            **({"platform": platform} if platform else {}), **kw))


# The port on its own default platform (the twins), and both packages
# pinned to the reference's default (the parity tests).
PORT = _pkg("port", None)
REF, PORT_V5E = _pkg("ref", None), _pkg("port", "tpu-v5e")


def rules(violations):
    return {v.rule for v in violations}


def rule_list(violations):
    return [v.rule for v in violations]


@pytest.fixture(autouse=True)
def _clean_engines():
    for p in (REF, PORT):
        p.engine().reset()
    yield
    for p in (REF, PORT):
        p.engine().reset()


# ---------------------------------------------------------------------------
# Race scenarios
# ---------------------------------------------------------------------------

def _run_workload(p, **policy):
    """Force a two-wave hnp workload; return the live per-device streams."""
    p.engine().reset()
    kw = dict(mode="device", num_devices=2, scheduler="cost-aware")
    kw.update(policy)
    with p.policy(**kw):
        with p.hnp.offload_region("races"):
            a = p.array(np.ones((128, 96), np.float32))
            w1 = np.ones((96, 128), np.float32)
            w2 = np.ones((128, 64), np.float32)
            h = p.hnp.tanh(a @ w1)
            p.hnp.asnumpy(h @ w2)
        return p.races.ticket_streams()


def _seed(streams, dev_key, idx, **replace):
    out = {k: list(v) for k, v in streams.items()}
    out[dev_key][idx] = dataclasses.replace(out[dev_key][idx], **replace)
    return out


def _first(streams):
    dev = next(k for k in sorted(streams) if streams[k])
    return dev, streams[dev][0]


def race_compute_before_copy_ready(p):
    streams = _run_workload(p)
    dev, t = _first(streams)
    bad = _seed(streams, dev, 0, compute_start_s=t.copy_ready_s - 0.25)
    return dev, p.races.check_ticket_streams(bad)


def race_complete_before_copy_done(p):
    streams = _run_workload(p)
    dev, t = _first(streams)
    bad = _seed(streams, dev, 0, complete_s=t.copy_done_s - 0.25)
    return p.races.check_ticket_streams(bad)


def race_dma_clock(p):
    streams = _run_workload(p, num_devices=1)
    dev = next(k for k, v in streams.items() if len(v) >= 2)
    first = streams[dev][0]
    bad = _seed(streams, dev, 1, issue_s=first.copy_done_s - 1.0)
    return p.races.check_ticket_streams(bad)


def race_compute_clock(p):
    streams = _run_workload(p, num_devices=1)
    dev = next(k for k, v in streams.items() if len(v) >= 2)
    first = streams[dev][0]
    bad = _seed(streams, dev, 1,
                compute_start_s=first.complete_s - 1.0,
                copy_ready_s=first.complete_s - 1.0,
                issue_s=first.complete_s - 1.0)
    return p.races.check_ticket_streams(bad)


def race_read_before_copy_done(p):
    streams = _run_workload(p, prefetch_staging=True, num_devices=1)
    target = None
    for dev, tickets in streams.items():
        for i, t in enumerate(tickets):
            if t.kind == "prefetch" and any(
                u.kind == "launch" for u in tickets[i + 1:]
            ):
                target = (dev, i, t)
    assert target is not None, "workload must prefetch ahead of a launch"
    dev, i, s = target
    assert p.races.check_ticket_streams(streams) == []
    bad = _seed(streams, dev, i, copy_done_s=s.copy_done_s + 100.0,
                complete_s=s.complete_s + 100.0)
    return p.races.check_ticket_streams(bad)


def race_resident_charged_dma(p):
    streams = _run_workload(p)
    dev, t = _first(streams)
    assert t.copy_done_s > t.issue_s        # it really did stage bytes
    bad = _seed(streams, dev, 0, resident_fraction=1.0)
    return p.races.check_ticket_streams(bad)


def race_device_mismatch(p):
    streams = _run_workload(p)
    dev, _ = _first(streams)
    bad = _seed(streams, dev, 0, device_id=dev + 5)
    return p.races.check_ticket_streams(bad)


def race_migration_before_drain(p):
    bad = p.placement.MigrationEdge(
        expert=3, handle_name="moe/expert3", src_device=0, dst_device=2,
        migrate_issue_s=1.0, src_drain_s=2.0,
    )
    return p.races.check_expert_migrations([bad])


RACE_HAZARDS = {
    "compute-before-copy-ready":
        lambda p: race_compute_before_copy_ready(p)[1],
    "complete-before-copy-done": race_complete_before_copy_done,
    "dma-clock-monotone": race_dma_clock,
    "compute-clock-monotone": race_compute_clock,
    "read-before-copy-done": race_read_before_copy_done,
    "resident-charged-dma": race_resident_charged_dma,
    "device-mismatch": race_device_mismatch,
    "expert-migrate-before-drain": race_migration_before_drain,
}


# ---------------------------------------------------------------------------
# Part 1a — twins of tests/test_analysis_races.py
# ---------------------------------------------------------------------------

def test_serial_workload_is_race_free():
    streams = _run_workload(PORT, pipeline_staging=False)
    assert sum(len(v) for v in streams.values()) > 0
    assert check_ticket_streams(streams) == []


def test_pipelined_prefetch_workload_is_race_free():
    streams = _run_workload(PORT, pipeline_staging=True,
                            prefetch_staging=True)
    assert check_ticket_streams(streams) == []
    kinds = {t.kind for v in streams.values() for t in v}
    assert "launch" in kinds


def test_d2d_migration_edges_are_race_free():
    with PORT.policy(mode="device", num_devices=2):
        eng = tcore.engine()
        h = eng.pin_handle("mig", 1 << 20, device_id=0)
        eng.migrate_handle(h, 1)
        streams = ticket_streams()
    kinds = {t.kind for v in streams.values() for t in v}
    assert "d2d" in kinds
    assert check_ticket_streams(streams) == []


def test_failure_requeue_is_race_free():
    with PORT.policy(mode="device", num_devices=2):
        with thnp.offload_region("ft"):
            a = PORT.array(np.ones((64, 64), np.float32))
            thnp.asnumpy(a @ a)
        eng = tcore.engine()
        eng.fail_device(0 if eng.devices[0].inflight else 1)
        streams = ticket_streams()
    assert check_ticket_streams(streams) == []


def test_fully_resident_launch_charges_zero_dma():
    with PORT.policy(mode="device", num_devices=1):
        x = torch.ones(64, 64)
        eng = tcore.engine()
        h = eng.pin_handle("res", float(3 * x.nbytes), device_id=0)
        tdispatch.dispatch("matmul", x, x, handle=h, resident_fraction=1.0)
        streams = ticket_streams()
    launches = [t for v in streams.values() for t in v if t.kind == "launch"]
    assert launches and launches[0].resident_fraction >= 1.0
    assert launches[0].copy_done_s == pytest.approx(launches[0].issue_s)
    assert check_ticket_streams(streams) == []


def test_check_cluster_reads_live_engine():
    with PORT.policy(mode="device", num_devices=2):
        with thnp.offload_region("live"):
            a = PORT.array(np.ones((64, 64), np.float32))
            thnp.asnumpy(a @ a)
        assert check_cluster() == []
        assert_race_free()


def test_injected_compute_before_copy_ready():
    dev, v = race_compute_before_copy_ready(PORT)
    assert "race/compute-before-copy-ready" in rules(v)
    assert any(f"dev{dev}[0]" in x.where for x in v)


def test_injected_complete_before_copy_done():
    v = race_complete_before_copy_done(PORT)
    assert "race/complete-before-copy-done" in rules(v)


def test_injected_non_monotone_dma_clock():
    v = race_dma_clock(PORT)
    assert "race/dma-clock-monotone" in rules(v)
    assert any("->" in x.where for x in v)  # reports the ticket chain


def test_injected_non_monotone_compute_clock():
    assert "race/compute-clock-monotone" in rules(race_compute_clock(PORT))


def test_injected_launch_outrunning_prefetch_copy():
    v = race_read_before_copy_done(PORT)
    assert "race/read-before-copy-done" in rules(v)
    assert any("prefetch" in x.where for x in v)


def test_injected_resident_launch_charging_dma():
    v = race_resident_charged_dma(PORT)
    assert "race/resident-charged-dma" in rules(v)


def test_injected_device_mismatch():
    assert "race/device-mismatch" in rules(race_device_mismatch(PORT))


def test_assert_race_free_raises_with_named_rule():
    streams = _run_workload(PORT)
    dev, t = _first(streams)
    bad = _seed(streams, dev, 0, compute_start_s=t.copy_ready_s - 0.25)
    with pytest.raises(StreamRaceError) as exc:
        assert_race_free(bad)
    assert "race/compute-before-copy-ready" in str(exc.value)
    assert exc.value.flight is not None   # the recorder's window rides along


@settings(max_examples=10, deadline=None)
@given(
    st.integers(min_value=1, max_value=3),
    st.booleans(),
    st.sampled_from(["least-loaded", "round-robin", "cost-aware"]),
)
def test_random_topologies_are_race_free(num_devices, prefetch, scheduler):
    streams = _run_workload(
        PORT,
        num_devices=num_devices,
        prefetch_staging=prefetch,
        scheduler=scheduler,
    )
    assert check_ticket_streams(streams) == []


# ---------------------------------------------------------------------------
# Part 1b — twins of tests/test_expert_placement.py's race-rule tests
# ---------------------------------------------------------------------------

def test_skewed_workload_is_race_free():
    r = TP.run_skewed_workload(zipf_s=1.2, seed=0, dynamic=True)
    assert r.migration_edges
    assert check_ticket_streams(r.ticket_streams) == []
    assert check_expert_migrations(r.migration_edges) == []
    for edge in r.migration_edges:
        assert edge.migrate_issue_s >= edge.src_drain_s - 1e-9


def test_migration_race_rule_flags_early_d2d():
    v = race_migration_before_drain(PORT)
    assert len(v) == 1
    assert v[0].rule == "race/expert-migrate-before-drain"


# ---------------------------------------------------------------------------
# Graph scenarios (host mode, as tests/test_analysis_graph.py runs them)
# ---------------------------------------------------------------------------

def _gemm_chain(p):
    a = p.array(np.ones((8, 6), np.float32))
    b = p.array(np.ones((6, 4), np.float32))
    return a, b, p.hnp.tanh(a @ b) + 1.0


def _diamond(p):
    a = p.array(np.ones((8, 8), np.float32))
    y = p.hnp.tanh(a @ a)
    z = y @ a                              # heavy consumer of tanh
    w = p.hnp.relu(y)                      # elementwise consumer of tanh
    return a, y, z, w


def graph_shape_mismatch(p):
    _, _, y = _gemm_chain(p)
    y.node.inputs[0].shape = (99, 99)
    return p.graph.verify_graph([y.node])


def graph_dtype_mismatch(p):
    a, _, _ = _gemm_chain(p)
    z = a + a
    z.node.dtype = p.dtype("float64")
    return p.graph.verify_graph([z.node])


def graph_stale_value(p):
    a, _, _ = _gemm_chain(p)
    z = a + a
    z.node.set_value(p.tensor(np.zeros((8, 6), np.float32)))
    assert p.graph.verify_graph([z.node]) == []   # cache over live inputs
    g = p.hnp.tanh(a)                      # unevaluated producer
    z.node.inputs = (g.node, g.node)       # spliced under the cached consumer
    return p.graph.verify_graph([z.node])


def graph_unknown_op(p):
    a, _, _ = _gemm_chain(p)
    bogus = p.Node("frobnicate", (a.node,), {}, (8, 6), p.dtype("float32"))
    return p.graph.verify_graph([bogus])


def graph_bad_arity(p):
    a, _, _ = _gemm_chain(p)
    bad = p.Node("add", (a.node,), {}, (8, 6), p.dtype("float32"))
    return p.graph.verify_graph([bad])


def graph_use_after_unstage(p):
    eng = p.engine()
    h = eng.pin_handle("uau", 4096.0, device_id=0)
    a = p.array(np.ones((4, 4), np.float32))
    a.node.attrs["handle"] = h
    eng.unstage_handle(h)
    return p.graph.verify_graph([(a @ a).node])


def graph_handle_escapes(p):
    eng = p.engine()
    h = eng.pin_handle("esc", 4096.0, device_id=0)
    a = p.array(np.ones((4, 4), np.float32))
    a.node.attrs["handle"] = h
    eng._handles.pop("esc")               # ledger forgets it; token stays valid
    return p.graph.verify_graph([(a @ a).node])


def graph_double_stage(p):
    eng = p.engine()
    x = np.ones((4, 4), np.float32)
    a = p.array(x)
    b = p.array(x)                        # same underlying buffer, new leaf
    b.node.set_value(a.node.value)        # unify the buffers explicitly
    a.node.attrs["handle"] = eng.pin_handle("h1", 64.0, device_id=0)
    b.node.attrs["handle"] = eng.pin_handle("h2", 64.0, device_id=0)
    return p.graph.verify_graph([(a @ b).node])


def graph_raw_in_wave(p):
    _, _, z, w = _diamond(p)
    plan = p.graph.plan_waves([z.node, w.node])
    flat = [[n for wave in plan.waves for n in wave]]   # everything in wave 0
    return p.graph.check_plan(p.graph.WavePlan(plan.order, flat, {}, [], []))


def graph_raw_in_stack(p):
    _, _, z, w = _diamond(p)
    plan = p.graph.plan_waves([z.node, w.node])
    heavy = [n for n in plan.order if n.op.startswith("registry:")]
    assert len(heavy) == 2
    return p.graph.check_plan(
        p.graph.WavePlan(plan.order, plan.waves, plan.chains, [heavy], []))


def graph_war(p):
    _, _, z, w = _diamond(p)
    plan = p.graph.plan_waves([z.node, w.node])
    order = plan.order
    gemm1 = min((n for n in order if n.op.startswith("registry:")),
                key=lambda n: n.id)
    tanh = next(n for n in order if n.op == "tanh")
    relu = next(n for n in order if n.op == "relu")
    corrupted = {gemm1.id: [tanh, relu]}  # fuses tanh although z still reads it
    return p.graph.check_plan(
        p.graph.WavePlan(order, plan.waves, corrupted, [], []))


def graph_cycle(p):
    _, _, z, w = _diamond(p)
    plan = p.graph.plan_waves([z.node, w.node])
    return p.graph.check_plan(
        p.graph.WavePlan(plan.order, [], {}, [], plan.order[:1]))


def graph_region_validate(p):
    with p.hnp.offload_region("seeded", validate=True):
        a = p.array(np.ones((8, 6), np.float32))
        b = p.array(np.ones((6, 4), np.float32))
        y = a @ b
        y.node.shape = (123, 456)          # corrupt before forcing
        with pytest.raises(p.graph.GraphVerificationError) as exc:
            p.hnp.asnumpy(y)
    return exc.value.violations


def graph_dispatch_bad_operands(p):
    with pytest.raises(p.graph.GraphVerificationError) as exc:
        p.dispatch.dispatch_placed(
            "gemm",
            p.tensor(np.ones((4, 3), np.float32)),
            p.tensor(np.ones((5, 2), np.float32)),   # inner dims disagree
            validate=True,
        )
    return exc.value.violations


def graph_dispatch_unknown_op(p):
    with pytest.raises(p.graph.GraphVerificationError) as exc:
        p.dispatch.dispatch_placed("no_such_op", validate=True)
    return exc.value.violations


def graph_dead_handle(p):
    eng = p.engine()
    h = eng.pin_handle("dead", 1024.0, device_id=0)
    eng.unstage_handle(h)
    return p.graph.verify_call(
        "gemm",
        (p.tensor(np.ones((4, 3), np.float32)),
         p.tensor(np.ones((3, 2), np.float32))),
        handle=h,
    )


GRAPH_HAZARDS = {
    "shape-mismatch": graph_shape_mismatch,
    "dtype-mismatch": graph_dtype_mismatch,
    "stale-value": graph_stale_value,
    "unknown-op": graph_unknown_op,
    "bad-arity": graph_bad_arity,
    "use-after-unstage": graph_use_after_unstage,
    "handle-escapes-region": graph_handle_escapes,
    "double-stage": graph_double_stage,
    "raw-in-wave": graph_raw_in_wave,
    "raw-in-stack": graph_raw_in_stack,
    "war": graph_war,
    "cycle": graph_cycle,
    "region-validate": graph_region_validate,
    "dispatch-bad-operands": graph_dispatch_bad_operands,
    "dispatch-unknown-op": graph_dispatch_unknown_op,
    "dispatch-dead-handle": graph_dead_handle,
}


@pytest.fixture
def host_mode():
    """The graph tests' setting: both engines fresh, in host mode."""
    for p in (REF, PORT):
        p.engine().reset()
    with jcore.offload_policy(mode="host"), tcore.offload_policy(mode="host"):
        yield


# ---------------------------------------------------------------------------
# Part 1c — twins of tests/test_analysis_graph.py
# ---------------------------------------------------------------------------

def test_clean_graph_verifies_clean(host_mode):
    _, _, y = _gemm_chain(PORT)
    assert verify_graph([y.node]) == []


def test_clean_region_validates_and_matches_reference(host_mode):
    x = np.asarray(np.random.default_rng(0).normal(size=(32, 16)), np.float32)
    w = np.asarray(np.random.default_rng(1).normal(size=(16, 8)), np.float32)
    with thnp.offload_region("validated", validate=True):
        got = thnp.asnumpy(thnp.tanh(PORT.array(x) @ w))
    np.testing.assert_allclose(got, np.tanh(x @ w), rtol=1e-5, atol=1e-5)


def test_collect_nodes_covers_evaluated_subgraph(host_mode):
    a, b, y = _gemm_chain(PORT)
    ids = {n.id for n in collect_nodes([y.node])}
    assert a.node.id in ids and b.node.id in ids and y.node.id in ids


@settings(max_examples=10, deadline=None)
@given(
    st.tuples(st.integers(min_value=1, max_value=9),
              st.integers(min_value=1, max_value=9),
              st.integers(min_value=1, max_value=9)),
    st.one_of(st.just("tanh"), st.just("relu"), st.just("exp")),
)
def test_random_clean_graphs_verify_clean(dims, act):
    m, k, n = dims
    with tcore.offload_policy(mode="host"):
        a = PORT.array(np.ones((m, k), np.float32))
        b = PORT.array(np.ones((k, n), np.float32))
        y = getattr(thnp, act)(a @ b)
        assert verify_graph([y.node]) == []


def test_seeded_shape_mismatch_is_named(host_mode):
    assert "graph/shape-mismatch" in rules(graph_shape_mismatch(PORT))


def test_seeded_dtype_mismatch_is_named(host_mode):
    assert "graph/dtype-mismatch" in rules(graph_dtype_mismatch(PORT))
    # a numpy dtype written onto a node compares through torch_dtype
    a, _, _ = _gemm_chain(PORT)
    z = a + a
    z.node.dtype = np.dtype(np.float64)
    assert "graph/dtype-mismatch" in rules(verify_graph([z.node]))
    z.node.dtype = np.dtype(np.float32)
    assert verify_graph([z.node]) == []


def test_stale_cached_value_is_named(host_mode):
    assert "graph/stale-value" in rules(graph_stale_value(PORT))


def test_unknown_op_is_named(host_mode):
    assert "graph/unknown-op" in rules(graph_unknown_op(PORT))


def test_bad_arity_is_named(host_mode):
    assert "graph/bad-arity" in rules(graph_bad_arity(PORT))


def test_use_after_unstage_is_named(host_mode):
    v = graph_use_after_unstage(PORT)
    assert "graph/use-after-unstage" in rules(v)
    assert any("uau" in x.message for x in v)


def test_handle_escaping_its_region_is_named(host_mode):
    assert "graph/handle-escapes-region" in rules(graph_handle_escapes(PORT))


def test_double_stage_of_same_buffer_is_named(host_mode):
    assert "graph/double-stage" in rules(graph_double_stage(PORT))


def test_real_plan_is_hazard_free(host_mode):
    _, _, z, w = _diamond(PORT)
    plan = plan_waves([z.node, w.node])
    assert check_plan(plan) == []
    assert len(plan.waves) >= 2


def test_raw_hazard_consumer_scheduled_with_producer(host_mode):
    assert "graph/raw-hazard" in rules(graph_raw_in_wave(PORT))


def test_raw_hazard_dependent_nodes_in_one_stacked_launch(host_mode):
    v = graph_raw_in_stack(PORT)
    assert "graph/raw-hazard" in rules(v)
    assert any("stacked launch" in x.message for x in v)


def test_war_hazard_fused_link_with_live_outside_reader(host_mode):
    assert "graph/war-hazard" in rules(graph_war(PORT))


def test_cycle_reported_for_unschedulable_nodes(host_mode):
    assert "graph/cycle" in rules(graph_cycle(PORT))


def test_offload_region_validate_raises_on_seeded_hazard(host_mode):
    v = graph_region_validate(PORT)
    assert "graph/shape-mismatch" in rules(v)


def test_dispatch_placed_validate_rejects_bad_operands(host_mode):
    with tcore.offload_trace() as trace:
        v = graph_dispatch_bad_operands(PORT)
    assert "graph/shape-mismatch" in rules(v)
    assert trace.records == []            # raised before any record


def test_dispatch_placed_validate_rejects_unknown_op(host_mode):
    assert "graph/unknown-op" in rules(graph_dispatch_unknown_op(PORT))


def test_dispatch_placed_validate_rejects_dead_handle(host_mode):
    assert "graph/use-after-unstage" in rules(graph_dead_handle(PORT))


def test_dispatch_placed_validate_accepts_clean_call(host_mode):
    a, b = torch.ones(4, 3), torch.ones(3, 2)
    out, launch = tdispatch.dispatch_placed("gemm", a, b, validate=True)
    assert out.shape == (4, 2)
    plain, _ = tdispatch.dispatch_placed("gemm", a, b)
    assert torch.equal(out, plain)


def test_violations_render_with_rule_names():
    v = Violation("graph/raw-hazard", "msg", "node#1(add)")
    assert v.render() == "node#1(add): graph/raw-hazard: msg"


# ---------------------------------------------------------------------------
# Part 2 — parity: the same rules from both packages
# ---------------------------------------------------------------------------

def _ticket_fields(streams):
    """Every stamped field; a handle name's node id is masked (the two
    packages number graph nodes from their own counters)."""
    return {dev: [dataclasses.astuple(dataclasses.replace(
                t, shape_key=re.sub(r":n\d+$", ":n", t.shape_key)))
                  for t in ts]
            for dev, ts in streams.items()}


@pytest.mark.parametrize("policy", [
    dict(), dict(pipeline_staging=False),
    dict(prefetch_staging=True, num_devices=1),
    dict(num_devices=3, scheduler="round-robin"),
], ids=["default", "serial", "prefetch", "round-robin"])
def test_clean_workload_streams_match_reference(policy):
    want = _run_workload(REF, **policy)
    got = _run_workload(PORT_V5E, **policy)
    assert _ticket_fields(got) == _ticket_fields(want)
    assert JR.check_ticket_streams(want) == []
    assert TR.check_ticket_streams(got) == []


@pytest.mark.parametrize("hazard", sorted(RACE_HAZARDS))
def test_race_hazards_name_the_reference_rules(hazard):
    scenario = RACE_HAZARDS[hazard]
    want = rule_list(scenario(REF))
    got = rule_list(scenario(PORT_V5E))
    assert want and f"race/{hazard}" in want
    assert got == want


def test_slot_refill_hazard_names_the_reference_rule():
    from repro.launch import streaming as JS
    from repro_torch.core.platform import TPU_V5E
    from repro_torch.launch import streaming as TS

    jrep = JS.serve_stream("yi-6b", JS.bursty_trace(120.0, 0.5, seed=7))
    trep = TS.serve_stream("yi-6b", TS.bursty_trace(120.0, 0.5, seed=7),
                           config=TS.StreamConfig(platform=TPU_V5E))
    assert JR.check_slot_refills(jrep.slot_refills) == []
    assert TR.check_slot_refills(trep.slot_refills) == []
    for i in (0, len(trep.slot_refills) // 2):
        jbad = dataclasses.replace(
            jrep.slot_refills[i],
            refill_issue_s=jrep.slot_refills[i].freed_complete_s - 1e-3)
        tbad = dataclasses.replace(
            trep.slot_refills[i],
            refill_issue_s=trep.slot_refills[i].freed_complete_s - 1e-3)
        want = JR.check_slot_refills([jbad, jrep.slot_refills[-1]])
        got = TR.check_slot_refills([tbad, trep.slot_refills[-1]])
        assert rule_list(got) == rule_list(want) == [
            "race/slot-refill-before-complete"]
        assert [v.where for v in got] == [v.where for v in want]


def test_skewed_workload_migrations_match_reference():
    want = JP.run_skewed_workload(zipf_s=1.2, seed=0, dynamic=True)
    got = TP.run_skewed_workload(zipf_s=1.2, seed=0, dynamic=True,
                                 platform="tpu-v5e")
    assert JR.check_expert_migrations(want.migration_edges) == []
    assert TR.check_expert_migrations(got.migration_edges) == []
    late = [dataclasses.replace(e, migrate_issue_s=e.src_drain_s - 1.0)
            for e in got.migration_edges]
    jlate = [dataclasses.replace(e, migrate_issue_s=e.src_drain_s - 1.0)
             for e in want.migration_edges]
    assert rule_list(TR.check_expert_migrations(late)) == rule_list(
        JR.check_expert_migrations(jlate))
    assert len(late) == len(rule_list(TR.check_expert_migrations(late)))


@pytest.mark.parametrize("hazard", sorted(GRAPH_HAZARDS))
def test_graph_hazards_name_the_reference_rules(hazard, host_mode):
    scenario = GRAPH_HAZARDS[hazard]
    want = rule_list(scenario(REF))
    got = rule_list(scenario(PORT))
    assert want
    assert got == want


def test_clean_graphs_verify_clean_in_both(host_mode):
    for p in (REF, PORT):
        _, _, y = _gemm_chain(p)
        _, _, z, w = _diamond(p)
        assert p.graph.verify_graph([y.node]) == []
        assert p.graph.verify_graph([z.node, w.node]) == []
        plan = p.graph.plan_waves([z.node, w.node])
        assert p.graph.check_plan(plan) == []
    jplan = JG.plan_waves([_diamond(REF)[2].node])
    tplan = TG.plan_waves([_diamond(PORT)[2].node])
    assert ([[n.op for n in wave] for wave in tplan.waves]
            == [[n.op for n in wave] for wave in jplan.waves])
    assert len(tplan.chains) == len(jplan.chains)
