"""The streaming serve engine (``repro_torch.launch.streaming``) and the
SLO half of ``repro_torch.core.accounting``.

Part 1 twins each test of ``tests/test_streaming.py`` on the port, on its
default platform (``h100-sxm``): seeded arrival generators, same-seed
determinism, admission control, the decode slot pool and its refill
happens-before edge, p99 monotone in offered load, continuous batching
beating lock-step on one bursty trace, the offered-load sweep and the SLO
primitives.

Part 2 runs the reference and the port on one trace with the platform
pinned to ``tpu-v5e`` (the reference's default) and holds every modeled
output equal with ``==``: the event trail, ``point_dict()``, the slot
refills, every stamped field of every device's ticket log, the
offered-load sweep and ``slo_report``.  Everything is modeled pure
Python over the full (not reduced) arch config; no model is built.
"""

import dataclasses

import pytest

from repro.core import accounting as jacct
from repro.launch import streaming as J
from repro_torch.analysis.races import (
    check_slot_refills,
    check_ticket_streams,
)
from repro_torch.core import accounting
from repro_torch.core.platform import H100_SXM, TPU_V5E
from repro_torch.launch.streaming import (
    SLO,
    ArrivalTrace,
    StreamConfig,
    bursty_trace,
    estimate_capacity,
    offered_load_sweep,
    poisson_trace,
    replay_trace,
    scale_trace,
    serve_lockstep,
    serve_stream,
)

ARCH = "yi-6b"


def small_cfg(**kw) -> StreamConfig:
    return StreamConfig(**{"num_devices": 4, "prefill_lanes": 1,
                           "decode_slots": 8, **kw})


# ---------------------------------------------------------------------------
# Part 1 — twins of tests/test_streaming.py
# ---------------------------------------------------------------------------

def test_default_platform_is_the_ports_row():
    """The one departure: the port's engine defaults to ``h100-sxm``."""
    assert StreamConfig().platform is H100_SXM
    assert J.StreamConfig().platform.name == "tpu-v5e"
    assert SLO() == SLO(ttft_s=0.25, per_token_s=0.008)


def test_generators_are_seed_deterministic():
    a = poisson_trace(80.0, 1.0, seed=3)
    b = poisson_trace(80.0, 1.0, seed=3)
    assert a.requests == b.requests
    c = poisson_trace(80.0, 1.0, seed=4)
    assert c.requests != a.requests
    x = bursty_trace(80.0, 1.0, seed=3)
    y = bursty_trace(80.0, 1.0, seed=3)
    assert x.requests == y.requests
    assert isinstance(x, ArrivalTrace) and x.kind == "bursty"


def test_bursty_trace_is_bursty_but_rate_matched():
    t = bursty_trace(100.0, 2.0, seed=0, burst_factor=3.0,
                     burst_fraction=0.3, period_s=0.25)
    assert 0.7 * 100.0 < t.offered_qps < 1.3 * 100.0
    hot = sum(1 for r in t.requests if (r.arrival_s % 0.25) / 0.25 < 0.3)
    cold = len(t.requests) - hot
    assert hot / 0.3 > cold / 0.7


def test_scale_trace_preserves_population_and_compresses_time():
    base = bursty_trace(50.0, 1.0, seed=1)
    hot = scale_trace(base, 2.0)
    assert len(hot.requests) == len(base.requests)
    for r0, r1 in zip(base.requests, hot.requests):
        assert (r1.prompt_len, r1.output_len, r1.req_class) == (
            r0.prompt_len, r0.output_len, r0.req_class
        )
        assert r1.arrival_s == pytest.approx(r0.arrival_s / 2.0)
        if r0.deadline_s:
            assert r1.deadline_s - r1.arrival_s == pytest.approx(
                r0.deadline_s - r0.arrival_s
            )
    assert hot.offered_qps == pytest.approx(2.0 * base.offered_qps)


def test_replay_trace_sorts_and_stamps_deadlines():
    t = replay_trace([(0.5, 8, 4), (0.1, 16, 2)], deadline_budget_s=1.0)
    assert [r.arrival_s for r in t.requests] == [0.1, 0.5]
    assert t.requests[0].deadline_s == pytest.approx(1.1)


def test_stream_config_validation():
    with pytest.raises(ValueError):
        StreamConfig(admission="bogus")
    with pytest.raises(ValueError):
        StreamConfig(num_devices=2, prefill_lanes=2)


def test_same_seed_runs_produce_identical_event_streams():
    trace = bursty_trace(100.0, 0.6, seed=11)
    r1 = serve_stream(ARCH, trace, config=small_cfg())
    r2 = serve_stream(ARCH, trace, config=small_cfg())
    assert r1.events == r2.events
    assert r1.point_dict() == r2.point_dict()
    assert [len(v) for v in r1.ticket_log.values()] == [
        len(v) for v in r2.ticket_log.values()
    ]


def test_different_seed_changes_the_event_stream():
    r1 = serve_stream(ARCH, bursty_trace(100.0, 0.6, seed=11),
                      config=small_cfg())
    r2 = serve_stream(ARCH, bursty_trace(100.0, 0.6, seed=12),
                      config=small_cfg())
    assert r1.events != r2.events


def overload_trace(seed=0, duration=0.6, cfg=None):
    cap = estimate_capacity(ARCH, cfg or small_cfg())
    return bursty_trace(3.0 * cap, duration, seed=seed)


def test_rejected_requests_never_appear_in_device_timelines():
    cfg = small_cfg(admission="queue", max_queue=4)
    rep = serve_stream(ARCH, overload_trace(), config=cfg)
    rejected = [m for m in rep.metrics if not m.admitted]
    assert rejected, "overload with a 4-deep queue must shed load"
    keys = {
        t.shape_key for stream in rep.ticket_log.values() for t in stream
    }
    for m in rejected:
        assert f"prefill-{m.rid}" not in keys
        assert f"kv-{m.rid}" not in keys
        assert m.tokens_out == 0
        assert m.first_token_s == 0.0
        assert not m.completed


def test_slo_admission_sheds_load_and_protects_the_tail():
    rep = serve_stream(ARCH, overload_trace(), config=small_cfg())
    assert rep.reject_rate > 0.0
    assert rep.slo.meets_slo, rep.slo.as_dict()


def test_admission_none_serves_everything():
    rep = serve_stream(
        ARCH, bursty_trace(60.0, 0.5, seed=2),
        config=small_cfg(admission="none"),
    )
    assert rep.rejected == 0
    assert rep.completed == rep.admitted == len(rep.metrics)


def test_decode_slots_never_exceed_pool_size():
    cfg = small_cfg(num_devices=2, decode_slots=4)   # single decode lane
    rep = serve_stream(ARCH, bursty_trace(80.0, 0.6, seed=5), config=cfg)
    assert 0 < rep.max_active_slots <= 4
    multi = small_cfg(decode_slots=6)
    rep2 = serve_stream(ARCH, bursty_trace(150.0, 0.6, seed=5), config=multi)
    assert rep2.max_active_slots <= 6 * (multi.num_devices - multi.prefill_lanes)


def test_slot_refill_issued_at_or_after_freeing_complete():
    rep = serve_stream(ARCH, bursty_trace(120.0, 0.8, seed=7),
                       config=small_cfg())
    assert rep.slot_refills, "a busy run must exercise the refill path"
    for r in rep.slot_refills:
        assert r.refill_issue_s >= r.freed_complete_s - 1e-9
    assert check_slot_refills(rep.slot_refills) == []


def test_slot_refill_race_rule_fires_on_corrupted_edge():
    rep = serve_stream(ARCH, bursty_trace(120.0, 0.5, seed=7),
                       config=small_cfg())
    bad = dataclasses.replace(
        rep.slot_refills[0],
        refill_issue_s=rep.slot_refills[0].freed_complete_s - 1e-3,
    )
    violations = check_slot_refills([bad])
    assert [v.rule for v in violations] == ["race/slot-refill-before-complete"]


def test_streaming_ticket_streams_are_race_free():
    rep = serve_stream(ARCH, bursty_trace(120.0, 0.8, seed=9),
                       config=small_cfg())
    violations = check_ticket_streams(rep.ticket_log)
    assert violations == [], "\n".join(v.render() for v in violations)
    kinds = {t.kind for s in rep.ticket_log.values() for t in s}
    assert "d2d" in kinds and "launch" in kinds


def test_adaptive_controller_stays_in_bounds():
    rep = serve_stream(ARCH, overload_trace(seed=3), config=small_cfg())
    assert 1 <= rep.min_slot_target <= small_cfg().decode_slots


def test_p99_ttft_monotone_non_decreasing_in_offered_load():
    cfg = small_cfg(admission="none", adaptive=False)
    cap = estimate_capacity(ARCH, cfg)
    base = bursty_trace(1.5 * cap, 1.0, seed=0)
    p99s = []
    for u in (0.4, 0.8, 1.5):
        rep = serve_stream(ARCH, scale_trace(base, u / 1.5), config=cfg)
        p99s.append(rep.slo.overall.ttft.p99_s)
    assert p99s[0] <= p99s[1] + 1e-9
    assert p99s[1] <= p99s[2] + 1e-9


def test_request_metrics_are_causally_ordered():
    rep = serve_stream(ARCH, bursty_trace(90.0, 0.5, seed=4),
                       config=small_cfg())
    for m in rep.metrics:
        if not m.completed:
            continue
        assert m.arrival_s <= m.prefill_done_s <= m.first_token_s <= m.finish_s
        assert m.tokens_out == m.output_len
        assert len(m.token_latencies_s) == m.output_len - 1
        assert all(lat > 0 for lat in m.token_latencies_s)


def test_continuous_beats_lockstep_on_same_bursty_trace():
    cfg = small_cfg()
    cap = estimate_capacity(ARCH, cfg)
    trace = bursty_trace(2.0 * cap, 1.0, seed=0)
    cont = serve_stream(ARCH, trace, config=cfg)
    lock = serve_lockstep(ARCH, trace, config=cfg)
    assert cont.sustained_qps >= 1.3 * lock.sustained_qps
    assert lock.slo.overall.ttft.p99_s > cont.slo.overall.ttft.p99_s


def test_offered_load_sweep_produces_the_bench_section():
    sweep = offered_load_sweep(ARCH, utils=(0.5, 1.0, 2.0), seed=0)
    assert len(sweep["points"]) == 3
    assert sweep["seed"] == 0
    for p in sweep["points"]:
        for key in ("sustained_qps", "reject_rate", "ttft_p99_ms",
                    "per_token_p99_ms"):
            assert key in p
    assert sweep["max_qps_at_slo"] > 0
    assert sweep["continuous_vs_lockstep"]["speedup"] >= 1.3


def test_percentile_is_linear_interpolation():
    assert accounting.percentile([], 99) == 0.0
    assert accounting.percentile([5.0], 50) == 5.0
    vals = [1.0, 2.0, 3.0, 4.0]
    assert accounting.percentile(vals, 0) == 1.0
    assert accounting.percentile(vals, 100) == 4.0
    assert accounting.percentile(vals, 50) == pytest.approx(2.5)


def _slo_metrics(mk):
    return [
        mk(rid=0, req_class="a", arrival_s=0.0, prompt_len=4, output_len=2,
           first_token_s=0.1, finish_s=0.2, tokens_out=2,
           token_latencies_s=[0.1]),
        mk(rid=1, req_class="b", arrival_s=0.0, prompt_len=4, output_len=2,
           first_token_s=0.3, finish_s=0.5, tokens_out=2,
           token_latencies_s=[0.2]),
        mk(rid=2, req_class="a", arrival_s=0.0, prompt_len=4, output_len=2,
           admitted=False),
    ]


def test_slo_report_excludes_rejected_and_classes_roll_up():
    ms = _slo_metrics(accounting.RequestMetrics)
    rep = accounting.slo_report(ms, ttft_slo_s=0.4, per_token_slo_s=0.3)
    assert set(rep.classes) == {"a", "b", "all"}
    assert rep.overall.requests == 2
    assert rep.overall.ttft.max_s == pytest.approx(0.3)
    assert rep.meets_slo
    tight = accounting.slo_report(ms, ttft_slo_s=0.2)
    assert not tight.meets_slo


def test_lockstep_report_is_well_formed():
    trace = bursty_trace(60.0, 0.4, seed=1)
    rep = serve_lockstep(ARCH, trace, config=small_cfg())
    assert rep.engine == "lockstep"
    assert rep.completed == len(trace.requests)
    assert rep.slot_refills == []
    assert check_ticket_streams(rep.ticket_log) == []


# ---------------------------------------------------------------------------
# Part 2 — parity with the reference at platform tpu-v5e
# ---------------------------------------------------------------------------

def _astuples(items):
    return [dataclasses.astuple(x) for x in items]


def _tickets(log):
    return {dev: _astuples(ts) for dev, ts in log.items()}


def _pair_cfgs(**kw):
    base = {"num_devices": 4, "prefill_lanes": 1, "decode_slots": 8, **kw}
    return J.StreamConfig(**base), StreamConfig(platform=TPU_V5E, **base)


def _assert_reports_equal(got, want):
    assert got.events == want.events
    assert got.point_dict() == want.point_dict()
    assert _astuples(got.slot_refills) == _astuples(want.slot_refills)
    assert _tickets(got.ticket_log) == _tickets(want.ticket_log)
    assert ([dataclasses.asdict(m) for m in got.metrics]
            == [dataclasses.asdict(m) for m in want.metrics])
    assert got.slo.as_dict() == want.slo.as_dict()
    for field in ("arch", "seed", "engine", "offered_qps", "admitted",
                  "rejected", "completed", "sustained_qps", "makespan_s",
                  "max_active_slots", "min_slot_target",
                  "placement_decisions"):
        assert getattr(got, field) == getattr(want, field), field


def _trace_pair(kind, seed, qps):
    gen_j = J.bursty_trace if kind == "bursty" else J.poisson_trace
    gen_t = bursty_trace if kind == "bursty" else poisson_trace
    want, got = gen_j(qps, 1.0, seed=seed), gen_t(qps, 1.0, seed=seed)
    assert _astuples(got.requests) == _astuples(want.requests)
    assert (got.kind, got.seed, got.duration_s) == (
        want.kind, want.seed, want.duration_s)
    return want, got


def test_estimate_capacity_matches_reference():
    jcfg, tcfg = _pair_cfgs()
    assert estimate_capacity(ARCH, tcfg) == J.estimate_capacity(ARCH, jcfg)
    assert estimate_capacity("qwen3-moe-30b-a3b", tcfg) == (
        J.estimate_capacity("qwen3-moe-30b-a3b", jcfg))


@pytest.mark.parametrize("kind", ["bursty", "poisson"])
@pytest.mark.parametrize("seed", [0, 11])
def test_serve_stream_matches_reference(kind, seed):
    jcfg, tcfg = _pair_cfgs()
    jtrace, ttrace = _trace_pair(kind, seed,
                                 2.0 * J.estimate_capacity(ARCH, jcfg))
    want = J.serve_stream(ARCH, jtrace, config=jcfg)
    got = serve_stream(ARCH, ttrace, config=tcfg)
    _assert_reports_equal(got, want)
    assert check_ticket_streams(got.ticket_log) == []
    assert check_slot_refills(got.slot_refills) == []


@pytest.mark.parametrize("kind", ["bursty", "poisson"])
@pytest.mark.parametrize("seed", [0, 11])
def test_serve_lockstep_matches_reference(kind, seed):
    jcfg, tcfg = _pair_cfgs()
    jtrace, ttrace = _trace_pair(kind, seed,
                                 2.0 * J.estimate_capacity(ARCH, jcfg))
    _assert_reports_equal(serve_lockstep(ARCH, ttrace, config=tcfg),
                          J.serve_lockstep(ARCH, jtrace, config=jcfg))


@pytest.mark.parametrize("kw", [
    dict(admission="none", adaptive=False),
    dict(admission="queue", max_queue=4),
    dict(num_devices=2, decode_slots=4),
    dict(num_devices=6, prefill_lanes=2, scheduler="round-robin"),
], ids=["none", "queue", "one-decode-lane", "two-prefill-lanes"])
def test_serve_stream_matches_reference_across_configs(kw):
    jcfg, tcfg = _pair_cfgs(**kw)
    jtrace, ttrace = _trace_pair("bursty", 3,
                                 3.0 * J.estimate_capacity(ARCH, jcfg))
    _assert_reports_equal(serve_stream(ARCH, ttrace, config=tcfg),
                          J.serve_stream(ARCH, jtrace, config=jcfg))


def test_replay_and_scaled_traces_match_reference():
    rows = [(0.02 * i, 16 + 7 * i, 4 + i % 5) for i in range(30)]
    jcfg, tcfg = _pair_cfgs()
    want = J.scale_trace(J.replay_trace(rows, deadline_budget_s=0.5), 3.0)
    got = scale_trace(replay_trace(rows, deadline_budget_s=0.5), 3.0)
    assert _astuples(got.requests) == _astuples(want.requests)
    _assert_reports_equal(serve_stream(ARCH, got, config=tcfg),
                          J.serve_stream(ARCH, want, config=jcfg))


def test_expert_placement_stream_matches_reference():
    """The expert-placement hook: decode traffic drives the placement
    policy; decisions, events and tickets equal the reference's."""
    from repro.core.placement import PlacementConfig as JPC
    from repro_torch.core.placement import PlacementConfig as TPC

    jcfg, tcfg = _pair_cfgs()
    jcfg = dataclasses.replace(jcfg, expert_placement=JPC())
    tcfg = dataclasses.replace(tcfg, expert_placement=TPC())
    jtrace, ttrace = _trace_pair("bursty", 0, 100.0)
    want = J.serve_stream("qwen3-moe-30b-a3b", jtrace, config=jcfg)
    got = serve_stream("qwen3-moe-30b-a3b", ttrace, config=tcfg)
    assert got.placement_decisions
    _assert_reports_equal(got, want)
    assert check_ticket_streams(got.ticket_log) == []


def test_offered_load_sweep_matches_reference():
    _, tcfg = _pair_cfgs()
    want = J.offered_load_sweep(ARCH, utils=(0.5, 1.0, 2.0), seed=0)
    got = offered_load_sweep(ARCH, utils=(0.5, 1.0, 2.0), seed=0,
                             config=tcfg)
    assert got == want


def test_slo_report_matches_reference():
    got = accounting.slo_report(_slo_metrics(accounting.RequestMetrics),
                                ttft_slo_s=0.4, per_token_slo_s=0.3)
    want = jacct.slo_report(_slo_metrics(jacct.RequestMetrics),
                            ttft_slo_s=0.4, per_token_slo_s=0.3)
    assert got.as_dict() == want.as_dict()
    assert got.meets_slo == want.meets_slo
    jcfg, tcfg = _pair_cfgs()
    jtrace, ttrace = _trace_pair("bursty", 0, 150.0)
    jm = J.serve_stream(ARCH, jtrace, config=jcfg).metrics
    tm = serve_stream(ARCH, ttrace, config=tcfg).metrics
    for q in (0, 37.5, 50, 95, 99, 100):
        vals = [m.arrival_s for m in tm]
        assert accounting.percentile(vals, q) == jacct.percentile(vals, q)
    assert (accounting.slo_report(tm, ttft_slo_s=0.25,
                                  per_token_slo_s=0.008).as_dict()
            == jacct.slo_report(jm, ttft_slo_s=0.25,
                                per_token_slo_s=0.008).as_dict())
