"""Phases 5a-5c, 7c and 7a: ``serve-cluster`` (yi-6b's serve weights over
4 modeled devices: (a) cost-aware with pinned caches, counted; (b)
round-robin drained to host, profiled), ``trace-export`` (run (a)'s
Chrome trace), ``races`` (run (a)'s tickets through ``analysis.races``),
``stream`` (the streaming engine, modeled) and ``paper-fig3``
(``tools/paper_fig3_h100.py``).
"""

from __future__ import annotations

import gzip
import importlib.util
import json
import time

from smoke.common import (KERNEL_POLICY, _backends, decode_route_of, emit,
                          fail, profile, read_routes, require_route)
from smoke.shapes import (ARCH, BATCH, CACHE_LEN, CLUSTER_BATCHES,
                          CLUSTER_DEVICES, MAX_NEW, MOE_ARCH, PROMPT_LEN, ROOT,
                          SEED, STREAM_DEVICES, STREAM_DURATION_S, STREAM_LOAD,
                          STREAM_MOE_DURATION_S, STREAM_MOE_QPS,
                          STREAM_PREFILL_LANES, STREAM_SLOTS, expected)


def run_stream():
    """Phase 7c: the streaming engine at yi-6b's published config (full
    width in the cost model) on the port's default platform: STREAM_DEVICES
    modeled devices, STREAM_PREFILL_LANES prefill lane, STREAM_SLOTS slots,
    a bursty trace at STREAM_LOAD x ``estimate_capacity`` for
    STREAM_DURATION_S, seed SEED.  ``serve_stream`` twice (equal events and
    ``point_dict()``), ``serve_lockstep`` once; the slot refills and every
    device's ticket stream race-free.  Then qwen3-moe with expert placement
    fed by the decode traffic: its decisions non-empty, its streams
    race-free.  Every figure is modeled but the host seconds."""
    from repro_torch.analysis import format_violations
    from repro_torch.analysis.races import (check_slot_refills,
                                            check_ticket_streams)
    from repro_torch.core.placement import PlacementConfig
    from repro_torch.launch.streaming import (StreamConfig, bursty_trace,
                                              estimate_capacity,
                                              serve_lockstep, serve_stream)

    cfg = StreamConfig(num_devices=STREAM_DEVICES,
                       prefill_lanes=STREAM_PREFILL_LANES,
                       decode_slots=STREAM_SLOTS)
    capacity = estimate_capacity(ARCH, cfg)
    trace = bursty_trace(STREAM_LOAD * capacity, STREAM_DURATION_S,
                         seed=SEED)
    t0 = time.perf_counter()
    cont = serve_stream(ARCH, trace, config=cfg)
    host_s = time.perf_counter() - t0
    again = serve_stream(ARCH, trace, config=cfg)
    if cont.events != again.events or \
            cont.point_dict() != again.point_dict():
        fail("stream: two serve_stream runs of one trace differ")
    t0 = time.perf_counter()
    lock = serve_lockstep(ARCH, trace, config=cfg)
    lock_host_s = time.perf_counter() - t0
    violations = (check_slot_refills(cont.slot_refills)
                  + check_ticket_streams(cont.ticket_log)
                  + check_ticket_streams(lock.ticket_log))
    if violations:
        fail(f"stream: {format_violations(violations)}")

    moe_cfg = StreamConfig(expert_placement=PlacementConfig())
    moe = serve_stream(MOE_ARCH, bursty_trace(STREAM_MOE_QPS,
                                              STREAM_MOE_DURATION_S,
                                              seed=SEED), config=moe_cfg)
    if not moe.placement_decisions:
        fail("stream: qwen3-moe decode traffic made no placement decision")
    violations = (check_ticket_streams(moe.ticket_log)
                  + check_slot_refills(moe.slot_refills))
    if violations:
        fail(f"stream (qwen3-moe): {format_violations(violations)}")

    def tails(rep):
        o = rep.slo.overall
        return {"sustained_qps": rep.sustained_qps,
                "ttft_p99_ms": o.ttft.p99_s * 1e3,
                "per_token_p99_ms": o.per_token.p99_s * 1e3,
                "reject_rate": rep.reject_rate,
                "meets_slo": rep.slo.meets_slo}

    emit({"phase": "stream", "arch": ARCH, "platform": cfg.platform.name,
          "devices": STREAM_DEVICES, "prefill_lanes": STREAM_PREFILL_LANES,
          "decode_slots": STREAM_SLOTS, "seed": SEED,
          "requests": len(trace.requests), "events": len(cont.events),
          "events_equal_across_runs": True,
          "slot_refills": len(cont.slot_refills), "race_violations": 0,
          "host_s": {"serve_stream": host_s, "serve_lockstep": lock_host_s},
          "modeled": {
              "estimated_capacity_qps": capacity,
              "offered_qps": trace.offered_qps,
              "continuous": tails(cont), "lockstep": tails(lock),
              "continuous_over_lockstep":
                  cont.sustained_qps / lock.sustained_qps},
          "moe": {"arch": MOE_ARCH, "offered_qps": STREAM_MOE_QPS,
                  "duration_s": STREAM_MOE_DURATION_S,
                  "placement_decisions": len(moe.placement_decisions),
                  "slot_refills": len(moe.slot_refills),
                  "race_violations": 0,
                  "modeled": tails(moe)}})


def record_tickets(run):
    """Run ``run()`` with a flight recorder that keeps every ticket;
    returns (its result, every device's ticket stream in issue order).
    Fails if the recorder kept fewer tickets than the run issued."""
    import types

    from repro_torch.obs import flight, metrics

    def tickets_issued():
        return sum(v for k, v in metrics.snapshot().items()
                   if k.startswith("stream.tickets{"))

    flight.configure(1 << 22)
    issued = tickets_issued()
    try:
        result = run()
        recorded = flight.capture()["tickets"]
    finally:
        flight.configure(flight.DEFAULT_CAPACITY)
    issued = tickets_issued() - issued
    streams = {int(d): [types.SimpleNamespace(**t) for t in ts]
               for d, ts in recorded.items()}
    n_tickets = sum(len(v) for v in streams.values())
    if n_tickets != issued:
        fail(f"the flight recorder kept {n_tickets} of {issued} tickets")
    return result, streams


def run_serve_cluster(cfg, params, prompts, tokens0, tally):
    """Phases 5a, 5b and 5c: ``serve_cluster`` on the serve phase's
    weights, CLUSTER_BATCHES batches (the first the serve phase's prompts)
    over CLUSTER_DEVICES modeled devices, run (a) cost-aware with pinned
    caches (counted; every ticket kept for the race check) and run (b)
    round-robin with caches drained to host (profiled); then run (a) again
    traced (``run_trace_export``); then the races phase over run (a)."""
    import numpy as np
    import torch

    from repro_torch.analysis import format_violations
    from repro_torch.analysis.races import check_cluster, check_ticket_streams
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch, serve_cluster

    dev = torch.device("cuda")
    extra = np.random.default_rng(SEED + 1)
    batches = [prompts] + [
        [[int(t) for t in extra.integers(1, cfg.vocab_size, size=PROMPT_LEN)]
         for _ in range(BATCH)] for _ in range(CLUSTER_BATCHES - 1)]
    kw = dict(smoke=False, cache_len=CACHE_LEN, max_new_tokens=MAX_NEW,
              params=params, device=dev)
    want = [np.asarray(tokens0)]
    with offload_policy(**KERNEL_POLICY), torch.no_grad():
        want += [serve_batch(cfg.name, b, **kw).tokens for b in batches[1:]]

    window = {}

    def cluster_run(scheduler, pin, label):
        pol = dict(KERNEL_POLICY, num_devices=CLUSTER_DEVICES,
                   scheduler=scheduler)
        t0 = time.perf_counter()
        with offload_policy(**pol) as eng, offload_trace() as trace:
            res = serve_cluster(cfg.name, batches, pin_caches=pin, **kw)
            # the engine's own in-flight window, read before the scope
            # restores the outer devices
            window[label] = (check_cluster(eng),
                             sum(len(d.inflight) for d in eng.devices))
        wall = time.perf_counter() - t0
        for i, (r, w) in enumerate(zip(res.results, want, strict=True)):
            if not np.array_equal(r.tokens, w):
                fail(f"serve-cluster {label}: batch {i} greedy tokens differ "
                     "from serve_batch's")
        return res, wall, trace

    def summary(res, wall):
        return {"prefill_placements": res.prefill_placements,
                "placements": res.placements,
                "cache_devices": res.cache_devices, "wall_s": wall,
                "tokens": res.total_tokens,
                "decode_tokens_per_s_by_batch": [r.tokens_per_s
                                                 for r in res.results],
                "prefill_s_by_batch": [r.prefill_s for r in res.results],
                "modeled": {"makespan_s": res.makespan_s,
                            "tokens_per_s": res.tokens_per_s,
                            "per_device_s": res.per_device_s,
                            "d2d_s": res.d2d_s,
                            "restage_s": res.restage_s}}

    tally.zero()
    (res_a, wall_a, trace_a), streams_a = record_tickets(
        lambda: cluster_run("cost-aware", True, "(a)"))
    launches, routes = tally.counts(), read_routes()
    per_step, ops = expected(cfg, "serve", "eager")
    steps = PROMPT_LEN + MAX_NEW
    want_launches = {k: CLUSTER_BATCHES * steps * v
                     for k, v in per_step.items()}
    if launches != want_launches:
        fail(f"serve-cluster kernel launches {launches}, want "
             f"{want_launches}")
    require_route("serve-cluster", routes, "skinny",
                  decode=decode_route_of(cfg.dtype))
    backends = _backends(trace_a, ops)
    if res_a.placements != res_a.cache_devices or res_a.d2d_s != 0.0 or \
            res_a.restage_s != 0.0:
        fail(f"serve-cluster (a) moved a pinned cache: {summary(res_a, 0)}")
    # Every seam record lies on its batch's lane: prefill steps on the
    # prefill placement, decode steps on the decode placement.
    per_step_records = sum(1 for r in trace_a.records if r.op in ops) // (
        CLUSTER_BATCHES * steps)
    lanes = [r.device_id for r in trace_a.records if r.op in ops]
    want_lanes = []
    for i in range(CLUSTER_BATCHES):
        want_lanes += [res_a.prefill_placements[i]] * (
            PROMPT_LEN * per_step_records)
    for i in range(CLUSTER_BATCHES):
        want_lanes += [res_a.placements[i]] * (MAX_NEW * per_step_records)
    if lanes != want_lanes:
        fail("serve-cluster (a): seam records off their batches' lanes")
    if len(set(res_a.placements)) != CLUSTER_DEVICES:
        fail(f"serve-cluster (a) left a lane idle: {res_a.placements}")

    out_b = {}

    def run_b():
        out_b["res"], out_b["wall"], _ = cluster_run("round-robin", False,
                                                     "(b)")

    profile_b = profile(run_b)
    res_b = out_b["res"]
    if not res_b.restage_s > 0.0 or res_b.cache_devices != \
            [-1] * CLUSTER_BATCHES:
        fail(f"serve-cluster (b) paid no host re-stage: "
             f"{summary(res_b, 0)}")
    emit({"phase": "serve-cluster", "arch": cfg.name, "dtype": cfg.dtype,
          "devices": CLUSTER_DEVICES, "batches": CLUSTER_BATCHES,
          "batch": BATCH, "prompt_len": PROMPT_LEN, "max_new": MAX_NEW,
          "cache_len": CACHE_LEN, "launches": launches, "routes": routes,
          "trace_backends": backends, "greedy_tokens_equal_serve_batch": True,
          "records_per_step": per_step_records,
          "a_cost_aware_pinned": summary(res_a, wall_a),
          "b_round_robin_unpinned": {**summary(res_b, out_b["wall"]),
                                     "profiled": profile_b}})
    run_trace_export(cfg, batches, want, kw, tally.out_dir)

    # ---- 5c. races over run (a) -----------------------------------------
    full = check_ticket_streams(streams_a)
    in_window, window_tickets = window["(a)"]
    if full or in_window:
        fail(f"races (serve-cluster): {format_violations(full + in_window)}")
    emit({"phase": "races", "path": "serve-cluster (a)",
          "tickets": sum(len(v) for v in streams_a.values()),
          "tickets_by_device": {d: len(v) for d, v in streams_a.items()},
          "kinds": sorted({t.kind for v in streams_a.values() for t in v}),
          "violations": 0, "inflight_window_tickets": window_tickets,
          "inflight_window_violations": 0})
    tally.keep("serve-cluster", launches, routes)


def run_trace_export(cfg, batches, want, kw, out_dir):
    """Phase 5b: run (a) of ``run_serve_cluster`` under a ``SpanTracer``
    with a flight recorder that keeps every ticket; the Chrome trace must
    validate and every ticket must have its span (``ticket_spans`` of the
    recorded tickets against the tracer's ticket spans)."""
    import numpy as np

    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_cluster
    from repro_torch.obs import spans, trace_export

    pol = dict(KERNEL_POLICY, num_devices=CLUSTER_DEVICES,
               scheduler="cost-aware")

    def run():
        with offload_policy(**pol), spans.span_trace("serve-cluster") as tr:
            res = serve_cluster(cfg.name, batches, pin_caches=True, **kw)
        return res, tr

    t0 = time.perf_counter()
    (res, tr), streams = record_tickets(run)
    wall = time.perf_counter() - t0
    for i, (r, w) in enumerate(zip(res.results, want, strict=True)):
        if not np.array_equal(r.tokens, w):
            fail(f"trace-export: batch {i} greedy tokens differ")
    n_tickets = sum(len(v) for v in streams.values())
    t_spans = trace_export.ticket_spans(streams)

    def key(attrs, dev):
        return (dev, attrs["kind"], attrs["op"], attrs["shape_key"],
                attrs["issue_s"], attrs["complete_s"])

    compute = [s for s in t_spans if s.lane.endswith("/compute")]
    if len(compute) != n_tickets:
        fail(f"trace-export: ticket_spans gave {len(compute)} compute "
             f"windows for {n_tickets} tickets")
    traced = {key(s.attrs, s.device_id) for s in tr.spans
              if s.attrs.get("ticket")}
    missing = {key(s.attrs, s.attrs["device_id"]) for s in compute} - traced
    if missing:
        fail(f"trace-export: {len(missing)} tickets have no traced span, "
             f"e.g. {sorted(missing)[:3]}")
    trace = trace_export.chrome_trace(tr, meta={"otherData": {
        "arch": cfg.name, "devices": CLUSTER_DEVICES,
        "scheduler": "cost-aware", "time": "modeled"}})
    errors = trace_export.validate_chrome_trace(trace)
    if errors:
        fail(f"trace-export: invalid Chrome trace: {errors[:5]}")
    path = out_dir / "serve_cluster_trace.json.gz"
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)
    summary = trace_export.summarize(tr.spans, top=2).splitlines()
    emit({"phase": "trace-export", "events": len(trace["traceEvents"]),
          "spans": len(tr.spans), "tickets": n_tickets,
          "tickets_with_span": n_tickets, "validator_errors": 0,
          "lanes": sorted(set(tr.lanes())), "wall_s": wall,
          "file": str(path), "file_bytes": path.stat().st_size,
          "modeled_self_time_top_by_lane": summary})


def run_paper_fig3(tally):
    """Phase 7a: the paper's Fig. 3 through ``tools/paper_fig3_h100.py``
    (whose ``run`` raises if a row misses its bar or its backend and
    route); its launches counted, every GEMM route reached."""
    spec = importlib.util.spec_from_file_location(
        "paper_fig3_h100", ROOT / "tools" / "paper_fig3_h100.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tally.zero()
    result = tool.run()
    launches, routes = tally.counts(), read_routes()
    used = {k for k, v in routes["gemm"].items() if v}
    if used != {"skinny", "tf32x3", "wgmma"} or launches["gemm"] == 0 or \
            any(launches[k] for k in launches if k != "gemm"):
        fail(f"paper-fig3 launches {launches} routes {routes}")
    path = tally.out_dir / "paper_fig3.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    print(tool.table(result), flush=True)
    emit({"phase": "paper-fig3", "rows": result["rows"],
          "crossover": result["crossover"],
          "host_blas": result["host_blas"], "launches": launches,
          "routes": routes, "file": str(path)})
    tally.keep("paper-fig3", launches, routes)
