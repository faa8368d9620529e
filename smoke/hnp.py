"""Phases 7 (``hnp``) and 7b (``hnp-validated``): the paper's path, the
reference quickstart's ``hnp`` graph and a stacked GEMM wave at yi-6b
width, then both under ``offload_region(validate=True)``.
"""

from __future__ import annotations

import time

from smoke.common import _rel_err, emit, fail, read_routes, require_route
from smoke.shapes import HNP_ROWS, TOL
from smoke.timing import _card_name_and_power_limit


HNP_POLICY = dict(mode="device", num_devices=2, scheduler="cost-aware",
                  use_kernels=True, platform="h100-sxm")


def hnp_quickstart(tally, validate=False):
    """examples/quickstart.py's graph under mode="device", 2 modeled
    devices, cost-aware, in an ``offload_region(validate=validate)``.
    Returns (facts, values, launches, routes); ``facts["run_s"]`` is the
    host time of the region, from the leaves to the last value on the
    host."""
    import numpy as np

    import repro_torch.hnp as hnp
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import engine, offload_policy

    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 256)).astype(np.float32)
    w1 = rng.normal(size=(256, 512)).astype(np.float32)
    b1 = rng.normal(size=(512,)).astype(np.float32)
    w2 = rng.normal(size=(512, 128)).astype(np.float32)
    engine().reset()
    tally.zero()
    t0 = time.perf_counter()
    with offload_policy(**HNP_POLICY), offload_trace() as t:
        with hnp.offload_region("quickstart", validate=validate) as region:
            h = hnp.tanh(hnp.linear(hnp.array(x), w1, b1))
            y = h @ w2
            sim = hnp.syrk(y)
            y_np = hnp.asnumpy(y)
            sim_np = hnp.asnumpy(sim)
    run_s = time.perf_counter() - t0
    counts, routes = tally.counts(), read_routes()
    if y.node.value.device.type != "cuda":
        fail("hnp leaves did not land on the card")
    ref = (np.tanh(x.astype(np.float64) @ w1 + b1) @ w2)
    y_err = float(np.abs(y_np - ref).max() / np.abs(ref).max())
    sim_err = float(np.abs(sim_np - ref @ ref.T).max()
                    / np.abs(ref @ ref.T).max())
    if not (y_err <= TOL["float32"] and sim_err <= TOL["float32"]):
        fail(f"hnp quickstart values off: y {y_err}, syrk {sim_err}")
    if counts["gemm"] != 2:
        fail(f"hnp quickstart launches {counts}")
    facts = {
        "summary": region.report.summary(),
        "launches_by_node": [
            {"op": r.op, "backend": r.backend, "device_id": r.device_id,
             "resident_fraction": r.resident_fraction,
             "readback_bytes": r.readback_bytes, "fused": list(r.fused)}
            for r in region.report.launches],
        "records": [r.op for r in t.records], "kernel_launches": counts,
        "max_rel_err_vs_float64": {"y": y_err, "syrk": sim_err},
        "run_s": run_s,
    }
    return facts, (y_np, sim_np), counts, routes


def hnp_wave(operands, tally, validate=False):
    """One wave of two independent same-shape GEMMs (``operands``: x, wk,
    wv at yi-6b width), stacked into one batched-GEMM launch, in an
    ``offload_region(validate=validate)``.  Returns (facts, value,
    launches, routes); ``facts["run_s"]`` is the host time of the region
    up to the card's synchronize."""
    import numpy as np
    import torch

    import repro_torch.hnp as hnp
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import engine, offload_policy
    from repro_torch.kernels.ref import gemm_batched_ref

    xa, wk, wv = operands
    engine().reset()
    tally.zero()
    t0 = time.perf_counter()
    with offload_policy(**HNP_POLICY), offload_trace() as t:
        with hnp.offload_region("yi-kv-wave", validate=validate) as region:
            a = hnp.array(xa)
            yk, yv = a @ wk, a @ wv
            hnp.block_all(yk, yv)
            torch.cuda.synchronize()
            got = torch.stack([yk.node.value, yv.node.value])
    run_s = time.perf_counter() - t0
    counts, routes = tally.counts(), read_routes()
    require_route("hnp wave", routes, "wgmma")
    ops = [r.op for r in t.records if r.op != "d2d_copy"]
    if ops != ["gemm_batched"] or counts["gemm_batched"] != 1 or \
            counts["gemm"] != 0:
        fail(f"hnp wave did not take one batched launch: {ops} {counts}")
    if not all(r.batched for r in region.report.launches):
        fail("hnp wave report is not batched")
    xf = xa.float().cpu().numpy().astype(np.float64)
    want = np.stack([xf @ w.float().cpu().numpy().astype(np.float64)
                     for w in (wk, wv)])
    got_np = got.float().cpu().numpy()
    err64 = float(np.abs(got_np - want).max() / np.abs(want).max())
    plain = gemm_batched_ref(torch.stack([xa, xa]), torch.stack([wk, wv]))
    err_plain, abs_plain = _rel_err(got, plain)
    if not (err64 <= TOL["bfloat16"] and err_plain <= TOL["bfloat16"]):
        fail(f"hnp wave values off: vs float64 {err64}, vs plain "
             f"{err_plain}")
    facts = {
        "summary": region.report.summary(), "records": ops,
        "shape": [2, *xa.shape, wk.shape[1]], "dtype": "bfloat16",
        "kernel_launches": counts, "routes": routes,
        "gemm_batched_launched": counts["gemm_batched"] == 1,
        "max_rel_err_vs_float64": err64, "max_rel_err_vs_plain": err_plain,
        "max_abs_err_vs_plain": abs_plain, "run_s": run_s,
    }
    return facts, got, counts, routes


def run_hnp(cfg, randn, tally):
    """Phase 7: the paper's path on the card — examples/quickstart.py's
    graph, then one wave of two same-shape GEMMs at yi-6b width, stacked
    into one launch.  Returns, for phase 7b, the wave's operands and both
    values."""
    import torch

    quick, quick_values, quick_counts, quick_routes = hnp_quickstart(tally)
    d, n = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
    bf16 = torch.bfloat16
    operands = (randn(HNP_ROWS, d, dtype=bf16), randn(d, n, dtype=bf16),
                randn(d, n, dtype=bf16))
    wave, wave_value, wave_counts, wave_routes = hnp_wave(operands, tally)
    plain = {"operands": operands, "quickstart": quick_values,
             "wave": wave_value,
             "launches": (quick_counts, wave_counts),
             "routes": (quick_routes, wave_routes)}
    launches = {k: quick_counts[k] + wave_counts[k] for k in quick_counts}
    tally.keep("hnp", launches)
    tally.keep("hnp-wave", routes=wave["routes"])
    tally.max_abs["gemm_batched"] = max(tally.max_abs["gemm_batched"],
                                        wave["max_abs_err_vs_plain"])
    emit({"phase": "hnp", "quickstart": quick, "wave": wave,
          "launches": launches})
    return plain


def run_hnp_validated(plain, tally):
    """Phase 7b: phase 7 again under ``offload_region(validate=True)``
    (``repro_torch.analysis.graph`` checks every forced graph before it
    dispatches): values bit for bit, launch counts and routes equal to the
    unvalidated run's; a seeded bad call (``dispatch_placed("gemm", ...,
    validate=True)`` on operands whose inner dimensions disagree, and on a
    dead handle) must raise ``GraphVerificationError`` before any launch;
    host ms of the validated and the plain run, median of 3 in turns."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.analysis.graph import GraphVerificationError
    from repro_torch.core.dispatch import dispatch_placed
    from repro_torch.core.hero import offload_policy

    def both(validate):
        quick, qv, qc, qr = hnp_quickstart(tally, validate=validate)
        wave, wv, wc, wr = hnp_wave(plain["operands"], tally,
                                    validate=validate)
        return quick, wave, qv, wv, (qc, wc), (qr, wr)

    quick, wave, qv, wv, counts, routes = both(True)
    if not all(np.array_equal(g, w) for g, w in
               zip(qv, plain["quickstart"], strict=True)):
        fail("hnp-validated: quickstart values differ from the "
             "unvalidated run's")
    if not torch.equal(wv, plain["wave"]):
        fail("hnp-validated: wave values differ from the unvalidated run's")
    if counts != plain["launches"] or routes != plain["routes"]:
        fail(f"hnp-validated: launches {counts} / routes {routes}, "
             f"unvalidated {plain['launches']} / {plain['routes']}")
    launches = {k: counts[0][k] + counts[1][k] for k in counts[0]}

    xa, wk, _ = plain["operands"]
    seeded = {}
    with offload_policy(**HNP_POLICY) as cluster:
        dead = cluster.pin_handle("dead", float(xa.nbytes), device_id=0)
        cluster.unstage_handle(dead)
        for label, args, kw in (
                ("inner-dims-disagree", (xa, wk[:-1]), {}),
                ("dead-handle", (xa, wk), {"handle": dead})):
            tally.zero()
            raised = None
            try:
                dispatch_placed("gemm", *args, validate=True, **kw)
            except GraphVerificationError as e:
                raised = e
            torch.cuda.synchronize()
            if raised is None:
                fail(f"hnp-validated: seeded bad call ({label}) did not "
                     "raise GraphVerificationError")
            if any(tally.counts().values()):
                fail(f"hnp-validated: seeded bad call ({label}) launched "
                     f"{tally.counts()}")
            seeded[label] = [v.rule for v in raised.violations]
    if seeded != {"inner-dims-disagree": ["graph/shape-mismatch"],
                  "dead-handle": ["graph/use-after-unstage"]}:
        fail(f"hnp-validated: seeded bad calls named {seeded}")

    plain_s, validated_s = [], []
    for _ in range(3):
        q, w, *_ = both(False)
        plain_s.append(q["run_s"] + w["run_s"])
        q, w, *_ = both(True)
        validated_s.append(q["run_s"] + w["run_s"])
    out = {"values_bit_equal_unvalidated": True,
           "launches": launches, "quickstart_launches": counts[0],
           "wave_launches": counts[1], "wave_routes": routes[1],
           "quickstart_summary": quick["summary"],
           "wave_summary": wave["summary"],
           "seeded_bad_calls": seeded,
           "host_ms": {"validated_median_of_3":
                       statistics.median(validated_s) * 1e3,
                       "plain_median_of_3": statistics.median(plain_s) * 1e3,
                       "validated": [s * 1e3 for s in validated_s],
                       "plain": [s * 1e3 for s in plain_s]},
           "card": _card_name_and_power_limit()}
    emit({"phase": "hnp-validated", **out})
    tally.keep("hnp-validated", launches)
    tally.keep("hnp-validated-wave", routes=routes[1])
