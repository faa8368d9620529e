"""The readers of the program's ranges (``portbench/spans.py``) on a canned
trace, and on the card a traced forward whose kernel ranges match the
wrappers' launch counters."""

import dataclasses
import json

import pytest

from portbench import harness, metrics, spans, trace, work
from portbench.cells import load_cell

# One traced forward (µs on the profiler's clock); the canned profile holds
# two, the second 1100 µs after the first.  Inside the step: a layer whose
# RoPE synchronises twice, an MLP dispatch whose kernel lowering runs a
# nested matmul dispatch before its own kernel, and a head matmul after
# the layer.  Outside it, the harness's synchronise.
FORWARD = [
    ("make inputs", 0.0, 100.0), ("aten::randint", 10.0, 90.0),
    ("prefill step", 100.0, 1000.0), ("step:prefill", 110.0, 990.0),
    ("layer:attn", 120.0, 900.0),
    ("glue:rope", 130.0, 300.0), ("aten::_to_copy", 140.0, 200.0),
    ("cudaMemcpyAsync", 145.0, 148.0),
    ("cudaStreamSynchronize", 150.0, 190.0),
    ("cudaStreamSynchronize", 220.0, 260.0),
    ("dispatch:mlp_block", 300.0, 700.0), ("lower:kernel", 340.0, 680.0),
    ("dispatch:matmul", 400.0, 600.0), ("lower:kernel", 430.0, 590.0),
    ("kernel:gemm.wgmma", 450.0, 580.0), ("cudaLaunchKernel", 560.0, 570.0),
    ("kernel:gemm.wgmma", 610.0, 670.0),
    ("dispatch:matmul", 920.0, 980.0), ("lower:kernel", 930.0, 975.0),
    ("kernel:gemm.wgmma", 940.0, 970.0),
    ("synchronise", 1000.0, 1100.0), ("cudaDeviceSynchronize", 1000.0, 1090.0),
]
DEVICE_OPS = [("rope_kernel", 120.0, 145.0), ("gemm_wgmma", 200.0, 420.0),
              ("gemm_wgmma", 500.0, 950.0), ("copy", 1000.0, 1050.0)]
SHIFT = 1100.0


def _twice(spans_):
    return spans_ + [(n, s + SHIFT, e + SHIFT) for n, s, e in spans_]


HOST, DEVICE = _twice(FORWARD), _twice(DEVICE_OPS)
# A forward, by hand: the seam's own time is 300-340 and 680-700 of the
# MLP dispatch, 400-430 and 590-600 of the nested one, 920-930 and 975-980
# of the head's; the wrappers 450-580, 610-670 and 940-970.
SEAM_MS, WRAPPER_MS = 0.115, 0.220
SYNCS, WAIT_MS = 2, 0.080
# The step's idle time (110-120, 145-200, 420-500, 950-990), by the
# innermost program range open there.
IDLE_S = {"kernel:gemm.wgmma": 70e-6, "glue:rope": 55e-6,
          "lower:kernel": 25e-6, "step:prefill": 20e-6,
          "dispatch:matmul": 15e-6}
READERS = ("seam_ms.prefill", "wrapper_ms.prefill", "host_syncs.prefill",
           "host_wait_ms.prefill")


def _readings(host=HOST, with_trace=True):
    cell = load_cell("yi-6b.prefill-4k")
    r = harness.Readings(cell, work.forward_work(cell.config, 4, 4096))
    if with_trace:
        r.trace = trace.reduce_events(DEVICE, host)
        r.traced_forwards = 2
    return r


def test_readers_on_the_canned_trace():
    r = _readings()
    got = {name: metrics.load(name)(r) for name in READERS}
    assert got == pytest.approx({
        "seam_ms.prefill": SEAM_MS, "wrapper_ms.prefill": WRAPPER_MS,
        "host_syncs.prefill": SYNCS, "host_wait_ms.prefill": WAIT_MS})


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_programs_step(name):
    parent = [h for h in HOST if h[0] != "step:prefill"]
    assert metrics.load(name)(_readings(parent)) is None
    assert metrics.load(name)(_readings(with_trace=False)) is None


def test_idle_by_range_splits_the_steps_idle_time():
    t = trace.reduce_events(DEVICE, HOST)
    by = spans.idle_by_range(t)
    assert by == pytest.approx({k: 2 * v for k, v in IDLE_S.items()})
    assert list(by) == sorted(by, key=lambda k: -by[k])
    steps = spans.step_ranges(t)
    step_s = sum(e - s for _, s, e in steps) * 1e-6
    busy_in_steps = sum(max(0.0, min(e, se) - max(s, ss)) * 1e-6
                        for s, e in t.busy_intervals() for _, ss, se in steps)
    assert sum(by.values()) == pytest.approx(step_s - busy_in_steps)
    parent = trace.reduce_events(
        DEVICE, [h for h in HOST if h[0] != "step:prefill"])
    assert spans.idle_by_range(parent) == {}


def test_report_gives_the_split_and_the_readings_a_forward():
    got = spans.report(trace.reduce_events(DEVICE, HOST))
    assert got["forwards"] == 2
    assert got["step_ms"] == pytest.approx(0.880)
    assert got["idle_ms_by_range"] == pytest.approx(
        {k: 1e3 * v for k, v in IDLE_S.items()})
    assert got["idle_ms_split"] == pytest.approx(got["step_idle_ms"])
    assert got["step_idle_ms"] == pytest.approx(0.185)
    assert got["unattributed_share"] == pytest.approx(20 / 185)
    assert (got["seam_ms"], got["wrapper_ms"], got["host_syncs"],
            got["host_wait_ms"]) == pytest.approx(
                (SEAM_MS, WRAPPER_MS, SYNCS, WAIT_MS))
    assert got["ranges"]["kernel:gemm.wgmma"] == 3
    parent = trace.reduce_events(
        DEVICE, [h for h in HOST if h[0] != "step:prefill"])
    assert spans.report(parent) == {}


def test_report_of_a_kept_trace(tmp_path, capsys):
    path = str(tmp_path / "trace.json.gz")
    t = trace.reduce_events(DEVICE, HOST)
    spans._save(t, path)
    spans.main(["--load", path])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(spans.report(t)))
    assert printed["forwards"] == 2


def test_innermost_names_each_instant_by_the_range_opened_last():
    got = spans.innermost([("a", 0.0, 10.0), ("b", 2.0, 4.0),
                           ("c", 2.0, 3.0), ("d", 6.0, 12.0)])
    assert got == [("a", 0.0, 2.0), ("c", 2.0, 3.0), ("b", 3.0, 4.0),
                   ("a", 4.0, 6.0), ("d", 6.0, 12.0)]


def test_program_ranges_keep_only_the_programs_kinds():
    kept = {n for n, _, _ in spans.program_ranges(HOST)}
    assert kept == {"step:prefill", "layer:attn", "glue:rope",
                    "dispatch:mlp_block", "dispatch:matmul", "lower:kernel",
                    "kernel:gemm.wgmma"}


@pytest.mark.gpu
def test_kernel_ranges_match_the_launch_counters_on_the_card(card,
                                                             monkeypatch):
    cell = load_cell("yi-6b.prefill-4k")
    cell = dataclasses.replace(
        cell, config=dict(cell.config, num_hidden_layers=2),
        traffic=dict(cell.traffic, batch=2, seq_len=1024, warmup_forwards=1,
                     traced_forwards=1))
    kept = []
    from_profiler = trace.from_profiler
    monkeypatch.setattr(trace, "from_profiler",
                        lambda prof: kept.append(from_profiler(prof))
                        or kept[-1])
    out = harness.run(cell, 2 ** 31 + 11, 0.5, True, device=card,
                      t_start=0.0)
    assert out["correct"], out["checks"]
    by_range = {}
    for name, _, _ in spans.program_ranges(kept[0].host_ranges, ("kernel",)):
        by_range[name] = by_range.get(name, 0) + 1
    by_counter = {}
    for key, routes in out["routes"].items():
        module = key.split(".")[0]
        for route, n in routes.items():
            name = f"kernel:{module}.{route}"
            by_counter[name] = by_counter.get(name, 0) + n
    assert by_range == by_counter and by_counter
    assert isinstance(out["metrics"]["host_syncs.prefill"]["value"], float)
    names = {n for n, _, _ in spans.program_ranges(kept[0].host_ranges)}
    assert {"step:prefill", "layer:attn", "glue:rope", "lower:kernel",
            "kernel:gemm.wgmma", "kernel:flash_attention.wgmma"} <= names
