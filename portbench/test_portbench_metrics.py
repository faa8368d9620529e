"""Each metric's reader on a canned trace and canned window readings."""

import dataclasses

import pytest

from portbench import metrics, trace, work
from portbench.cells import load_cell, load_config
from portbench.harness import Readings

# A canned profile of two traced forwards (µs on the profiler's clock):
# the harness's phases on the host, a launch and a copy inside them, and
# on the device a GEMM, an attention kernel, an SSD kernel and torch glue,
# with a gap while the host makes inputs.
HOST = [
    ("make inputs", 0.0, 100.0), ("aten::randint", 10.0, 90.0),
    ("prefill step", 100.0, 600.0), ("cudaLaunchKernel", 150.0, 160.0),
    ("synchronise", 600.0, 1000.0),
    ("make inputs", 1000.0, 1100.0), ("prefill step", 1100.0, 1600.0),
    ("synchronise", 1600.0, 2000.0),
]
DEVICE = [
    ("void gemm_wgmma_kernel<128>(...)", 120.0, 520.0),
    ("attn_wgmma_kernel", 520.0, 620.0),
    ("elementwise_kernel<add>", 610.0, 700.0),       # overlaps: one union
    ("ssd_mma_kernel", 700.0, 900.0),
    ("Memcpy DtoD", 900.0, 950.0),
    ("void gemm_wgmma_kernel<128>(...)", 1120.0, 1900.0),
    ("outside the window", 5000.0, 6000.0),
]


def _readings(config="", with_trace=True):
    cell = load_cell("yi-6b.prefill-4k")
    if config:
        cell = dataclasses.replace(cell, config=load_config(config))
    r = Readings(cell, work.forward_work(cell.config, 4, 4096))
    r.window_s, r.forwards, r.tokens = 2.0, 3, 3 * 16384
    r.setup_s = 9.5
    r.enqueue_s = [0.08, 0.09, 0.10]
    if with_trace:
        r.trace = trace.reduce_events(DEVICE, HOST)
        r.traced_forwards = 2
    return r


def test_trace_reduction():
    t = trace.reduce_events(DEVICE, HOST)
    assert t.window == (0.0, 2000.0) and t.window_s == pytest.approx(2e-3)
    assert t.busy_intervals() == [(120.0, 950.0), (1120.0, 1900.0)]
    assert t.busy_s == pytest.approx((830 + 780) * 1e-6)
    top = t.top_ops(2)
    assert top[0][0].startswith("void gemm_wgmma")
    assert top[0][1] == pytest.approx(1180e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["make inputs / aten::randint"] == pytest.approx(120e-6)
    assert gaps["synchronise"] == pytest.approx(100e-6)
    assert gaps["make inputs"] == pytest.approx(170e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_end_to_end_readers():
    r = _readings()
    assert metrics.load("prefill_tokens_per_s")(r) == 3 * 16384 / 2.0
    assert metrics.load("setup_s")(r) == 9.5


def test_per_layer_readers():
    r = _readings()
    assert metrics.load("enqueue_ms.prefill")(r) == pytest.approx(90.0)
    want = 100 * 3 * r.model_flops / (2.0 * work.PEAKS["bfloat16"])
    assert metrics.load("mfu.prefill")(r) == pytest.approx(want)
    total = 400 + 100 + 90 + 200 + 50 + 780
    assert metrics.load("glue_share.prefill")(r) == pytest.approx(
        100 * 140 / total)
    assert metrics.load("idle_share.prefill")(r) == pytest.approx(
        100 * (1 - 1610 / 2000))
    gemm = sum(work.ideal_seconds(w) for w in r.forward_work
               if w["family"] == "gemm")
    assert metrics.load("gemm_roofline.prefill")(r) == pytest.approx(
        100 * 2 * gemm / 1180e-6)
    attn = sum(work.ideal_seconds(w) for w in r.forward_work
               if w["family"] == "attention")
    assert metrics.load("attention_roofline.prefill")(r) == pytest.approx(
        100 * 2 * attn / 100e-6)
    # yi-6b's forward has no SSD work: the reader finds nothing to read.
    assert metrics.load("ssd_roofline.prefill")(r) is None


def test_readers_find_nothing_without_a_trace_or_a_kernel():
    r = _readings(with_trace=False)
    for name in ("glue_share.prefill", "idle_share.prefill",
                 "gemm_roofline.prefill", "attention_roofline.prefill",
                 "ssd_roofline.prefill"):
        assert metrics.load(name)(r) is None
    r = _readings("mamba2-370m")
    r.forward_work = work.forward_work(r.config, 16, 2048)
    r.trace = trace.reduce_events([d for d in DEVICE if "ssd" not in d[0]],
                                  HOST)
    assert metrics.load("ssd_roofline.prefill")(r) is None


def test_unknown_metric_has_no_reader():
    with pytest.raises(FileNotFoundError):
        metrics.load("no_such_metric")


def test_ssd_reader_on_mamba2_work():
    r = _readings("mamba2-370m")
    r.forward_work = work.forward_work(r.config, 16, 2048)
    ssd = sum(work.ideal_seconds(w) for w in r.forward_work
              if w["family"] == "ssd")
    assert metrics.load("ssd_roofline.prefill")(r) == pytest.approx(
        100 * 2 * ssd / 200e-6)
