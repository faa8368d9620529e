"""The port's Chrome trace export (``repro_torch.obs.trace_export``)
against the reference's: the same tracer contents give the same JSON, byte
for byte, and the validator, ``self_time`` and ``summarize`` agree."""

import dataclasses
import json

import pytest

from repro.core import cost_model as jcm
from repro.core import hero as jhero
from repro.core.platform import get_platform as jplatform
from repro.obs import spans as jspans
from repro.obs import trace_export as jexport
from repro_torch.core import cost_model as tcm
from repro_torch.core import hero as thero
from repro_torch.core.platform import get_platform as tplatform
from repro_torch.obs import spans as tspans
from repro_torch.obs import trace_export as texport

PKGS = {"ref": (jspans, jexport, jhero, jcm, jplatform),
        "port": (tspans, texport, thero, tcm, tplatform)}


def _by_hand(spans):
    """Every event kind, nested spans and counters, through the tracer
    API alone."""
    tr = spans.SpanTracer("hand")
    outer = tr.begin("graph:g", "host", "host", 0.0, attrs={"nodes": 3})
    tr.emit("launch:gemm", "stream", "dev0/dma", 0.0, 1.5e-6,
            attrs={"ticket": True}, device_id=0)
    tr.emit("launch:gemm", "stream", "dev0/compute", 1.5e-6, 4e-6,
            device_id=0)
    inner = tr.begin("wave0", "host", "host", 1e-7)
    tr.instant("fuse", "host", "host", 2e-7, attrs={"ops": ["tanh"]})
    tr.end(inner, 3e-6)
    tr.emit("launch:gemm", "stream", "dev1/compute", 2e-6, 9e-6,
            device_id=1)
    tr.flow("d2d:kv", "stream", "dev0/compute", 4e-6, "dev1/dma", 6e-6,
            attrs={"nbytes": 1024.0})
    tr.async_begin("req", "request", "requests", 0.0, 7)
    tr.async_instant("first-token", "request", "requests", 5e-6, 7)
    tr.async_end("req", "request", "requests", 9e-6, 7)
    tr.counter("dev0/inflight", 0.0, 1.0, device_id=0)
    tr.counter("dev1/resident_bytes", 6e-6, 1024.0, device_id=1)
    tr.emit("other", "misc", "aimd", 1e-6, 2e-6)
    tr.end(outer, 1e-5, attrs={"done": True})
    return tr


def _cluster_run(pkg):
    """A traced cluster run: launches, a pin, a d2d migration, a device
    loss (requeue), a host re-stage, a resize."""
    spans, _, hero, cm, platform = PKGS[pkg]
    cluster = hero.HeroCluster(num_devices=3, platform=platform("tpu-v5e"),
                               scheduler="cost-aware")
    cluster.policy = dataclasses.replace(cluster.policy, mode="device")
    with spans.span_trace("cluster") as tr:
        for i, n in enumerate((64, 256, 1024, 128)):
            cluster.launch(cm.gemm_cost(n, n, 64, 4), dtype="float32",
                           shape_key=f"g{i}")
        kv = cluster.pin_handle("kv", 4.0e6, device_id=0)
        with cluster.pin_device(2):
            cluster.launch(cm.gemm_cost(8, 4096, 4096, 2), dtype="bfloat16",
                           shape_key="decode", handle=kv)
        cluster.migrate_handle(kv, 1)
        cluster.fail_device(1)
        cluster.restage_handle(kv)
        cluster.resize(2)
    streams = {d.device_id: list(d.inflight) for d in cluster.devices}
    return tr, streams


def _json(trace):
    return json.dumps(trace, sort_keys=False)


def test_hand_built_trace_json_equal():
    jt, tt = _by_hand(jspans), _by_hand(tspans)
    meta = {"otherData": {"arch": "yi-6b"}}
    want = jexport.chrome_trace(jt, meta=meta)
    got = texport.chrome_trace(tt, meta=meta)
    assert _json(got) == _json(want)
    assert texport.validate_chrome_trace(got) == []
    phases = {ev["ph"] for ev in got["traceEvents"]}
    assert phases == {"M", "X", "i", "s", "f", "b", "e", "n", "C"}
    # several tracers, one Perfetto process each
    assert _json(texport.chrome_trace([tt, tt])) == \
        _json(jexport.chrome_trace([jt, jt]))


def test_cluster_trace_json_equal():
    (jt, jstreams), (tt, tstreams) = _cluster_run("ref"), _cluster_run("port")
    got, want = texport.chrome_trace(tt), jexport.chrome_trace(jt)
    assert _json(got) == _json(want)
    assert texport.validate_chrome_trace(got) == []
    names = {ev["name"] for ev in got["traceEvents"]}
    assert {"requeue:gemm", "restage:restage", "d2d:kv",
            "d2d:d2d_copy"} <= names
    # raw ticket streams export losslessly, the same in both packages
    tk, jk = texport.ticket_spans(tstreams), jexport.ticket_spans(jstreams)
    assert [dataclasses.astuple(s) for s in tk] == \
        [dataclasses.astuple(s) for s in jk]
    tickets = sum(len(v) for v in tstreams.values())
    covered = {(s.attrs["device_id"], s.attrs["issue_s"], s.attrs["op"])
               for s in tk}
    assert len(covered) == tickets
    assert _json(texport.chrome_trace(
        [tt, _as_tracer(tspans, tk)])) == _json(jexport.chrome_trace(
            [jt, _as_tracer(jspans, jk)]))


def _as_tracer(spans, span_list):
    tr = spans.SpanTracer("tickets")
    tr.spans.extend(span_list)
    return tr


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_validator_catches_unpaired_flow_and_bad_events(pkg):
    spans, export, *_ = PKGS[pkg]
    tr = _by_hand(spans)
    trace = export.chrome_trace(tr)
    flow_end = next(i for i, ev in enumerate(trace["traceEvents"])
                    if ev["ph"] == "f")
    del trace["traceEvents"][flow_end]
    errs = export.validate_chrome_trace(trace)
    assert any("1 starts vs 0 finishes" in e for e in errs)
    bad = {"traceEvents": [{"ph": "X", "ts": -1.0, "name": "a"},
                           {"ph": "X", "ts": 0.0, "name": "b"},
                           {"name": "c"},
                           {"ph": "b", "ts": 0.0, "name": "d"},
                           {"ph": "s", "ts": 0.0, "name": "e"},
                           {"ph": "b", "ts": 0.0, "id": "9", "name": "g"},
                           {"ph": "i", "ts": "x", "name": "h"}]}
    assert texport.validate_chrome_trace(bad) == \
        jexport.validate_chrome_trace(bad)
    assert len(export.validate_chrome_trace(bad)) == 8
    assert export.validate_chrome_trace({}) == \
        ["traceEvents missing or not a list"]


def test_self_time_and_summarize_equal():
    jt, tt = _by_hand(jspans), _by_hand(tspans)
    assert texport.self_time(tt.spans) == jexport.self_time(jt.spans)
    assert texport.summarize(tt.spans, top=3) == \
        jexport.summarize(jt.spans, top=3)
    (jt, _), (tt, _) = _cluster_run("ref"), _cluster_run("port")
    assert texport.self_time(tt.spans) == jexport.self_time(jt.spans)
    assert texport.summarize(tt.spans) == jexport.summarize(jt.spans)
    # a span's own time excludes its direct child spans (not instants),
    # floored at 0 when they cover more than its window
    st = texport.self_time(_by_hand(tspans).spans)
    assert st["host"]["wave0"] == pytest.approx(3e-6 - 1e-7)
    assert st["host"]["graph:g"] == 0.0


def test_write_trace_round_trips(tmp_path):
    tt = _by_hand(tspans)
    trace = texport.chrome_trace(tt)
    path = texport.write_trace(str(tmp_path / "t.json"), trace)
    with open(path) as f:
        text = f.read()
    assert text.endswith("\n") and json.loads(text) == trace
    jpath = jexport.write_trace(str(tmp_path / "j.json"),
                                jexport.chrome_trace(_by_hand(jspans)))
    with open(jpath) as f:
        assert f.read() == text


def test_obs_package_exports_trace_export():
    import repro_torch.obs as obs

    for name in texport.__all__:
        assert getattr(obs, name) is getattr(texport, name)
        assert name in obs.__all__
