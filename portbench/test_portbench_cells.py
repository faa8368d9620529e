"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric is found by its name, and the traffic is the same
from one seed."""

import json
import pathlib
import re

import pytest
import torch

from portbench import cells, harness, judge, metrics
from portbench.work import padded_vocab

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = sorted(p.stem for p in (cells.HERE / "configs").glob("*.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_are_found_by_name(workload):
    cell = cells.load_cell(workload)
    assert cell.traffic["name"] == [w for w in BENCH["workloads"]
                                    if w["name"] == workload][0]["traffic"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(metrics.load(m["name"]))
    assert set(judge.NUMBERS) <= set(cell.config["limits"])
    harness.reference_of(cell.config)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_arch_takes_the_published_sizes(workload):
    cfg = cells.load_cell(workload).config
    arch = cells.port_arch(cfg)
    for field, key in cfg["port"]["fields"].items():
        want = (padded_vocab(cfg) if field == "vocab_size"
                else cfg[key])
        assert getattr(arch, field) == want, field


def test_benchmark_json_keeps_to_its_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    every = [c["name"] for c in BENCH["configs"]] + WORKLOADS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in every)
    assert len(set(every)) == len(every)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves and m["layer"]
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traffic_is_the_same_from_one_seed(workload):
    traffic = dict(cells.load_cell(workload).traffic, batch=3, seq_len=16)
    big = 2 ** 31 + 12345
    a = harness.batches(traffic, 1000, big, "cpu")
    b = harness.batches(traffic, 1000, big, "cpu")
    c = harness.batches(traffic, 1000, big + 1, "cpu")
    first = [next(a) for _ in range(3)]
    assert all(torch.equal(x, next(b)) for x in first)
    assert not torch.equal(first[0], next(c))
    assert not torch.equal(first[0], first[1])
    assert first[0].shape == (3, 16) and int(first[0].max()) < 1000


@pytest.mark.parametrize("workload", WORKLOADS)
def test_weight_layout_is_the_programs(tiny, workload):
    from repro_torch.models import build_model

    from portbench.weights import _leaves, layout

    cfg = tiny(workload).config
    want = {p: (tuple(t.shape), t.dtype) for p, t in _leaves(
        build_model(cells.port_arch(cfg)).param_specs())}
    got = {p: (tuple(s.shape), s.dtype) for p, s in _leaves(layout(cfg))}
    assert got == want


def test_weights_are_the_same_from_one_seed(tiny):
    from portbench.weights import _leaves, layout, make_params

    cfg = tiny(WORKLOADS[0]).config
    specs = layout(dict(cfg, hidden_size=32, head_dim=8))
    a = make_params(specs, 2 ** 40 + 1, "cpu")
    b = make_params(specs, 2 ** 40 + 1, "cpu")
    c = make_params(specs, 2 ** 40 + 2, "cpu")
    wq = lambda p: p["stack"][1]["mixer"]["wq"]  # noqa: E731
    assert torch.equal(wq(a), wq(b)) and not torch.equal(wq(a), wq(c))
    assert wq(a).dtype == torch.bfloat16 and wq(a).shape == (32, 32)
    # Every leaf starts on a 256-byte boundary of its flat buffer.
    assert all(t.storage_offset() * t.element_size() % 256 == 0
               for _, t in _leaves(a))


@pytest.mark.parametrize("name", CONFIGS)
def test_routes_name_the_kernels_to_build_and_count(name):
    from repro_torch.kernels import _build

    cfg = cells.load_config(name)
    assert set(harness.kernel_sources(cfg)) <= set(_build.KERNEL_SOURCES)
    assert "flash_decode" not in harness.kernel_sources(cfg)
    for key, fn in harness._wrappers(cfg).items():
        assert cfg["routes"][key] in fn.route_launches, key
