"""The check that decides ``correct``, driven through a whole run of the
harness on the CPU at a reduced size (the look for a card skipped): the
program's step passes, and the control (the reference in float8 in the
program's place) and each planted fault fail, with the cells' own limits."""

import json
import pathlib

import pytest

from portbench import faults, harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKLOADS = [w["name"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 77


def _run(cell, make_step, trace=False):
    return harness.run(cell, SEED, 0.05, trace, device="cpu", t_start=0.0,
                       make_step=make_step)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_and_prints_each_number_with_its_limit(tiny,
                                                               workload):
    cell = tiny(workload)
    out = _run(cell, harness.program_step, trace=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    for name, check in out["checks"].items():
        assert check["limit"] == cell.config["limits"][name]
        assert 0 < check["value"] <= check["limit"]
    assert out["attempted"] >= (cell.traffic["judged_forwards"]
                                + cell.traffic["traced_forwards"]) * 2
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("kind", ["control", *faults.FAULTS])
def test_control_and_faults_fail(tiny, workload, kind):
    make = faults.control if kind == "control" else faults.FAULTS[kind]
    out = _run(tiny(workload), make)
    assert not out["correct"], out["checks"]
