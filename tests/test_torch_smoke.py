"""The card check's reading of its profiles (``smoke/common.py``), on the
CPU: every kernel of ``src/repro_torch/kernels/csrc`` falls in one family
of the profile's family map, so none is counted as torch's own work, and
a profile's readings come from ``portbench/trace.py``'s reduction (busy
time the union of the device's operations)."""

import pathlib
import re
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import trace  # noqa: E402
from smoke.common import FAMILIES, family, readings  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                    r"(\w+)\s*\(")


def _kernels():
    names = {m.group(1) for path in sorted(CSRC.glob("*.cu*"))
             for m in GLOBAL.finditer(path.read_text())}
    assert len(names) >= 16, names
    return sorted(names)


@pytest.mark.parametrize("name", _kernels())
def test_every_kernel_has_its_own_family(name):
    # As the profiler names it: namespace, template arguments, signature.
    traced = f"void ns::{name}<128, __nv_bfloat16>(float const*, int)"
    hits = [f for f, keys in FAMILIES.items()
            if any(k in traced for k in keys)]
    assert family(traced) != "other"
    assert len(hits) == 1, hits


def test_readings_read_the_trace_through_portbench():
    device = [("void wg::gemm_wgmma<128>(x)", 10.0, 20.0),
              ("void at::elementwise_kernel<4>(y)", 15.0, 25.0),
              ("void wg::grouped_wgmma<bf16>(z)", 30.0, 40.0),
              ("void causal_conv_silu_kernel<bf16>(w)", 40.0, 44.0),
              ("void wg::gemm_wgmma<128>(x)", 50.0, 52.0),
              # outside the window: not the profiled call's
              ("void wg::gemm_wgmma<128>(x)", 200.0, 210.0)]
    host = [(trace.PHASES[1], 0.0, 100.0), ("aten::mm", 9.0, 11.0),
            ("cudaStreamSynchronize", 60.0, 70.0),
            ("cudaDeviceSynchronize", 90.0, 100.0)]
    got = readings(trace.reduce_events(device, host), 0.2)
    ms = got["device_ms_by_kernel"]
    assert ms["gemm"] == pytest.approx(0.012)
    assert ms["gemm_grouped"] == pytest.approx(0.010)
    assert ms["causal_conv_silu"] == pytest.approx(0.004)
    assert ms["other"] == pytest.approx(0.010)
    assert got["device_launches_by_kernel"] == {
        "gemm": 2, "flash_attention": 0, "flash_decode": 0,
        "ssd_chunk_diag": 0, "ssd_scan": 0, "gemm_grouped": 1,
        "causal_conv_silu": 1, "other": 1}
    # The union of the intervals: 10-25 overlap counts once.
    assert got["device_busy_ms"] == pytest.approx(0.031)
    assert got["device_idle_share"] == pytest.approx(1 - 0.031 / 0.2)
    assert got["gemm_device_ms_by_tile"]["gemm_wgmma"] == pytest.approx(0.012)
    assert got["host_waits"]["cudaStreamSynchronize"] == {
        "ms": pytest.approx(0.010), "calls": 1}
    assert got["host_sync_wait_ms"] == pytest.approx(0.010)
    assert got["top_kernels"][0] == {"name": "void wg::gemm_wgmma<128>(x)",
                                     "ms": pytest.approx(0.012),
                                     "launches": 2}
    empty = readings(trace.reduce_events([], host), 0.2)
    assert empty["device"] == "not measured"
