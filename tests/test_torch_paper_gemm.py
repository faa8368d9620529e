"""The paper's own workload on the port: ``configs/paper_gemm.py`` against
the reference's, and the routing and modeled regions of its GEMMs on the
paper's board (``hesoc-vcu128``) against the reference's, for every paper
size and dtype; then the Fig. 3 tool's routes, bars and modeled rows.

The reference runs with JAX's x64 off (``tests/conftest.py``), so it holds
no f64 array: its f64 row is the launch its own gate makes for an f64 GEMM
(``_pallas_gemm_eligible`` rejects f64: ``src/repro/core/blas.py:91-98``),
issued through its cluster with the f64 cost.  The port keeps f64 on the
card and takes the same plain ``device`` path.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.paper_gemm import PAPER_DTYPE as J_DTYPE
from repro.configs.paper_gemm import PAPER_SIZES as J_SIZES
from repro.core import blas as jblas
from repro.core import cost_model as jcm
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import engine as jengine
from repro.core.hero import offload_policy as jpolicy
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import list_archs
from repro_torch.configs.paper_gemm import PAPER_DTYPE, PAPER_SIZES
from repro_torch.core import blas as tblas
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import offload_policy as tpolicy

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import paper_fig3_h100 as fig3  # noqa: E402
from config_parity import assert_config_equal  # noqa: E402

BACKEND = {"device-pallas": "device-kernel"}
DTYPES = ["float64", "float32", "bfloat16"]


def test_paper_gemm_config_equals_reference():
    assert PAPER_SIZES == J_SIZES == (16, 32, 64, 128)
    assert PAPER_DTYPE == J_DTYPE == "float64"
    assert_config_equal(tget_arch("paper-gemm"), jget_arch("paper-gemm"))
    assert_config_equal(tget_arch("paper-gemm").reduced(),
                        jget_arch("paper-gemm").reduced())
    assert "paper-gemm" in list_archs()


def _record(r):
    return (r.op, r.shape_key, r.dtype, BACKEND.get(r.backend, r.backend),
            r.device_id, r.resident_fraction, r.count,
            dataclasses.astuple(r.cost), dataclasses.asdict(r.regions),
            r.regions.offload_s, r.regions.speedup)


def _ref_record(n, dtype):
    with jpolicy(mode="device", use_pallas=True, interpret=True,
                 platform="hesoc-vcu128"), jtrace() as jt:
        if dtype == "float64":
            jengine().launch(
                jcm.gemm_cost(n, n, n, 8), dtype="float64",
                shape_key=f"{n}x{n}:float64;{n}x{n}:float64",
                pallas_eligible=jblas._pallas_gemm_eligible(
                    n, n, n, jnp.float64))
        else:
            spec = jax.ShapeDtypeStruct((n, n), getattr(jnp, dtype))
            jax.eval_shape(jblas.gemm, spec, spec)
    (rec,) = jt.records
    return rec


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", PAPER_SIZES)
def test_paper_gemm_routing_and_regions_match_reference(n, dtype):
    want = _ref_record(n, dtype)
    a = torch.ones((n, n), dtype=getattr(torch, dtype))
    with tpolicy(mode="device", use_kernels=True,
                 platform="hesoc-vcu128"), ttrace() as tt:
        c = tblas.gemm(a, a)
    (got,) = tt.records
    assert _record(got) == _record(want)
    assert got.backend == ("device" if dtype == "float64"
                           else "device-kernel")
    assert got.backend == fig3.want_route(dtype, n)[0]
    assert c.dtype == a.dtype and torch.all(c == n)


@pytest.mark.parametrize("n", PAPER_SIZES)
def test_paper_gemm_f64_accumulates_in_f64(n):
    """The paper's dtype stays f64 through the plain path (its fp32
    accumulation applies to f32 / bf16 operands)."""
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    with tpolicy(mode="device", use_kernels=True):
        c = tblas.gemm(torch.from_numpy(a), torch.from_numpy(b))
    ref = a @ b
    assert c.dtype == torch.float64
    assert np.abs(c.numpy() - ref).max() <= fig3.BARS["float64"] * \
        np.abs(ref).max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", PAPER_SIZES)
def test_fig3_tool_modeled_rows_match_reference_cost_model(n, dtype):
    """The tool's modeled rows are the reference cost model's serial
    breakdowns of the same GEMM (``benchmarks/paper_fig3.py``'s math)."""
    from repro.core.platform import get_platform as jplatform

    itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    rows = fig3.modeled(n, itemsize)
    assert set(rows) == {"h100-sxm", "hesoc-vcu128"}
    bd = jcm.breakdown(jcm.gemm_cost(n, n, n, itemsize),
                       jplatform("hesoc-vcu128"))
    assert rows["hesoc-vcu128"] == {
        "host_ms": 1e3 * bd.host_s, "copy_ms": 1e3 * bd.copy_s,
        "fork_join_ms": 1e3 * bd.fork_join_s,
        "compute_ms": 1e3 * bd.compute_s, "offload_ms": 1e3 * bd.offload_s,
        "speedup": bd.speedup}


def test_fig3_tool_routes_and_bars():
    assert [fig3.want_route(d, n) for d in DTYPES for n in (16, 32, 128)] == [
        ("device", None)] * 3 + [
        ("device-kernel", "skinny"), ("device-kernel", "tf32x3"),
        ("device-kernel", "tf32x3"), ("device-kernel", "skinny"),
        ("device-kernel", "wgmma"), ("device-kernel", "wgmma")]
    assert fig3.BARS == {"float64": 1e-12, "float32": 2e-5,
                         "bfloat16": 2e-2}
    info = fig3.blas_info()
    assert info["cpu_count"] and "blas" in info


def test_fig3_tool_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs the card"):
        fig3.run(sizes=(16,), crossover=False)
