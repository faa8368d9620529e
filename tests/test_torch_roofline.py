"""The roofline twin (``repro_torch.roofline``) against the reference's
(``src/repro/roofline``): the op counter on known loop structures (the
twins of ``tests/test_hlo_parse.py``, with Python loops where the
reference has scans), the collective books under the reference's kind
names, the counter inside the emulated mesh's threads, and the roofline
terms on the same inputs."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline.analysis import TPU_V5E_HW as JTPU_V5E_HW
from repro.roofline.analysis import parse_collectives as jparse_collectives
from repro.roofline.analysis import roofline_terms as jroofline_terms
from repro_torch.core import blas
from repro_torch.core.accounting import offload_trace
from repro_torch.core.platform import H100_SXM
from repro_torch.roofline import (H100_SXM_HW, TPU_V5E_HW, parse_collectives,
                                  roofline_terms)
from repro_torch.roofline.op_count import count_ops
from repro_torch.sharding.spmd import Mesh, P, all_gather, psum, shard_map


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _count(fn, *args, mesh=None):
    with count_ops(mesh) as c:
        fn(*args)
    return c.costs()


def test_single_dot_exact():
    mc = _count(lambda a, b: a @ b, _meta(64, 32), _meta(32, 16))
    assert mc.dot_flops == 2 * 64 * 32 * 16
    assert mc.num_whiles == 0


def _chain(x, ws):
    for w in ws:            # the reference's lax.scan body, unrolled
        x = x @ w
    return x.sum()


@pytest.mark.parametrize("trip", [1, 5, 33])
def test_loop_trip_count(trip):
    mc = _count(_chain, _meta(128, 128), [_meta(128, 128)] * trip)
    assert mc.dot_flops == pytest.approx(2 * 128**3 * trip, rel=0.02)


def test_nested_loops():
    def g(x, ws):
        for wo in [torch.eye(128, device="meta")] * 3:
            for w in ws:
                x = x @ w
            x = x @ wo
        return x.sum()

    mc = _count(g, _meta(128, 128), [_meta(128, 128)] * 5)
    assert mc.dot_flops == pytest.approx(2 * 128**3 * (3 * 5 + 3), rel=0.02)


def test_traffic_nonzero_and_scales_with_trip():
    m1 = _count(_chain, _meta(64, 64), [_meta(64, 64)] * 2)
    m2 = _count(_chain, _meta(64, 64), [_meta(64, 64)] * 20)
    assert m1.traffic_bytes > 0
    assert m2.traffic_bytes > 5 * m1.traffic_bytes


def test_views_move_no_bytes():
    """A view or a metadata op adds no traffic (the twin of the
    reference's skipped bitcast / get-tuple-element ops); a copy does."""
    x = _meta(64, 64)
    assert _count(lambda x: x.reshape(16, 256).t()[2:4].unsqueeze(0),
                  x).traffic_bytes == 0
    # a reshape of a transposed view is a copy
    assert _count(lambda x: x.t().reshape(16, 256),
                  x).traffic_bytes == 2 * 64 * 64 * 4


def test_seam_op_counts_its_kernel_ideal_bytes():
    """A seam op's traffic is its descriptor's kernel-ideal bytes, not what
    its plain lowering dispatches (a bf16 product upcast to f32); its dot
    FLOPs are still counted from the ops."""
    x, w = _meta(2, 64, 96, dtype=torch.bfloat16), _meta(
        96, 48, dtype=torch.bfloat16)
    with offload_trace() as trace:
        mc = _count(blas.matmul, x, w)
    (rec,) = trace.records
    assert mc.traffic_bytes == rec.cost.touched_bytes
    assert mc.traffic_bytes == 2 * (2 * 64 * 96 + 96 * 48 + 2 * 64 * 48)
    assert mc.dot_flops == 2 * (2 * 64) * 96 * 48
    # the same product outside the seam counts every op it dispatches
    plain = _count(lambda x, w: (x.float() @ w.float()).to(x.dtype), x, w)
    assert plain.traffic_bytes > mc.traffic_bytes


def test_glue_around_the_seam_counts_its_own_bytes():
    x, w = _meta(128, 64), _meta(64, 32)
    with offload_trace() as trace:
        mc = _count(lambda x, w: blas.matmul(x, w) * 2.0, x, w)
    assert mc.traffic_bytes == (trace.total_touched_bytes()
                                + 2 * 128 * 32 * 4)


# The reference test's synthetic module: an all-gather of f32[8,8] to
# f32[64,8] and an all-reduce of f32[8,8].
_HLO = """
HloModule test
ENTRY %main (a: f32[8,8]) -> f32[8,8] {
  %a = f32[8,8] parameter(0)
  %ag = f32[64,8]{1,0} all-gather(%a), dimensions={0}
  %ar = f32[8,8]{1,0} all-reduce(%a), to_apply=%sum
  ROOT %out = f32[8,8] copy(%ar)
}
"""


def _gather_and_reduce(mesh):
    def body(a):
        return all_gather(a, "model", dim=0)[:8] + psum(a, "model")

    return shard_map(body, mesh=mesh, in_specs=(P("model"),),
                     out_specs=P("model"))


def test_collective_books_parse_like_the_hlo():
    """The same two collectives, run on an 8-device mesh, book what the
    reference parses from its module: one device's calls and result
    bytes under the HLO kind names."""
    mesh = Mesh((8,), ("model",), device="meta")
    try:
        with count_ops(mesh) as c:
            _gather_and_reduce(mesh)(_meta(64, 8))
    finally:
        mesh.close()
    want = jparse_collectives(_HLO)
    assert parse_collectives(mesh) == want
    assert parse_collectives(c) == want
    assert want["all-gather"]["bytes"] == 64 * 8 * 4
    costs = c.costs()
    assert costs.collective_bytes == 64 * 8 * 4 + 8 * 8 * 4
    assert costs.collective_counts == {"all-gather": 1, "all-reduce": 1,
                                       "total": 2}
    assert mesh.collectives["all_gather"]["bytes"] == [8 * 8 * 4] * 8
    assert mesh.collective_results["all_gather"] == [64 * 8 * 4] * 8


def test_counter_books_only_the_calls_it_saw():
    mesh = Mesh((8,), ("model",), device="meta")
    try:
        _gather_and_reduce(mesh)(_meta(64, 8))
        with count_ops(mesh) as c:
            _gather_and_reduce(mesh)(_meta(64, 8))
    finally:
        mesh.close()
    assert parse_collectives(c)["total"]["count"] == 2
    assert parse_collectives(mesh)["total"]["count"] == 4


def _sharded_matmul(mesh):
    return shard_map(lambda x, w: x @ w, mesh=mesh,
                     in_specs=(P(), P(None, "model")),
                     out_specs=P(None, "model"))


def test_mesh_bodies_count_the_unsharded_flops():
    """The mesh runs each body on a thread of its own and carries the
    caller's dispatch modes into it: a shard_map of one matmul over 8 mesh
    devices counts the unsharded FLOPs, in the port's counter and in
    torch's own FlopCounterMode alike; each device's tally is an eighth."""
    mesh = Mesh((8,), ("model",), device="meta")
    x, w = _meta(64, 32), _meta(32, 128)
    try:
        with count_ops(mesh) as c:
            _sharded_matmul(mesh)(x, w)
        with FlopCounterMode(display=False) as fc:
            _sharded_matmul(mesh)(x, w)
    finally:
        mesh.close()
    full = 2 * 64 * 32 * 128
    assert c.total().dot_flops == full
    assert fc.get_total_flops() == full
    assert all(c.tallies[d].dot_flops == full / 8 for d in range(8))
    assert c.costs().dot_flops == full / 8


def test_collective_math_is_left_to_the_books():
    """A psum's adds run on the last device's thread; the counter leaves
    them out of that device's tally, so every body counts alike."""
    mesh = Mesh((4,), ("model",), device="meta")
    try:
        with count_ops(mesh) as c:
            shard_map(lambda a: psum(a * 2, "model"), mesh=mesh,
                      in_specs=(P("model"),), out_specs=P())(_meta(32, 8))
    finally:
        mesh.close()
    bodies = [c.tallies[d] for d in range(4)]
    assert all(b == bodies[0] for b in bodies)
    assert c.costs().collective_bytes == 8 * 8 * 4


def test_outside_work_is_divided_over_the_mesh():
    mesh = Mesh((2, 4), ("data", "model"), device="meta")
    with mesh, count_ops(mesh) as c:
        _meta(64, 32) @ _meta(32, 16)
    mesh.close()
    assert c.tallies[None].dot_flops == 2 * 64 * 32 * 16
    assert c.costs().dot_flops == 2 * 64 * 32 * 16 / 8


@pytest.mark.parametrize("args", [
    (197e12, 819e9, 50e9),
    (3e15, 1e11, 7e9),
    (1e12, 4e12, 0.0),
    (0.0, 0.0, 2e12),
])
@pytest.mark.parametrize("chips", [1, 256])
def test_roofline_terms_equal_the_references(args, chips):
    r = roofline_terms(*args, chips=chips)
    j = jroofline_terms(*args, chips=chips)
    for f in ("compute_s", "memory_s", "collective_s", "flops",
              "bytes_accessed", "collective_bytes", "chips", "dominant",
              "bound_s"):
        assert getattr(r, f) == getattr(j, f), f
    assert r.fraction_of_roofline(1e12) == j.fraction_of_roofline(1e12)


def test_roofline_terms_math():
    r = roofline_terms(197e12, 819e9, 50e9, chips=1)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)
    assert r.dominant in ("compute", "memory", "collective")
    assert TPU_V5E_HW == type(TPU_V5E_HW)(*vars(JTPU_V5E_HW).values())


def test_h100_row_and_its_own_peak():
    """The H100 row is the platform row's figures; the port's
    fraction_of_roofline divides by the peak of the row that made the
    terms (the reference's by the v5e peak whatever the row)."""
    assert (H100_SXM_HW.peak_flops, H100_SXM_HW.hbm_bw,
            H100_SXM_HW.link_bw) == (H100_SXM.dev_flops, H100_SXM.dev_mem_bw,
                                     H100_SXM.d2d_bw)
    r = roofline_terms(989e12, 1e9, 0.0, chips=1, hw=H100_SXM_HW)
    assert r.dominant == "compute" and r.bound_s == pytest.approx(1.0)
    assert r.fraction_of_roofline(989e12) == pytest.approx(1.0)
