"""Phase 15 (``roofline-*``): the dry run on meta tensors of a mini cell
and of yi-6b's decode_32k cell, and phases 4 and 8's forwards beside the
roofline terms of their counted work.
"""

from __future__ import annotations

import dataclasses
import time

from smoke.common import emit, fail
from smoke.shapes import (ARCH, DIST_MESH, ROOFLINE_CELL, ROOFLINE_MINI,
                          ROOFLINE_MINI_TOKENS, expected)


def _mini_forward_flops(cfg, bsz, seq):
    """tests/test_sharding.py's analytic forward of the mini cell."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv, dff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    t = bsz * seq
    return (2 * t * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d
                     + 3 * d * dff) * cfg.num_layers
            + 2 * t * d * cfg.vocab_size
            + 4 * bsz * hq * seq * seq * hd * cfg.num_layers)


_DRYRUN_KEYS = (
    "status", "chips", "compile_s", "dot_flops_per_device",
    "traffic_bytes_per_device", "collective_bytes_per_device",
    "collective_bytes_per_device_booked",
    "collective_bytes_per_device_derived", "collective_counts",
    "shard_map_calls", "ops_counted", "memory_analysis",
    "dot_flops_counted_global", "seam_flops_global", "tokens_per_step")


def run_roofline(tally, forwards):
    """Phase 15: (a) the dry run (``repro_torch.launch.dryrun``) of the
    mini cell on an emulated (2, 4) mesh and of one yi-6b production cell
    on the 16 x 16 mesh, on meta tensors: status ok, the mini cell within
    tests/test_sharding.py's bounds on its analytic forward, no kernel
    launched; each record's per-device figures and host seconds.  (b)
    ``forwards`` maps yi-6b and mamba2-370m to what phases 4 and 8
    measured of their full-width forwards on the kernels (launches, device
    busy ms profiled, wall); beside it, the roofline terms of the same
    forward's work counted on meta (``roofline.op_count``) on the H100
    row, once with the seam's kernel-ideal bytes alone and once with the
    counted traffic (the seam's bytes plus the glue's), each a bound that
    must not exceed the measured busy time."""
    import shutil

    from repro_torch.configs import ALL_SHAPES, get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.spmd import Mesh

    t_phase = time.perf_counter()
    out_dir = tally.out_dir / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)   # run_cell reads back a
    tally.zero()                                 # record already written
    mini = dataclasses.replace(get_arch(ARCH).reduced(), **ROOFLINE_MINI)
    bsz, seq = ROOFLINE_MINI_TOKENS
    mesh = Mesh(DIST_MESH, ("data", "model"), device="meta")
    try:
        rec = dryrun.run_cell(mini, ShapeConfig("mini_train", seq, bsz,
                                                "train"),
                              mesh, "mini2x4", out_dir)
    finally:
        mesh.close()
    fwd = _mini_forward_flops(mini, bsz, seq)
    if rec["status"] != "ok":
        fail(f"dry run of the mini cell: {rec.get('error')}")
    ratio = rec["dot_flops_per_device"] * mesh.size / fwd
    if not (2.0 < ratio < 8.0 and rec["collective_bytes_per_device"] > 0):
        fail(f"mini cell: {mesh.size} x per-device dot FLOPs = {ratio} x "
             f"the analytic forward (want 2-8), collective bytes "
             f"{rec['collective_bytes_per_device']}")
    emit({"phase": "roofline-dryrun", "cell": "mini (tests/test_sharding.py)",
          "mesh": f"emulated {DIST_MESH}", "analytic_forward_flops": fwd,
          "mesh_x_per_device_over_forward": ratio,
          **{k: rec.get(k) for k in _DRYRUN_KEYS}})

    (cell,) = [c for c in ALL_SHAPES if c.name == ROOFLINE_CELL]
    prod = make_production_mesh(device="meta")
    try:
        rec = dryrun.run_cell(ARCH, cell, prod, "pod16x16", out_dir)
    finally:
        prod.close()
    if rec["status"] != "ok":
        fail(f"dry run of {ARCH} x {cell.name}: {rec.get('error')}")
    emit({"phase": "roofline-dryrun", "cell": f"{ARCH} x {cell.name}",
          "mesh": "pod16x16 (emulated, 256 devices)",
          **{k: rec.get(k) for k in _DRYRUN_KEYS}})
    if any(tally.counts().values()):
        fail(f"the dry run on meta launched kernels: {tally.counts()}")

    for arch, measured in forwards.items():
        out = _roofline_forward(get_arch(arch), measured)
        emit({"phase": f"roofline-{arch}", **out})
    emit({"phase": "roofline", "seconds": time.perf_counter() - t_phase})


def _roofline_forward(cfg, fwd):
    """One forward of phase 15 (b); see :func:`run_roofline`."""
    import torch

    from repro_torch.core.accounting import offload_trace
    from repro_torch.models import build_model
    from repro_torch.roofline import H100_SXM_HW, roofline_terms
    from repro_torch.roofline.op_count import count_ops

    want, _ = expected(cfg, "forward", "eager")
    if fwd["launches"]["eager"] != want:
        fail(f"{cfg.name} forward launches {fwd['launches']['eager']}, "
             f"want {want}")
    busy_ms = fwd["profile_eager"].get("device_busy_ms")
    wall_ms = 1e3 * fwd["seconds"]["eager"]
    model = build_model(cfg)
    params = model.param_specs()
    tokens = torch.empty((fwd["batch"], fwd["seq"]), dtype=torch.int64,
                         device="meta")
    t0 = time.perf_counter()
    with torch.no_grad(), offload_trace() as trace, count_ops() as counter:
        model.forward(params, tokens)
    count_s = time.perf_counter() - t0
    costs = counter.costs()
    terms = {}
    for name, nbytes in (("seam_bytes", trace.total_touched_bytes()),
                         ("counted_traffic", costs.traffic_bytes)):
        r = roofline_terms(costs.dot_flops, nbytes, 0.0, chips=1,
                           hw=H100_SXM_HW)
        bound_ms = 1e3 * r.bound_s
        if busy_ms and bound_ms > busy_ms:
            fail(f"{cfg.name} roofline bound ({name}) {bound_ms} ms exceeds "
                 f"the measured busy {busy_ms} ms")
        terms[name] = {
            "bytes": nbytes, "compute_ms": 1e3 * r.compute_s,
            "memory_ms": 1e3 * r.memory_s, "bound_ms": bound_ms,
            "dominant": r.dominant,
            "share_of_busy": (bound_ms / busy_ms if busy_ms
                              else "not measured"),
            "share_of_wall": bound_ms / wall_ms}
    return {"arch": cfg.name, "dtype": cfg.dtype, "batch": fwd["batch"],
            "seq": fwd["seq"], "hw": dataclasses.asdict(H100_SXM_HW),
            "measured_in": "phase 8 (ssm-forward)" if cfg.family == "ssm"
            else "phase 4 (forward)",
            "launches": fwd["launches"]["eager"], "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": fwd["profile_eager"].get(
                "device_idle_share"),
            "counted": {"dot_flops": costs.dot_flops,
                        "traffic_bytes": costs.traffic_bytes,
                        "ops": counter.total().ops, "host_s": count_s},
            "seam": {"flops": trace.total_flops(),
                     "touched_bytes": trace.total_touched_bytes()},
            "roofline": terms}
