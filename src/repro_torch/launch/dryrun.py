"""Multi-pod dry run: evaluate every (arch × shape) cell on meta tensors
under the production mesh, and record its per-device work, memory and
collectives for the roofline.  The twin of ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell with ``jax.jit`` on 512 forced
host devices and parses the compiled HLO.  Here nothing is compiled or
allocated: the cell's step (train, prefill or serve) runs once on meta
tensors (shapes and dtypes, no data) under
``make_production_mesh(device="meta")``, the emulated mesh of
:mod:`repro_torch.sharding.spmd`, inside
:func:`repro_torch.roofline.op_count.count_ops`, with the default offload
policy (the plain versions: a kernel has nothing to launch on meta).  The
``shard_map`` bodies of the tensor-, expert- and head-parallel plans run
once per mesh device and book their collectives; what GSPMD would insert
around them and the emulated mesh does not run (the gradient reduction
over the data axes, FSDP's weight all-gathers) is derived from the
partition specs and reported beside the booked figures, under its own
names.

The mesh runs one thread a mesh device, so a production cell costs host
time: ≈ 0.2 s a ``shard_map`` call at 256 devices.  A whole ``--all``
sweep is a tool to run off line.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out artifacts/dryrun]
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import tree
from repro_torch.configs import ALL_SHAPES, get_arch, list_archs, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import accounting
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (
    TrainOptions,
    init_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models import build_model
from repro_torch.roofline.analysis import parse_collectives
from repro_torch.roofline.op_count import count_ops
from repro_torch.sharding import (
    batch_pspecs,
    cache_pspecs,
    dp_axes,
    opt_pspecs,
    param_pspecs,
)
from repro_torch.sharding.spmd import P

__all__ = ["lower_cell", "main", "params_abstract", "run_cell",
           "seam_costs"]


def _config(arch) -> ArchConfig:
    """A registered arch's config, or ``arch`` itself when it is one (a
    config cut to size, as a test's cell is)."""
    return arch if isinstance(arch, ArchConfig) else get_arch(arch)


def seam_costs(arch_name, shape: ShapeConfig):
    """Kernel-ideal workload from the BLAS seam (trace-time accounting).

    Forward ops are recorded once a layer by the eager loop; for training
    the backward+remat factor is applied analytically: matmul backward = 2
    extra GEMMs per forward GEMM, remat re-runs forward (factor 4 with
    remat, 3 without).  ``touched_bytes`` assumes each op streams
    operands/results exactly once — the tiled execution the device kernels
    implement (kernel-ideal HBM traffic)."""
    cfg = _config(arch_name)
    model = build_model(cfg)
    specs = model.input_specs(shape)
    params = params_abstract(model)
    with torch.no_grad(), accounting.offload_trace() as trace:
        if shape.kind in ("train", "prefill"):
            model.forward(params, specs)
        else:
            model.decode_step(params, specs["cache"], specs["tokens"],
                              specs["cache_index"])
    fwd_flops = trace.total_flops()
    fwd_bytes = trace.total_touched_bytes()
    if shape.kind == "train":
        factor = 4.0 if cfg.remat else 3.0
        return fwd_flops * factor, fwd_bytes * factor
    return fwd_flops, fwd_bytes


_PARAMS_ABSTRACT_CACHE = {}


def params_abstract(model):
    """The model's meta parameters, built once a config."""
    key = model.cfg
    if key not in _PARAMS_ABSTRACT_CACHE:
        _PARAMS_ABSTRACT_CACHE[key] = model.param_specs()
    return _PARAMS_ABSTRACT_CACHE[key]


# ---------------------------------------------------------------------------
# per-device bytes from the partition specs
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, P)


def _pairs(values, specs) -> List[Tuple[torch.Tensor, P]]:
    """(tensor leaf, its spec), matched by path."""
    by_path = dict(tree.leaves_with_paths(specs, is_leaf=_is_spec))
    return [(leaf, by_path[path])
            for path, leaf in tree.leaves_with_paths(values)
            if isinstance(leaf, torch.Tensor)]


def _shards(mesh, spec: P, axes=None) -> int:
    """Mesh devices a leaf is split over (only ``axes`` if given)."""
    n = 1
    for entry in spec:
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in names:
            if axes is None or a in axes:
                n *= mesh.shape[a]
    return n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _device_bytes(mesh, pairs) -> int:
    return sum(math.ceil(_nbytes(t) / _shards(mesh, s)) for t, s in pairs)


def _derived_collectives(cfg, shape, mesh, param_pairs) -> Dict[str, Any]:
    """Result bytes per device of the collectives GSPMD inserts around the
    step and the emulated mesh does not run: in a train step each
    gradient's reduction over the data axes (an all-reduce of a leaf the
    data axes do not split, a reduce-scatter of one they do), in the
    leaf's gradient dtype; and, for a leaf FSDP splits over the data
    axes, its weight all-gather before each use (one a forward, one more a
    backward, each microbatch)."""
    dp = dp_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    out = {k: {"count": 0, "bytes": 0.0}
           for k in ("all-reduce", "reduce-scatter", "all-gather")}
    if dp_size > 1:
        train = shape.kind == "train"
        nmb = cfg.num_microbatches if train else 1
        accum = getattr(torch, cfg.accum_dtype).itemsize
        gathers = 2 * nmb if train else 1
        for t, spec in param_pairs:
            local = t.numel() / _shards(mesh, spec)
            split = _shards(mesh, spec, dp)
            if train:
                item = accum if nmb > 1 else t.element_size()
                kind = "reduce-scatter" if split > 1 else "all-reduce"
                out[kind]["count"] += 1
                out[kind]["bytes"] += local * item
            if split > 1:
                out["all-gather"]["count"] += gathers
                out["all-gather"]["bytes"] += (gathers * local * split
                                               * t.element_size())
    out["total"] = {"count": sum(v["count"] for v in out.values()),
                    "bytes": sum(v["bytes"] for v in out.values())}
    return out


def _logits_spec(mesh, logits: torch.Tensor) -> P:
    """A prefill's logits: the batch over the data axes and the vocab over
    ``model`` where they divide (the head is vocab-sharded)."""
    batch = batch_pspecs({"logits": logits}, mesh)["logits"]
    vocab = "model" if logits.shape[-1] % mesh.shape["model"] == 0 else None
    return P(*batch[:-1], vocab)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def lower_cell(arch_name, shape: ShapeConfig, mesh):
    """Build the cell's meta parameters, optimizer state and batch, take
    their specs from the sharding rules, and run one step ``with mesh:``
    under the op counter.  ``arch_name`` is a registered name or a
    config.  Returns (counter, meta): ``meta`` holds the (tensor, spec)
    pairs of the parameters and of the step's arguments and outputs."""
    cfg = _config(arch_name)
    model = build_model(cfg)
    specs = model.input_specs(shape)
    params = model.param_specs()
    p_pairs = _pairs(params, param_pspecs(params, mesh, fsdp=cfg.fsdp))

    if shape.kind == "train":
        opts = TrainOptions()
        opt_state = init_train_state(model, params, opts)[0]
        o_pairs = _pairs(opt_state, opt_pspecs(
            opt_state, mesh, fsdp=cfg.fsdp or cfg.zero1))
        b_pairs = _pairs(specs, batch_pspecs(specs, mesh))
        step = make_train_step(model, opts)
        with mesh, count_ops(mesh) as counter:
            _, _, _, metrics = step(params, opt_state, None, specs)
        args = p_pairs + o_pairs + b_pairs
        outs = p_pairs + o_pairs + [(metrics["loss"], P())]
    elif shape.kind == "prefill":
        b_pairs = _pairs(specs, batch_pspecs(specs, mesh))
        step = make_prefill_step(model)
        with torch.no_grad(), mesh, count_ops(mesh) as counter:
            logits = step(params, specs)
        args = p_pairs + b_pairs
        outs = [(logits, _logits_spec(mesh, logits))]
    else:  # decode
        cache = specs["cache"]
        c_pairs = _pairs(cache, cache_pspecs(cache, mesh))
        tok_spec = batch_pspecs({"tokens": specs["tokens"]}, mesh)["tokens"]
        step = make_serve_step(model)
        with torch.no_grad(), mesh, count_ops(mesh) as counter:
            logits, _ = step(params, cache, specs["tokens"],
                             specs["cache_index"])
        args = p_pairs + c_pairs + [(specs["tokens"], tok_spec)]
        outs = [(logits, P())] + c_pairs
    return counter, {"params": p_pairs, "arguments": args, "outputs": outs}


def run_cell(arch, shape: ShapeConfig, mesh, mesh_name: str,
             out_dir: Path):
    """One cell's record, written to ``out_dir/mesh_name/`` (a record
    already there is read back, not redone).  ``arch`` is a registered
    name or a config (recorded under its name)."""
    cfg = _config(arch)
    arch_name = cfg.name
    out_path = out_dir / mesh_name / f"{arch_name}__{shape.name}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if out_path.exists():
        print(f"[skip-done] {arch_name} x {shape.name} ({mesh_name})")
        return json.loads(out_path.read_text())

    ok, reason = shape_applicable(cfg, shape)
    rec = {
        "arch": arch_name,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": mesh.size,
    }
    if not ok:
        rec.update({"status": "skipped", "reason": reason})
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[skip-n/a ] {arch_name} x {shape.name}: {reason}")
        return rec

    t0 = time.time()
    try:
        seam = seam_costs(cfg, shape)
        calls0 = mesh.shard_map_calls
        counter, meta = lower_cell(cfg, shape, mesh)
        costs = counter.costs()
        booked = parse_collectives(counter)
        derived = _derived_collectives(cfg, shape, mesh, meta["params"])
        counts = dict(costs.collective_counts)
        for kind, v in derived.items():
            if kind != "total" and v["count"]:
                counts[kind] = counts.get(kind, 0) + v["count"]
        counts["total"] = sum(v for k, v in counts.items() if k != "total")
        total = counter.total()
        rec.update(
            {
                "status": "ok",
                "compile_s": round(time.time() - t0, 1),
                # per-device totals (used for the roofline): the largest
                # body's ops plus the rest divided over the mesh
                "dot_flops_per_device": costs.dot_flops,
                "traffic_bytes_per_device": costs.traffic_bytes,
                # booked by the emulated mesh + derived from the specs
                "collective_bytes_per_device": costs.collective_bytes
                + derived["total"]["bytes"],
                "collective_bytes_per_device_booked": costs.collective_bytes,
                "collective_bytes_per_device_derived":
                    derived["total"]["bytes"],
                "collective_counts": counts,
                "collectives_raw": booked,
                "collectives_derived": derived,
                # the whole mesh's counted work (every body and the rest)
                "dot_flops_counted_global": total.dot_flops,
                "traffic_bytes_counted_global": total.traffic_bytes,
                "ops_counted": total.ops,
                "shard_map_calls": mesh.shard_map_calls - calls0,
                "memory_analysis": {
                    "argument_size_in_bytes":
                        _device_bytes(mesh, meta["arguments"]),
                    "output_size_in_bytes":
                        _device_bytes(mesh, meta["outputs"]),
                },
                "params": cfg.param_count(),
                "active_params": cfg.active_param_count(),
                "seam_flops_global": seam[0],
                "seam_bytes_global": seam[1],
                "tokens_per_step": shape.global_batch * shape.seq_len
                if shape.kind != "decode"
                else shape.global_batch,
            }
        )
        print(
            f"[ok {rec['compile_s']:7.1f}s] {arch_name} x {shape.name} "
            f"({mesh_name}) dotflops/dev={costs.dot_flops:.3e} "
            f"coll/dev={rec['collective_bytes_per_device']:.3e}B "
            f"args={rec['memory_analysis']['argument_size_in_bytes']/2**30:.1f}GiB"
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(
            {
                "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
                "compile_s": round(time.time() - t0, 1),
            }
        )
        print(f"[FAIL {rec['compile_s']:6.1f}s] {arch_name} x {shape.name}: "
              f"{rec['error'][:200]}")
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    names = ["pod16x16"]
    if args.both_meshes:
        names = ["pod16x16", "multipod2x16x16"]
    elif args.multi_pod:
        names = ["multipod2x16x16"]

    archs = [a for a in list_archs() if a != "paper-gemm"]
    if args.arch:
        archs = [args.arch]
    shapes = list(ALL_SHAPES)
    if args.shape:
        shapes = [s for s in ALL_SHAPES if s.name == args.shape]

    failures = 0
    for mesh_name in names:
        mesh = make_production_mesh(multi_pod=mesh_name != "pod16x16",
                                    device="meta")
        try:
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, mesh, mesh_name, out_dir)
                    failures += rec.get("status") == "error"
        finally:
            mesh.close()
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
