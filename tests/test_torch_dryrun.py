"""The dry run's twin (``repro_torch.launch.dryrun``, ``launch.info``,
``Model.param_specs`` / ``input_specs``) against the reference's.

The seam costs of every arch are equal to the reference's at a small shape
of each applicable kind and at yi-6b's four production shapes; the specs'
shapes and dtypes equal the reference's (``ShapeDtypeStruct`` trees; the
port's per-layer leaves mapped as in ``tests/test_torch_sharding.py``);
``info`` prints the reference's table; the mini cell of
``tests/test_sharding.py::test_mini_dryrun_subprocess`` runs on an
emulated (2, 4) mesh within that test's own bounds on the analytic
forward (the reference's subprocess twin fails, ROADMAP Queue 3, so the
port is held to the budget, not to it); skipped and failed cells are
recorded and the sweep goes on; the MoE books and the decode path run on
meta tensors.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_SHAPES as JALL_SHAPES
from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.configs import shape_applicable as jshape_applicable
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import info as jinfo
from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import ALL_SHAPES, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, info
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.sharding.spmd import Mesh

jax.devices()     # backends are up: the reference dry run's forcing of
_saved_flags = os.environ.get("XLA_FLAGS")    # 512 host devices below
from repro.launch import dryrun as jdryrun  # noqa: E402
if _saved_flags is None:                     # reaches no backend and no
    os.environ.pop("XLA_FLAGS", None)        # subprocess of this run
else:
    os.environ["XLA_FLAGS"] = _saved_flags

ARCHS = [a for a in jlist_archs() if a != "paper-gemm"]
KINDS = ("train", "prefill", "decode")


def _cells():
    for arch in ARCHS:
        for kind in KINDS:
            ok, _ = jshape_applicable(jget_arch(arch),
                                      JShapeConfig("t", 64, 2, kind))
            if ok:
                yield arch, kind


@pytest.mark.parametrize("arch,kind", list(_cells()))
def test_seam_costs_equal_the_references(arch, kind):
    """FLOPs and touched bytes from the seam, on meta tensors, equal the
    reference's from ``jax.eval_shape`` (qwen3-moe and arctic through the
    MoE books on meta; every decode through a host-side cache index)."""
    got = dryrun.seam_costs(arch, ShapeConfig("t", 64, 2, kind))
    want = jdryrun.seam_costs(arch, JShapeConfig("t", 64, 2, kind))
    assert got == want


@pytest.mark.parametrize("shape", [s.name for s in ALL_SHAPES])
def test_seam_costs_at_the_production_shapes(shape):
    (t_shape,) = [s for s in ALL_SHAPES if s.name == shape]
    (j_shape,) = [s for s in JALL_SHAPES if s.name == shape]
    assert dryrun.seam_costs("yi-6b", t_shape) == \
        jdryrun.seam_costs("yi-6b", j_shape)


def _ref_leaves(x):
    """{path: (shape, dtype name)} of a reference ShapeDtypeStruct tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(x)
    out = {}
    for path, leaf in flat:
        keys = [str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                for k in path]
        out["/".join(keys)] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _port_leaves(x):
    """{mapped path: [(index, shape, dtype name)]} of a port tree: the
    layer index after ``stack`` is dropped to name the reference's leaf."""
    out = {}
    for path, leaf in tree.leaves_with_paths(x):
        if not isinstance(leaf, torch.Tensor):
            continue
        parts = path.split("/")
        index = None
        for i in range(len(parts) - 1):
            if parts[i] == "stack" and parts[i + 1].isdigit():
                index = int(parts.pop(i + 1))
                break
        out.setdefault("/".join(parts), []).append(
            (index, tuple(leaf.shape), _dtype_name(leaf)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch):
    ref = _ref_leaves(jbuild(jget_arch(arch)).param_specs(
        jax.random.PRNGKey(0)))
    port = _port_leaves(build_model(get_arch(arch)).param_specs())
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))
    for path, variants in port.items():
        shape, dtype = ref[path]
        for index, p_shape, p_dtype in variants:
            want = shape[1:] if index is not None else shape
            assert (p_shape, p_dtype) == (want, dtype), path
        if variants[0][0] is not None:      # one leaf a layer
            assert len(variants) == shape[0], path
    assert all(leaf.device.type == "meta" for leaf in tree.leaves(
        build_model(get_arch(arch)).param_specs()))


@pytest.mark.parametrize("arch,kind", list(_cells()))
def test_input_specs_equal_the_references(arch, kind):
    shape = (8, 128)
    ref = _ref_leaves(jbuild(jget_arch(arch)).input_specs(
        JShapeConfig("t", shape[1], shape[0], kind)))
    got = build_model(get_arch(arch)).input_specs(
        ShapeConfig("t", shape[1], shape[0], kind))
    port = {path: (tuple(t.shape), _dtype_name(t))
            for path, t in tree.leaves_with_paths(got)}
    assert port == ref
    if kind == "decode":
        # read on the host by the decode path: a 0-d int32 CPU tensor
        assert got["cache_index"].device.type == "cpu"
        assert int(got["cache_index"]) == shape[1] - 1
        assert all(t.device.type == "meta"
                   for t in tree.leaves(got["cache"]))


def _printed(main):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([]) if main is info.main else main()
    return buf.getvalue().splitlines()


def test_info_table_equals_the_references(monkeypatch):
    monkeypatch.setattr("sys.argv", ["info"])
    got, want = _printed(info.main), _printed(jinfo.main)
    assert got == want and len(got) == 2 + len(ARCHS)
    assert info.arch_row("yi-6b") == jinfo.arch_row("yi-6b")


# ---------------------------------------------------------------------------
# cells on an emulated mesh
# ---------------------------------------------------------------------------

MINI = dataclasses.replace(
    get_arch("yi-6b").reduced(), num_layers=4, num_microbatches=2,
    d_model=128, d_ff=256, vocab_size=512, num_heads=4, num_kv_heads=2,
    head_dim=32)


def _mini_fwd():
    """``tests/test_sharding.py``'s analytic forward of the mini cell."""
    B, S, L, d, dff, hq, hkv, hd, V = 8, 64, 4, 128, 256, 4, 2, 32, 512
    T = B * S
    return (
        2 * T * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * dff) * L
        + 2 * T * d * V
        + 4 * B * hq * S * S * hd * L
    )


@pytest.fixture
def mesh24():
    mesh = Mesh((2, 4), ("data", "model"), device="meta")
    yield mesh
    mesh.close()


def test_mini_cell_within_the_analytic_budget(mesh24, tmp_path):
    """The reference test's bounds: 2·fwd < 8 · per-device dot FLOPs <
    8·fwd, collectives booked; the mesh counts every body, so the whole
    mesh's FLOPs equal the same step's with no mesh."""
    shape = ShapeConfig("mini", 64, 8, "train")
    rec = dryrun.run_cell(MINI, shape, mesh24, "mini2x4", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    fwd = _mini_fwd()
    assert 2.0 * fwd < rec["dot_flops_per_device"] * 8 < 8.0 * fwd
    assert rec["collective_bytes_per_device"] > 0
    assert rec["collective_bytes_per_device_booked"] > 0
    assert rec["shard_map_calls"] > 0
    assert rec["chips"] == 8 and rec["tokens_per_step"] == 8 * 64

    one = Mesh((1, 1), ("data", "model"), device="meta")
    unsharded = dryrun.run_cell(MINI, shape, one, "mini1x1", tmp_path)
    one.close()
    assert rec["dot_flops_counted_global"] >= \
        unsharded["dot_flops_counted_global"] > 2.0 * fwd
    # the record is written where the sweep reads it back
    assert json.loads((tmp_path / "mini2x4" / "yi-6b-smoke__mini.json")
                      .read_text()) == rec


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_mini_cell_serving_kinds(mesh24, tmp_path, kind):
    rec = dryrun.run_cell(MINI, ShapeConfig("mini", 64, 8, kind), mesh24,
                          "mini2x4", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["collective_bytes_per_device_derived"] == 0   # no gradients
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["dot_flops_counted_global"] == pytest.approx(
        rec["seam_flops_global"], rel=0.01)


def test_gradient_reduction_is_derived_from_the_specs(mesh24, tmp_path):
    """A train step's gradient all-reduce over ``data`` is not run by the
    emulated mesh: its bytes come from the specs, one f32 gradient a
    parameter leaf (two microbatches accumulate in f32) at its per-device
    size."""
    rec = dryrun.run_cell(MINI, ShapeConfig("mini", 64, 8, "train"), mesh24,
                          "mini2x4", tmp_path)
    counter, meta = dryrun.lower_cell(MINI, ShapeConfig("mini", 64, 8,
                                                        "train"), mesh24)
    want = sum(t.numel() * 4 / dryrun._shards(mesh24, s)
               for t, s in meta["params"])
    derived = rec["collectives_derived"]
    assert derived["all-reduce"]["bytes"] == want
    assert derived["all-reduce"]["count"] == len(meta["params"])
    assert derived["all-gather"]["count"] == 0          # no FSDP
    assert rec["collective_bytes_per_device"] == \
        rec["collective_bytes_per_device_booked"] + want


def test_skipped_and_error_records_keep_the_sweep_going(mesh24, tmp_path,
                                                        monkeypatch):
    """An inapplicable cell is ``skipped`` with the reference's reason; a
    cell that raises is recorded as ``error`` and the next cell runs."""
    (long,) = [s for s in ALL_SHAPES if s.name == "long_500k"]
    rec = dryrun.run_cell("yi-6b", long, mesh24, "mini2x4", tmp_path)
    assert rec == {"arch": "yi-6b", "shape": "long_500k", "mesh": "mini2x4",
                   "chips": 8, "status": "skipped",
                   "reason": jshape_applicable(jget_arch("yi-6b"),
                                               JALL_SHAPES[-1])[1]}

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "lower_cell", boom)
    bad = dryrun.run_cell(MINI, ShapeConfig("bad", 64, 8, "prefill"),
                          mesh24, "mini2x4", tmp_path)
    assert bad["status"] == "error" and bad["error"] == "RuntimeError: boom"
    assert "traceback" in bad and "compile_s" in bad
    monkeypatch.undo()
    ok = dryrun.run_cell(MINI, ShapeConfig("next", 64, 8, "prefill"),
                         mesh24, "mini2x4", tmp_path)
    assert ok["status"] == "ok"
    # a record already written is read back, not redone
    assert dryrun.run_cell(MINI, ShapeConfig("bad", 64, 8, "prefill"),
                           mesh24, "mini2x4", tmp_path) == bad


def test_cli_records_a_skipped_production_cell(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi-6b", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "pod16x16" / "yi-6b__long_500k.json")
                     .read_text())
    assert rec["status"] == "skipped" and rec["chips"] == 256
    assert "done; failures=0" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the meta repairs
# ---------------------------------------------------------------------------

def test_moe_books_skip_meta_and_keep_the_cpu_record():
    """A meta MoE forward books nothing (a meta tensor has no histogram);
    on the CPU the books stay as they are: one record a layer."""
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(),
                              num_layers=2)
    model = build_model(cfg)
    before = len(M.moe_step_trace())
    model.forward(model.param_specs(),
                  torch.zeros(2, 8, dtype=torch.int64, device="meta"))
    assert len(M.moe_step_trace()) == before
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    model.forward(params, torch.ones(2, 8, dtype=torch.int64))
    rec = M.last_moe_step()
    assert rec.tokens_routed == 2 * 8 * cfg.experts_per_token
    assert M._host_histogram(torch.zeros(4, 2, dtype=torch.int64,
                                         device="meta"), 4) is None


def test_decode_step_runs_on_meta_with_a_host_index():
    model = build_model(get_arch("yi-6b"))
    specs = model.input_specs(ShapeConfig("t", 64, 2, "decode"))
    logits, cache = model.decode_step(model.param_specs(), specs["cache"],
                                      specs["tokens"], specs["cache_index"])
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (2, get_arch("yi-6b").vocab_size)
