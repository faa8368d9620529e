"""A configuration family, or a kernel, joins the benchmark by new files
only: the CPU cut comes from each configuration file's ``cpu_cut``, a
family's layout (with the weight rules of its own leaves), work and
reference are modules found by its name, a family may count its own model
FLOPs, and a kernel named in a roofline's
file counts as the program's own in ``glue_share.prefill``."""

import json
import re
import shutil
import sys
import types

import pytest
import torch

from portbench import cells, faults, harness, metrics, trace, weights, work
from portbench.reference import dense_decoder

SEED = 2 ** 31 + 91

CPU_CUTS = {
    "yi-6b": {"hidden_size": 64, "head_dim": 16, "num_attention_heads": 4,
              "num_key_value_heads": 2, "num_hidden_layers": 4,
              "intermediate_size": 128, "vocab_size": 256},
    "mamba2-370m": {"d_model": 64, "n_layer": 4, "d_state": 16,
                    "headdim": 16, "chunk_size": 8, "vocab_size": 250},
}


@pytest.mark.parametrize("name", sorted(CPU_CUTS))
def test_cpu_cut_sets_the_files_keys_and_no_others(tiny_config, name):
    assert tiny_config(name) == dict(cells.load_config(name),
                                     **CPU_CUTS[name])


def _root(tmp_path, family="newfam", with_cut=True):
    """A checkout root whose BENCHMARK.json has one cell,
    ``<family>-6b.prefill-4k``, of yi-6b's configuration under the family
    ``family``; the metrics are the repository's."""
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    config = cells.load_config("yi-6b")
    config.update(name=f"{family}-6b", family=family)
    if not with_cut:
        del config["cpu_cut"]
    file = f"portbench/configs/{family}-6b.json"
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / file).write_text(json.dumps(config))
    bench["configs"] = [{"name": f"{family}-6b", "file": file}]
    bench["workloads"] = [{"name": f"{family}-6b.prefill-4k",
                           "config": f"{family}-6b", "traffic": "prefill-4k",
                           "chips": 1}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, f"{family}-6b.prefill-4k", tmp_path / file


def test_a_file_without_cpu_cut_fails_naming_the_file(tmp_path, tiny):
    root, workload, file = _root(tmp_path, with_cut=False)
    with pytest.raises(KeyError, match=re.escape(str(file))):
        tiny(workload, root)


@pytest.fixture
def newfam(monkeypatch):
    """The modules of a family ``newfam``, pointed at dense_decoder's
    functions: ``portbench.layout_newfam``, ``portbench.work_newfam`` (with
    a ``model_flops`` that notes its calls) and
    ``portbench.reference.newfam``."""
    calls = []

    def model_flops(config, batch, seq):
        calls.append((batch, seq))
        return sum(w["flops"] for w in work._dense_decoder(config, batch, seq))

    mods = {
        "portbench.layout_newfam": {"layout": weights._dense_decoder},
        "portbench.work_newfam": {"forward_work": work._dense_decoder,
                                  "model_flops": model_flops},
        "portbench.reference.newfam": {"forward": dense_decoder.forward},
    }
    for name, attrs in mods.items():
        mod = types.ModuleType(name)
        mod.__dict__.update(attrs)
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


def test_a_family_of_new_files_only_runs_correct(tmp_path, tiny, newfam):
    from repro_torch.models import build_model

    root, workload, _ = _root(tmp_path)
    cell = cells.load_cell(workload, root)
    assert cell.config["family"] == "newfam"
    assert cell.end_to_end and cell.per_layer

    small = tiny(workload, root)
    want = {p: (tuple(t.shape), t.dtype) for p, t in weights._leaves(
        build_model(cells.port_arch(small.config)).param_specs())}
    got = {p: (tuple(s.shape), s.dtype)
           for p, s in weights._leaves(weights.layout(small.config))}
    assert got == want

    out = harness.run(small, SEED, 0.05, True, device="cpu", t_start=0.0)
    assert out["correct"], out["checks"]
    assert "mfu.prefill" in out["metrics"]
    assert newfam and set(newfam) == {(2, 32)}
    out = harness.run(small, SEED, 0.05, False, device="cpu", t_start=0.0,
                      make_step=faults.control)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("own", [True, False])
def test_model_flops_are_the_familys_own_where_it_counts_them(
        monkeypatch, own):
    config = dict(cells.load_config("yi-6b"), family="newfam")
    mod = types.ModuleType("portbench.work_newfam")
    mod.forward_work = work._dense_decoder
    if own:
        mod.model_flops = lambda config, batch, seq: 7.0 * batch * seq
    monkeypatch.setitem(sys.modules, "portbench.work_newfam", mod)
    dense = work.model_flops(cells.load_config("yi-6b"), 4, 4096)
    assert work.model_flops(config, 4, 4096) == (7.0 * 4 * 4096 if own
                                                 else dense)


def test_a_family_brings_the_weight_rules_of_its_own_leaves(monkeypatch):
    """A leaf the base table has no rule for (an expert stack (E, d, f),
    whose fan-in is its middle axis) takes the rule of the family's layout
    module; without one, making the weights fails naming the leaf."""
    specs = {"moe": {"we_gate": weights.Spec((3, 16, 4), torch.float32)},
             "head": weights.Spec((16, 8), torch.float32)}
    config = {"family": "newfam"}
    mod = types.ModuleType("portbench.layout_newfam")
    monkeypatch.setitem(sys.modules, "portbench.layout_newfam", mod)
    with pytest.raises(KeyError, match="moe/we_gate"):
        weights.make_params(specs, 5, "cpu", weights.rules(config))
    mod.RULES = {"we_gate": ("normal", lambda t: t.mul_(t.shape[-2] ** -0.5))}
    got = weights.make_params(specs, 5, "cpu", weights.rules(config))
    assert got["moe"]["we_gate"].shape == (3, 16, 4)
    assert float(got["moe"]["we_gate"].std()) == pytest.approx(0.25, rel=0.3)
    assert weights.rules(cells.load_config("yi-6b")) is weights.RULES


# A traced forward (µs on the profiler's clock) holding each of today's
# kernels once, beside torch glue and, last, a kernel no file names yet.
HOST = [("make inputs", 0.0, 10.0), ("prefill step", 10.0, 990.0),
        ("synchronise", 990.0, 1000.0)]
TODAY = ["void wg::gemm_wgmma_128<1>", "gemm_tiled_kernel",
         "gemm_skinny_tc_mn", "gemm_tf32x3_kernel", "flash_attention_kernel",
         "fa::attn_wgmma<128>", "attn_tf32x3_kernel", "flash_decode_mma",
         "ssd_chunk_kernel", "ssd_mma_kernel"]
GLUE = [("elementwise_kernel<add>", 40.0), ("Memcpy DtoD", 20.0)]
NEW = ("grouped_expert_kernel<72>", 30.0)


def _trace():
    ops, t = [], 20.0
    for name, us in [(k, 10.0 * (i + 1)) for i, k in enumerate(TODAY)] \
            + GLUE + [NEW]:
        ops.append((name, t, t + us))
        t += us
    return types.SimpleNamespace(trace=trace.reduce_events(ops, HOST))


def test_glue_share_counts_todays_kernels_as_before():
    read = metrics.load("glue_share.prefill")
    own = 10.0 * sum(range(1, len(TODAY) + 1))
    total = own + 40.0 + 20.0 + NEW[1]
    assert read(_trace()) == pytest.approx(100 * (60.0 + NEW[1]) / total)
    # Every roofline's kernel is already in the reader's own list.
    listed = metrics.data("glue_share.prefill")["program_kernels"]
    for path in metrics.HERE.glob("*.json"):
        assert set(json.loads(path.read_text()).get("kernels", [])) \
            <= set(listed), path.name


def test_a_kernel_named_in_a_new_roofline_file_is_the_programs(
        tmp_path, monkeypatch):
    read = metrics.load("glue_share.prefill")
    for path in metrics.HERE.glob("*.json"):
        shutil.copy(path, tmp_path)
    (tmp_path / "moe_roofline.prefill.json").write_text(json.dumps(
        {"family": "moe", "kernels": ["grouped_expert_kernel"]}))
    monkeypatch.setattr(metrics, "HERE", tmp_path)
    own = 10.0 * sum(range(1, len(TODAY) + 1)) + NEW[1]
    assert read(_trace()) == pytest.approx(100 * 60.0 / (own + 60.0))
