"""The port's ranges on the profiler's clock (``repro_torch.obs.spans.measured``).

A tiny yi-6b-shaped prefill step on the CPU under ``torch.profiler`` opens
its ranges nested as the layers nest: ``step:prefill`` › ``layer:attn`` ›
``glue:rope``, and ``dispatch:<op>`` › ``lower:<host|kernel>``.  With the
profiler off, ``measured`` formats no name, enters no ``record_function``
and returns one shared null context; the logits are the same bits either
way; and ``repro_torch.obs`` still imports without torch.
"""

import contextlib
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.core.hero import offload_policy
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import build_model
from repro_torch.obs import spans

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYERS = 2


@pytest.fixture(scope="module")
def tiny():
    """(step, params, tokens) of a 2-layer yi-6b at narrow widths."""
    cfg = dataclasses.replace(
        get_arch("yi-6b"), d_model=64, num_layers=LAYERS, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = torch.randint(0, 256, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    return make_prefill_step(model), params, tokens


def _run(tiny, *, use_kernels=False):
    step, params, tokens = tiny
    with offload_policy(mode="device", use_kernels=use_kernels), \
            torch.no_grad():
        return step(params, tokens)


def _ranges(prof):
    """The program's ranges of a finished profile: (name, start, end)."""
    results = prof.profiler.kineto_results
    prefixes = tuple(f"{k}:" for k in
                     ("step", "layer", "glue", "dispatch", "lower", "kernel"))
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in results.events() if e.name().startswith(prefixes)]


def _parent(ranges, child):
    """The innermost range that holds ``child`` (None at the top)."""
    _, s, e = child
    holders = [r for r in ranges if r is not child and r[1] <= s
               and e <= r[2] and (r[1], -r[2]) < (s, -e)]
    return max(holders, key=lambda r: (r[1], -r[2]), default=None)


def _traced(tiny, **kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits = _run(tiny, **kw)
    return logits, _ranges(prof)


def test_ranges_nest_as_the_layers_do(tiny):
    _, ranges = _traced(tiny)
    names = [r[0] for r in ranges]
    assert names.count("step:prefill") == 1
    assert names.count("layer:attn") == LAYERS
    assert names.count("glue:rope") == LAYERS
    dispatches = [r for r in ranges if r[0].startswith("dispatch:")]
    lowers = [r for r in ranges if r[0].startswith("lower:")]
    assert len(dispatches) == len(lowers) > 0
    for r in ranges:
        parent = _parent(ranges, r)
        if r[0] == "step:prefill":
            assert parent is None
        elif r[0] == "layer:attn":
            assert parent[0] == "step:prefill"
        elif r[0] == "glue:rope":
            assert parent[0] == "layer:attn"
        elif r[0].startswith("lower:"):
            assert parent[0].startswith("dispatch:")
    qkv = [r for r in ranges if r[0] == "dispatch:qkv_project"]
    assert len(qkv) == LAYERS
    for r in qkv:
        assert _parent(ranges, r)[0] == "layer:attn"
        inner = [c for c in ranges if _parent(ranges, c) == r]
        assert [c[0] for c in inner] == ["lower:host"]


def test_kernel_lowerings_open_lower_kernel(tiny):
    # On the CPU a kernel lowering runs the kernels' plain versions: the
    # seam opens lower:kernel, and no wrapper reaches a launch.
    _, ranges = _traced(tiny, use_kernels=True)
    names = {r[0] for r in ranges}
    assert "lower:kernel" in names
    assert not any(n.startswith("kernel:") for n in names)


def test_logits_bitwise_equal_with_the_profiler_on_and_off(tiny):
    off = _run(tiny)
    on, ranges = _traced(tiny)
    assert ranges and torch.equal(on, off)


class _Unformattable:
    def __format__(self, spec):
        raise AssertionError("a range name was formatted")

    def __str__(self):
        raise AssertionError("a range name was formatted")


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with the profiler off")


def test_profiler_off_enters_no_record_function(tiny, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert not torch._C._autograd._profiler_enabled()
    null = spans.measured("kernel", _Unformattable(), _Unformattable())
    assert null is spans.measured("glue", "rope")
    assert isinstance(null, contextlib.nullcontext)
    with null:
        pass
    _run(tiny)


def test_profiler_on_opens_named_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.measured("glue", "rope"):
            with spans.measured("kernel", "gemm", "wgmma"):
                torch.zeros(1)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"glue:rope", "kernel:gemm.wgmma"} <= names


def test_obs_imports_no_torch():
    code = ("import sys, repro_torch.obs, repro_torch.obs.spans\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
