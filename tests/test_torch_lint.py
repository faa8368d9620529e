"""The port's lint twin (``repro_torch.analysis.lint``,
``tools/repro_torch_lint.py``): the tree lints clean; each port rule fires
with its name on a seeded offending file and passes its exempt form; the
repo-level registry closure catches a missing ``KERNEL_LOWERINGS`` row, a
reference table row the port lacks and a registry that differs from the
reference's.  (``tests/test_lint.py::test_probe_rule_tracks_jax_aliases``
has no twin: its generator is at fault, ROADMAP Queue 3.)"""

import subprocess
import sys

import pytest

from repro_torch.analysis.lint import (
    RULES,
    check_registry_closure,
    lint_file,
    repo_root,
    run_lint,
)

ROOT = repo_root()
M = "src/repro_torch"


def rules_of(violations):
    return {v.rule for v in violations}


def _write(root, rel, source):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(source)
    return p


# ---------------------------------------------------------------------------
# the clean tree
# ---------------------------------------------------------------------------

def test_clean_tree_lints_clean():
    violations = run_lint(ROOT)
    assert violations == [], "\n".join(v.render() for v in violations)


def test_registry_closure_clean_on_tree():
    assert check_registry_closure(ROOT) == []


def test_rule_table_names_are_unique_and_scoped():
    names = [r.name for r in RULES]
    assert len(names) == len(set(names))
    for r in RULES:
        assert r.paths and r.description
        assert all(p.startswith(M + "/") for p in r.paths)


@pytest.mark.parametrize("args,says", [
    ([], "clean"),
    (["--smoke-races"], "expert placement clean"),
])
def test_cli_exits_zero_on_clean_tree(args, says, tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "repro_torch_lint.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert says in proc.stdout


# ---------------------------------------------------------------------------
# seeded offenders -> named rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line", [
    "    return x @ w",
    "    return torch.matmul(x, w)",
    "    return torch.mm(x, w)",
    "    return torch.bmm(x, w)",
    "    x @= w",
])
def test_raw_matmul_under_models_is_flagged(tmp_path, line):
    p = _write(tmp_path, f"{M}/models/bad.py",
               f"import torch\ndef f(x, w):\n{line}\n")
    v = lint_file(p, tmp_path)
    assert rules_of(v) == {"models-no-raw-matmul"}
    assert f"{M}/models/bad.py:3" in v[0].where


def test_raw_matmul_exempt_forms(tmp_path):
    """blas calls, einsum, and a raw GEMM outside models/ pass."""
    p = _write(tmp_path, f"{M}/models/ok.py",
               "import torch\nfrom repro_torch.core import blas\n"
               "def f(x, w):\n"
               "    return blas.matmul(x, w) + torch.einsum('ij,jk->ik', x, w)\n")
    assert lint_file(p, tmp_path) == []
    p2 = _write(tmp_path, f"{M}/kernels/ok.py",
                "import torch\ndef f(x, w):\n    return torch.matmul(x, w)\n")
    assert lint_file(p2, tmp_path) == []


def test_bare_engine_launch_under_models_is_flagged(tmp_path):
    p = _write(tmp_path, f"{M}/models/bad.py",
               "from repro_torch.core.hero import engine\n"
               "def f(cost):\n"
               "    return engine().launch(cost)\n")
    assert rules_of(lint_file(p, tmp_path)) == {"models-no-bare-launch"}
    p2 = _write(tmp_path, f"{M}/core/ok.py",
                "from repro_torch.core.hero import engine\n"
                "def f(cost):\n"
                "    return engine().launch(cost)\n")
    assert lint_file(p2, tmp_path) == []


@pytest.mark.parametrize("source", [
    "import triton\n",
    "import triton.language as tl\n",
    "from triton import language as tl\n",
    "import ctypes\nLIB = ctypes.CDLL('libgemm.so')\n",
    "import ctypes\nLIB = ctypes.cdll.LoadLibrary('libgemm.so')\n",
    "import torch\ntorch.ops.load_library('ops.so')\n",
    "from repro_torch.kernels import _build\nLIB = _build.library('gemm')\n",
    "from repro_torch.kernels import _build\n"
    "def f(lib=_build.library('gemm')):\n    return lib\n",
    "from repro_torch.kernels import _build\n"
    "class K:\n    LIBS = _build.build_all(['gemm'])\n",
])
def test_module_scope_kernel_load_is_flagged(tmp_path, source):
    p = _write(tmp_path, f"{M}/kernels/bad.py", source)
    assert rules_of(lint_file(p, tmp_path)) == {"kernel-load-in-launchers"}


def test_kernel_load_inside_the_launcher_is_exempt(tmp_path):
    p = _write(tmp_path, f"{M}/kernels/ok.py",
               "import ctypes\n"
               "from typing import TYPE_CHECKING\n"
               "from repro_torch.kernels import _build\n"
               "if TYPE_CHECKING:\n"
               "    import triton\n"
               "def launch(x):\n"
               "    import triton\n"
               "    lib = _build.library('gemm')\n"
               "    return lib.gemm(ctypes.c_int(0))\n"
               "RUN = lambda: _build.library('gemm')\n")
    assert lint_file(p, tmp_path) == []


@pytest.mark.parametrize("sub", ["frontend", "analysis"])
@pytest.mark.parametrize("source", [
    "import repro_torch.core.blas\n",
    "from repro_torch.core.hero import engine\n",
    "from repro_torch import core\n",
    "from repro_torch.kernels.gemm import gemm\n",
    "from repro_torch.models import build_model\n",
    "try:\n    from repro_torch.launch import serve\nexcept ImportError:\n"
    "    serve = None\n",
])
def test_module_scope_engine_import_is_flagged(tmp_path, sub, source):
    p = _write(tmp_path, f"{M}/{sub}/bad.py", source)
    assert rules_of(lint_file(p, tmp_path)) == {"frontend-import-light"}


def test_function_scope_and_light_imports_are_exempt(tmp_path):
    p = _write(tmp_path, f"{M}/frontend/ok.py",
               "from typing import TYPE_CHECKING\n"
               "import torch\n"
               "from repro_torch.obs import spans\n"
               "from repro_torch.analysis.base import Violation\n"
               "if TYPE_CHECKING:\n"
               "    from repro_torch.core.hero import engine\n"
               "def f():\n"
               "    from repro_torch.core.hero import engine\n"
               "    return engine\n")
    assert lint_file(p, tmp_path) == []
    p2 = _write(tmp_path, f"{M}/launch/ok.py",
                "from repro_torch.core.hero import engine\n")
    assert lint_file(p2, tmp_path) == []


def test_trace_record_without_device_id_is_flagged(tmp_path):
    p = _write(tmp_path, f"{M}/core/rec.py",
               "from repro_torch.core.accounting import OffloadRecord\n"
               "def f(**kw):\n"
               "    return OffloadRecord(op='gemm', **kw)\n")
    assert lint_file(p, tmp_path) == []        # **kwargs may carry it
    p2 = _write(tmp_path, f"{M}/core/rec2.py",
                "from repro_torch.core.hero import LaunchTicket\n"
                "def f():\n"
                "    return LaunchTicket(op='gemm')\n")
    assert rules_of(lint_file(p2, tmp_path)) == {"trace-record-device-id"}


def test_wallclock_in_streaming_is_flagged(tmp_path):
    p = _write(tmp_path, f"{M}/launch/streaming.py",
               "import time\n"
               "def drive():\n"
               "    return time.time()\n")
    v = lint_file(p, tmp_path)
    assert rules_of(v) == {"serve-no-wallclock"}
    assert len(v) == 2          # the import and the clock read
    p2 = _write(tmp_path, f"{M}/launch/costing.py",
                "from time import perf_counter\n"
                "def cost():\n"
                "    return perf_counter()\n")
    v2 = lint_file(p2, tmp_path)
    assert rules_of(v2) == {"serve-no-wallclock"} and len(v2) == 2


def test_wallclock_rule_catches_aliases_and_datetime(tmp_path):
    p = _write(tmp_path, f"{M}/obs/spans.py",
               "import time as _t\n"
               "from datetime import datetime\n"
               "def f():\n"
               "    return _t.perf_counter(), datetime.now()\n")
    v = lint_file(p, tmp_path)
    assert rules_of(v) == {"obs-modeled-time-only"}
    msgs = "\n".join(x.render() for x in v)
    assert "perf_counter" in msgs and "datetime.now" in msgs


def test_wallclock_rule_scoped_to_its_paths(tmp_path):
    # serve.py's wall-clock reads time real kernel runs — out of scope
    p = _write(tmp_path, f"{M}/launch/serve.py",
               "import time\nT0 = time.time()\n")
    assert lint_file(p, tmp_path) == []


def test_parse_error_is_reported_not_raised(tmp_path):
    p = _write(tmp_path, f"{M}/models/broken.py", "def f(:\n")
    assert rules_of(lint_file(p, tmp_path)) == {"parse-error"}


# ---------------------------------------------------------------------------
# registry closure on a seeded broken tree
# ---------------------------------------------------------------------------

_BLAS = """
def register(op): pass
class OffloadOp: pass
def _lowering(name): pass
register(OffloadOp(name="gemm"))
register(OffloadOp(name="ghost_op"))
_lowering("gemm")
_lowering("missing_row")
"""

_OPS = """
KERNEL_LOWERINGS = {"gemm": None}
"""

_REF_BLAS = """
register(OffloadOp(name="gemm"))
register(OffloadOp(name="ref_only_op"))
"""

_REF_OPS = """
PALLAS_LOWERINGS = {"gemm": None, "ssd_chunk_diag": None}
"""


def _seed(root):
    _write(root, f"{M}/core/blas.py", _BLAS)
    _write(root, f"{M}/kernels/ops.py", _OPS)
    _write(root, "src/repro/core/blas.py", _REF_BLAS)
    _write(root, "src/repro/kernels/ops.py", _REF_OPS)


def test_registry_closure_catches_every_break(tmp_path):
    _seed(tmp_path)
    v = check_registry_closure(tmp_path)
    msgs = "\n".join(x.render() for x in v)
    assert rules_of(v) == {"registry-closure"} and len(v) == 4
    assert "missing_row" in msgs       # a fetch with no table row
    assert "ssd_chunk_diag" in msgs    # a reference row the port lacks
    assert "ghost_op" in msgs          # registered, not in the reference
    assert "ref_only_op" in msgs       # in the reference, not registered


def test_registry_closure_names_a_missing_home(tmp_path):
    _write(tmp_path, f"{M}/core/blas.py", _BLAS)
    v = check_registry_closure(tmp_path)
    assert rules_of(v) == {"registry-closure"}
    assert "cannot check" in v[0].message


def test_run_lint_includes_repo_rules_on_seeded_tree(tmp_path):
    _seed(tmp_path)
    _write(tmp_path, f"{M}/models/bad.py",
           "def f(a, b):\n    return a @ b\n")
    v = run_lint(tmp_path)
    assert {"models-no-raw-matmul", "registry-closure"} <= rules_of(v)
