"""The port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py`` and not the tools that run on the card's machine
(``tools/flash_decode_times.py``, ``tools/ssd_times.py``,
``tools/paper_fig3_h100.py``) imports JAX or the JAX reference package, and
importing the port's modules loads neither (nor triton, which is imported
only inside the functions that launch a Triton kernel)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + [ROOT / "tools" / name for name in (
            "flash_decode_times.py", "ssd_times.py", "paper_fig3_h100.py")]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_reference(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_import_loads_no_jax_reference_or_triton():
    code = (
        "import sys, repro_torch, repro_torch.launch.serve, "
        "repro_torch.convert, repro_torch.kernels.ops, repro_torch.hnp, "
        "repro_torch.frontend, repro_torch.models.forward, "
        "repro_torch.kernels.flash_attention, repro_torch.runtime, "
        "repro_torch.launch.costing, repro_torch.obs.trace_export, "
        "repro_torch.configs.paper_gemm, repro_torch.models.moe, "
        "repro_torch.core.placement, repro_torch.configs.qwen3_moe_30b_a3b, "
        "repro_torch.configs.arctic_480b\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
