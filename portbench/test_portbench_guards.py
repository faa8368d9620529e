"""The benchmark's guards: what its files import, what they read and
write, and that a run without a CUDA card (or without the program beside
it) fails instead of falling back to the CPU."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


def _runtime_files():
    return sorted(p for p in HERE.rglob("*.py")
                  if not p.name.startswith("test_") and p.name != "conftest.py")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _runtime_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_no_jax_and_reference_imports_no_program(path):
    roots = list(_imported_roots(path))
    bad = [(r, line) for r, line in roots if r in JAX_NAMES]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    if "reference" in path.relative_to(HERE).parts:
        program = [(r, line) for r, line in roots if r == "repro_torch"]
        assert not program, f"{path.relative_to(ROOT)} imports {program}"
        pieces = [node.module for node in ast.walk(ast.parse(path.read_text()))
                  if isinstance(node, ast.ImportFrom) and node.module
                  and node.module.startswith("portbench")]
        assert all(m.startswith("portbench.reference") for m in pieces), pieces


@pytest.mark.parametrize("path", _runtime_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reads_and_writes_only_its_checkout(path):
    """No file names the JAX package's benchmarks, a fixed path under
    /tmp, /dev/shm or the home directory."""
    text = path.read_text()
    for word in ("benchmarks", "/tmp", "/dev/shm", "expanduser"):
        assert word not in text, f"{path.relative_to(ROOT)} names {word!r}"


def _run(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "yi-6b.prefill-4k",
         "--seed", "3", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=env or dict(os.environ))


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return True
    return False


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = _run(ROOT, env=env)
    assert got.returncode != 0
    assert not _printed_result(got.stdout)
    assert "CUDA" in got.stderr


def test_run_beside_no_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(tmp_path)
    assert got.returncode != 0
    assert not _printed_result(got.stdout)


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card(card):
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "yi-6b.prefill-4k", "--seed", "5", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert got.returncode == 0, got.stderr[-2000:]
    out = json.loads(got.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
