"""Test settings of the benchmark's own tests: the ``gpu`` marker (a test
that needs a CUDA card; it decides inside a fixture and skips without one)
and the tiny cells the CPU tests run, each cut by the ``cpu_cut`` of its
configuration file."""

import copy
import dataclasses

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (decided inside a fixture)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda:0")


@pytest.fixture
def tiny():
    """``tiny(workload)``: see :func:`tiny_cell`."""
    return tiny_cell


@pytest.fixture
def tiny_config():
    """``tiny_config(name)``: see :func:`cut`."""
    from portbench.cells import HERE, load_config

    return lambda name: cut(load_config(name),
                            HERE / "configs" / f"{name}.json")


def cut(config, file):
    """A configuration cut to a CPU test's size: a copy with the keys of
    its ``cpu_cut`` set.  ``file`` is the configuration's file, named in
    the error where it has no ``cpu_cut``."""
    if "cpu_cut" not in config:
        raise KeyError(f"{file}: no 'cpu_cut' object (the keys a CPU test "
                       f"overrides to cut this configuration to size)")
    cfg = copy.deepcopy(config)
    cfg.update(cfg["cpu_cut"])
    return cfg


def tiny_cell(workload: str, root=None):
    """The cell with its configuration cut (:func:`cut`) and a short
    window's shapes; its limits are the cell's.  ``root`` holds the
    ``BENCHMARK.json`` that names the cell (default: the repository's)."""
    from portbench.cells import ROOT, load_cell

    cell = load_cell(workload, root or ROOT)
    traffic = dict(cell.traffic, batch=2, seq_len=32, warmup_forwards=1)
    return dataclasses.replace(cell, config=cut(cell.config, cell.config_file),
                               traffic=traffic)
