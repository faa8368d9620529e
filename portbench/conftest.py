"""Test settings of the benchmark's own tests: the ``gpu`` marker (a test
that needs a CUDA card; it decides inside a fixture and skips without one)
and the tiny cells the CPU tests run."""

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
    from portbench.cells import load_config

    return lambda name: cut(load_config(name))


def cut(config):
    """A configuration cut to a CPU test's size (4 layers, narrow widths)."""
    cfg = copy.deepcopy(config)
    if cfg["family"] == "dense_decoder":
        cfg.update(hidden_size=64, head_dim=16, num_attention_heads=4,
                   num_key_value_heads=2, num_hidden_layers=4,
                   intermediate_size=128, vocab_size=256)
    else:
        cfg.update(d_model=64, n_layer=4, d_state=16, headdim=16,
                   chunk_size=8, vocab_size=250)
    return cfg


def tiny_cell(workload: str):
    """The cell with its configuration cut (:func:`cut`) and a short
    window's shapes; its limits are the cell's."""
    from portbench.cells import load_cell

    cell = load_cell(workload)
    traffic = dict(cell.traffic, batch=2, seq_len=32, warmup_forwards=1)
    return dataclasses.replace(cell, config=cut(cell.config), traffic=traffic)
