"""The port's checkpointer (``repro_torch.checkpoint``) against the
reference's design and files: twins of ``tests/test_checkpoint.py`` (its
``shardings`` test becomes ``restore(..., device=)``), bf16 leaves as
uint16 bits, and manifests equal to the reference's for the same values."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as jsave_pytree
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer, restore_pytree, save_pytree


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=gen),
                   "b": torch.zeros(4)},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [torch.arange(3), {"x": torch.tensor(2.5)}],
    }


def _assert_tree_equal(a, b):
    fa, fb = tree.leaves(a), tree.leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "c")
    _assert_tree_equal(t, restore_pytree(t, tmp_path / "c"))


def test_checkpointer_latest_and_resume(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (10, 20, 30):
        ck.save(s, _tree(s))
    assert ck.latest_step() == 30
    got, step = ck.restore(_tree())
    assert step == 30
    _assert_tree_equal(got, _tree(30))


def test_keep_k_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in range(1, 6):
        ck.save(s, _tree(s))
    assert ck.steps() == [4, 5]


def test_no_tmp_dirs_visible(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    ck.save(1, _tree())
    assert all(not p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_corruption_detected(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "c")
    f = next((tmp_path / "c").glob("params__w.npy"))
    raw = bytearray(f.read_bytes())
    raw[-4] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum|corrupt"):
        restore_pytree(t, tmp_path / "c")


def test_structure_mismatch_detected(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "c")
    t2 = dict(t)
    t2["extra"] = torch.zeros(2)
    with pytest.raises(KeyError):
        restore_pytree(t2, tmp_path / "c")


def test_async_save_durable_and_ordered(tmp_path):
    ck = Checkpointer(tmp_path, keep=5)
    for s in (1, 2, 3):
        ck.save_async(s, _tree(s))
    ck.wait()
    assert ck.steps() == [1, 2, 3]
    got, step = ck.restore(_tree())
    assert step == 3
    _assert_tree_equal(got, _tree(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_async_save_snapshot_isolated_from_mutation(tmp_path, dtype):
    """The async writer snapshots at call time: an in-place update of the
    live tensors right after ``save_async`` returns (as an optimizer that
    updates in place would make) cannot reach the checkpoint."""
    ck = Checkpointer(tmp_path, keep=2)
    w = torch.ones(64, dtype=dtype)
    ck.save_async(1, {"w": w})
    w.mul_(0.0)
    ck.wait()
    got = ck.restore({"w": w})[0]
    assert torch.equal(got["w"], torch.ones(64, dtype=dtype))


def test_async_save_snapshot_of_numpy_leaves(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    arr = np.ones((64,), np.float32)
    ck.save_async(1, {"w": arr})
    arr *= 0.0
    ck.wait()
    got = ck.restore({"w": arr})[0]
    np.testing.assert_array_equal(got["w"].numpy(), np.ones(64, np.float32))


def test_restore_onto_a_device(tmp_path):
    """The elastic path's ``shardings=`` becomes ``device=``: every leaf
    lands there; without it each leaf lands on its template leaf's
    device."""
    t = {"w": torch.arange(16.0).reshape(4, 4), "n": np.arange(3)}
    save_pytree(t, tmp_path / "c")
    got = restore_pytree(t, tmp_path / "c", device="meta")
    assert {x.device.type for x in tree.leaves(got)} == {"meta"}
    assert got["w"].shape == (4, 4)
    got = restore_pytree(t, tmp_path / "c")
    assert got["w"].device.type == "cpu" and torch.equal(got["w"], t["w"])
    assert torch.equal(got["n"], torch.arange(3))


# ---------------------------------------------------------------------------
# bf16 and the reference's files
# ---------------------------------------------------------------------------

def test_bf16_roundtrip_as_uint16_bits(tmp_path):
    w = torch.randn(5, 7).bfloat16()
    t = {"w": w, "s": torch.tensor(1.5, dtype=torch.bfloat16)}
    man = save_pytree(t, tmp_path / "c")
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    raw = np.load(tmp_path / "c" / "w.npy")
    assert raw.dtype == np.uint16           # no ml_dtypes needed to read it
    np.testing.assert_array_equal(raw, w.view(torch.int16).numpy().view(
        np.uint16))
    got = restore_pytree(t, tmp_path / "c")
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)
    assert torch.equal(got["s"], t["s"])


def test_manifest_matches_the_references(tmp_path):
    """The same values saved by both packages: the same leaf keys, shapes,
    dtype names and crc32s (bf16 included: the uint16 bits are the
    reference's bytes)."""
    rng = np.random.default_rng(0)
    vals = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [np.arange(5, dtype=np.int32),
                  {"c": rng.standard_normal(6).astype(np.float32)}]}
    jt = jax.tree.map(jnp.asarray, vals)
    jt["h"] = jnp.asarray(vals["a"], jnp.bfloat16)
    tt = tree.tree_map(lambda a: torch.from_numpy(np.array(a)), vals)
    tt["h"] = torch.from_numpy(vals["a"]).bfloat16()
    jman = jsave_pytree(jt, tmp_path / "j")
    tman = save_pytree(tt, tmp_path / "t")
    assert tman == jman
    assert json.loads((tmp_path / "t" / "manifest.json").read_text()) == \
        json.loads((tmp_path / "j" / "manifest.json").read_text())


def test_train_state_roundtrip(tmp_path):
    """(params, OptState) of a reduced model, bf16 params, restored bit for
    bit with the step counter on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import TrainOptions, init_train_state
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), dtype="bfloat16")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    opt_state, _ = init_train_state(model, params, TrainOptions())
    ck = Checkpointer(tmp_path)
    ck.save_async(3, (params, opt_state))
    ck.wait()
    (p2, o2), step = ck.restore((params, opt_state))
    assert step == 3
    _assert_tree_equal((params, opt_state), (p2, o2))
    assert o2.step.device.type == "cpu"
