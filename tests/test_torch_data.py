"""The port's data pipeline (``repro_torch.data``, its own numpy copy of
the reference's): twins of ``tests/test_data.py`` and batches equal to the
reference's bit for bit."""

import numpy as np
import pytest
from hypothesis import given, settings
import hypothesis.strategies as st

from repro.data import MemmapTokens as JMemmap
from repro.data import SyntheticLM as JSynthetic
from repro.data import make_batches as jmake_batches
from repro_torch.data import MemmapTokens, SyntheticLM, make_batches


def test_deterministic_by_step():
    d = SyntheticLM(vocab_size=100, seq_len=8, global_batch=4, seed=3)
    a, b = d.batch(5), d.batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], d.batch(6)["tokens"])


def test_labels_are_shifted_tokens():
    d = SyntheticLM(vocab_size=50, seq_len=16, global_batch=2, seed=0)
    b = d.batch(0)
    assert b["tokens"].shape == b["labels"].shape == (2, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_hosts_get_different_data():
    kw = dict(vocab_size=100, seq_len=8, global_batch=8, seed=3, num_hosts=2)
    h0 = SyntheticLM(host_id=0, **kw).batch(0)
    h1 = SyntheticLM(host_id=1, **kw).batch(0)
    assert h0["tokens"].shape[0] == 4
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_uneven_host_split_raises():
    with pytest.raises(ValueError):
        SyntheticLM(vocab_size=10, seq_len=4, global_batch=5,
                    num_hosts=2).batch(0)


@given(step=st.integers(0, 1_000_000))
@settings(max_examples=20, deadline=None)
def test_tokens_in_vocab(step):
    d = SyntheticLM(vocab_size=37, seq_len=8, global_batch=2, seed=1)
    b = d.batch(step)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 37


def test_restart_purity_matches_iterator():
    d = SyntheticLM(vocab_size=64, seq_len=4, global_batch=2, seed=9)
    it = make_batches(d, start_step=0)
    seq = [next(it)["tokens"] for _ in range(6)]
    it2 = make_batches(d, start_step=3)
    for a, b in zip(seq[3:], [next(it2)["tokens"] for _ in range(3)]):
        np.testing.assert_array_equal(a, b)


def test_memmap_source(tmp_path):
    path = tmp_path / "toks.bin"
    (np.arange(10_000) % 91).astype(np.int32).tofile(path)
    d = MemmapTokens(str(path), vocab_size=91, seq_len=32, global_batch=4,
                     seed=0)
    b0, b0b = d.batch(0), d.batch(0)
    np.testing.assert_array_equal(b0["tokens"], b0b["tokens"])
    assert b0["tokens"].shape == (4, 32)
    assert b0["tokens"].max() < 91


def test_memmap_too_small(tmp_path):
    path = tmp_path / "tiny.bin"
    np.arange(4, dtype=np.int32).tofile(path)
    with pytest.raises(ValueError):
        MemmapTokens(str(path), vocab_size=10, seq_len=32, global_batch=1)


def test_zipf_skew():
    d = SyntheticLM(vocab_size=1000, seq_len=512, global_batch=8, seed=2)
    t = d.batch(0)["tokens"].ravel()
    assert (t < 10).mean() > 10 * (((t >= 500) & (t < 510)).mean() + 1e-9)


# ---------------------------------------------------------------------------
# bit for bit against the reference
# ---------------------------------------------------------------------------

def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [
    dict(vocab_size=64000, seq_len=512, global_batch=2, seed=17),
    dict(vocab_size=37, seq_len=8, global_batch=6, seed=1, zipf_a=1.5),
    dict(vocab_size=100, seq_len=16, global_batch=8, seed=3, num_hosts=2,
         host_id=1),
])
def test_synthetic_batches_equal_the_references(kw):
    for step in (0, 1, 7, 123_456):
        _equal(SyntheticLM(**kw).batch(step), JSynthetic(**kw).batch(step))


def test_memmap_batches_equal_the_references(tmp_path):
    path = tmp_path / "toks.bin"
    (np.arange(20_000) * 7919 % 50_021).astype(np.int32).tofile(path)
    kw = dict(vocab_size=1000, seq_len=64, global_batch=4, seed=5)
    for host in (0, 1):
        t = MemmapTokens(str(path), host_id=host, num_hosts=2, **kw)
        j = JMemmap(str(path), host_id=host, num_hosts=2, **kw)
        for step in (0, 3):
            _equal(t.batch(step), j.batch(step))


def test_iterators_equal_the_references():
    kw = dict(vocab_size=64, seq_len=4, global_batch=2, seed=9)
    t = make_batches(SyntheticLM(**kw), start_step=2)
    j = jmake_batches(JSynthetic(**kw), start_step=2)
    for _ in range(4):
        _equal(next(t), next(j))
