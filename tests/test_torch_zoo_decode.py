"""Decode steps of the zoo's uniform decoders on the port against the
reference's ``decode_step``: gemma3-27b (5:1 local:global windows),
h2o-danube-1.8b (sliding window, rolling cache past its wrap), qwen2-72b
(qkv bias) and qwen2-vl-72b (M-RoPE, decoding embeddings).  Reduced
configs in f32; helpers, weights and tolerances are
``tests/test_torch_zoo.py``'s (jamba's hybrid decode is in
``tests/test_torch_hybrid.py``)."""

import numpy as np
import pytest

from test_torch_zoo import LOGIT_TOL, _decode_both, _totals

UNIFORM_DECODERS = ["gemma3-27b", "h2o-danube-1.8b", "qwen2-72b",
                    "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", UNIFORM_DECODERS)
def test_decode_steps_match_reference(arch):
    """12 steps of 8 rows: past gemma3's reduced local window (8), past the
    wrap of danube's 8-slot rolling buffer; qwen2-vl decodes embeddings on
    (3, B, 1) positions.  Logits within 1e-4 of max |logit| at every step,
    count-weighted records equal."""
    jl, tl, jt, tt = _decode_both(arch, 12)
    assert tl.shape == jl.shape == (12, 8, 256)
    assert np.abs(tl - jl).max() <= LOGIT_TOL * np.abs(jl).max()
    ttot = _totals(tt.records)
    assert ttot == _totals(jt.records)
    assert ("attention", "device-kernel") in ttot
