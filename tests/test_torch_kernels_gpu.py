"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (``gpu`` marker) and skips without one.
The file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Tolerances are
``tests/test_kernels.py``'s, f32 2e-5 and bf16 2e-2, of max |plain|
(for attention, of each output row's max |plain|).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.gemm import gemm, gemm_batched
from repro_torch.kernels.ref import (attention_ref, decode_attention_ref,
                                     gemm_batched_ref, gemm_ref)

pytestmark = pytest.mark.gpu

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (200, 130, 96), (8, 8, 8),
               (1, 256, 64), (8, 5120, 4096), (8, 4096, 11008)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _row_err(got, want):
    """Max over rows (last axis) of the error scaled by that row's max
    |want|; rows that are all 0 are left to the masked-row checks."""
    got, want = got.float(), want.float()
    scale = want.abs().amax(dim=-1)
    live = scale > 0
    return ((got - want).abs().amax(dim=-1)[live] / scale[live]).max().item()


@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_kernel(card, m, n, k, dtype):
    dt = getattr(torch, dtype)
    a = torch.randn(m, k, generator=card, device="cuda").to(dt)
    b = torch.randn(k, n, generator=card, device="cuda").to(dt)
    before = gemm.launches
    got = gemm(a, b)
    torch.cuda.synchronize()
    assert gemm.launches == before + 1 and got.dtype == dt
    assert _err(got, gemm_ref(a, b)) <= TOL[dtype]


def test_gemm_kernel_transposed_operands(card):
    a = torch.randn(48, 40, generator=card, device="cuda")
    b = torch.randn(24, 48, generator=card, device="cuda")
    got = gemm(a.T, b.T)            # strided views, read in place
    torch.cuda.synchronize()
    assert _err(got, gemm_ref(a.T, b.T)) <= TOL["float32"]


@pytest.mark.parametrize("bsz", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_batched_kernel(card, bsz, dtype):
    """tests/test_kernels.py::test_gemm_batched's shapes, one launch."""
    dt = getattr(torch, dtype)
    a = torch.randn(bsz, 96, 64, generator=card, device="cuda").to(dt)
    b = torch.randn(bsz, 64, 80, generator=card, device="cuda").to(dt)
    before = (gemm.launches, gemm_batched.launches)
    got = gemm_batched(a, b)
    torch.cuda.synchronize()
    assert (gemm.launches, gemm_batched.launches) == (before[0], before[1] + 1)
    assert got.shape == (bsz, 96, 80) and got.dtype == dt
    assert _err(got, gemm_batched_ref(a, b)) <= TOL[dtype]


# tests/test_kernels.py::test_flash_attention_variants (D 32), then the
# head dims of h2o-danube / hubert (80) and yi-6b (128).
ATTN_CASES = [
    dict(sq=128, skv=128, hq=4, hkv=4, causal=True, d=32),
    dict(sq=128, skv=128, hq=8, hkv=2, causal=True, d=32),
    dict(sq=96, skv=96, hq=4, hkv=2, causal=True, window=32, d=32),
    dict(sq=64, skv=64, hq=4, hkv=4, causal=False, d=32),
    dict(sq=16, skv=128, hq=4, hkv=2, causal=True, d=32),
    dict(sq=100, skv=100, hq=4, hkv=2, causal=True, d=32),
    dict(sq=77, skv=130, hq=8, hkv=2, causal=True, window=20, d=80),
    dict(sq=200, skv=200, hq=8, hkv=1, causal=True, d=128),
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel(card, case, dtype):
    dt = getattr(torch, dtype)
    d = case["d"]
    q = torch.randn(2, case["hq"], case["sq"], d, generator=card,
                    device="cuda").to(dt)
    k = torch.randn(2, case["hkv"], case["skv"], d, generator=card,
                    device="cuda").to(dt)
    v = torch.randn(2, case["hkv"], case["skv"], d, generator=card,
                    device="cuda").to(dt)
    kw = dict(causal=case["causal"], window=case.get("window"))
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.dtype == dt
    assert _row_err(got, attention_ref(q, k, v, **kw)) <= TOL[dtype]


def test_flash_attention_kernel_strided_and_masked_rows(card):
    """q/k/v as (B, S, H, D) transposed views are read in place; rows that
    a window leaves no key (bidirectional, window -5: the last six queries)
    output exactly 0, and causal with window 0 masks every row."""
    b, s, hq, hkv, d = 2, 70, 4, 2, 16
    q = torch.randn(b, s, hq, d, generator=card, device="cuda").transpose(1, 2)
    k = torch.randn(b, s, hkv, d, generator=card, device="cuda").transpose(1, 2)
    v = torch.randn(b, s, hkv, d, generator=card, device="cuda").transpose(1, 2)
    for kw in (dict(causal=True, window=3), dict(causal=False, window=-5),
               dict(causal=True, window=0)):
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = attention_ref(q, k, v, **kw)
        if want.abs().max().item() > 0:
            assert _row_err(got, want) <= TOL["float32"], kw
        dead = want.abs().amax(dim=-1) == 0
        assert dead.any() == (kw["window"] <= 0), kw
        assert got[dead].abs().max().item() == 0.0 if dead.any() else True


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel(card, dtype):
    bounds = [(0, 300), (5, 40), (10, 33), (0, 1), (299, 300), (100, 100),
              (37, 250), (0, 150)]
    b, hq, hkv, s, d = len(bounds), 32, 4, 300, 128
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, d, generator=card, device="cuda").to(dt)
    k = torch.randn(b, hkv, s, d, generator=card, device="cuda").to(dt)
    v = torch.randn(b, hkv, s, d, generator=card, device="cuda").to(dt)
    lo = torch.tensor([x for x, _ in bounds], dtype=torch.int32, device="cuda")
    hi = torch.tensor([y for _, y in bounds], dtype=torch.int32, device="cuda")
    before = flash_decode.launches
    got = flash_decode(q, k, v, lo, hi)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert _err(got, decode_attention_ref(q, k, v, lo, hi)) <= TOL[dtype]
    assert got[5].abs().max().item() == 0.0          # lo == hi: no slot


def test_serve_reduced_runs_on_kernels(card):
    """Reduced yi-6b served on the card with the kernel policy: every
    decode step launches both kernels, and the greedy tokens equal the
    plain device path's (f32, 2 layers)."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch

    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 200, size=4))) for _ in range(8)]
    gemm.launches = flash_decode.launches = 0
    with offload_policy(mode="device", use_kernels=True):
        got = serve_batch("yi-6b", prompts, max_new_tokens=4)
    steps = 4 + 4
    assert gemm.launches == steps * (5 * 2 + 1)
    assert flash_decode.launches == steps * 2
    with offload_policy(mode="device", use_kernels=False):
        want = serve_batch("yi-6b", prompts, max_new_tokens=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_graph_serve_reduced_matches_eager_on_kernels(card):
    """Reduced yi-6b served in graph mode on the kernels (each decode
    step's FFN an hnp graph, the residual fused into it): the same launch
    counts and greedy tokens as eager mode, since both run the same kernels
    on the same operands (f32, 2 layers)."""
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch

    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, 200, size=4))) for _ in range(8)]
    runs = {}
    for mode in ("eager", "graph"):
        gemm.launches = flash_decode.launches = 0
        with offload_policy(mode="device", use_kernels=True):
            res = serve_batch("yi-6b", prompts, max_new_tokens=4,
                              forward_mode=mode)
        runs[mode] = (res.tokens, gemm.launches, flash_decode.launches)
    steps = 4 + 4
    assert runs["graph"][1:] == (steps * (5 * 2 + 1), steps * 2)
    assert runs["graph"][1:] == runs["eager"][1:]
    np.testing.assert_array_equal(runs["graph"][0], runs["eager"][0])


def test_graph_forward_reduced_on_kernels(card):
    """Reduced yi-6b (f32, 2 layers) Model.forward in graph mode on the
    card: one flash-attention launch per layer, and the kernel path's
    greedy tokens equal the plain device path's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), forward_mode="graph")
    model = build_model(cfg)
    params = model.init_params(card, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=card,
                           device="cuda")
    flash_attention.launches = 0
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        got, _ = model.forward(params, tokens)
    torch.cuda.synchronize()
    assert flash_attention.launches == cfg.num_layers
    with offload_policy(mode="device", use_kernels=False), torch.no_grad():
        want, _ = model.forward(params, tokens)
    assert _err(got, want) <= 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_hnp_batches_same_shape_gemms_on_the_card(card):
    """Two independent same-shape GEMMs forced together take one launch of
    the batched GEMM kernel; values against numpy in float64."""
    import repro_torch.hnp as hnp
    from repro_torch.core.hero import offload_policy

    rng = np.random.default_rng(0)
    x, w1, w2 = (rng.normal(size=s).astype(np.float32)
                 for s in ((64, 96), (96, 48), (96, 48)))
    with offload_policy(mode="device", use_kernels=True):
        a = hnp.array(x)
        y1, y2 = a @ w1, a @ w2
        before = (gemm.launches, gemm_batched.launches)
        hnp.block_all(y1, y2)
        torch.cuda.synchronize()
        assert (gemm.launches, gemm_batched.launches) == (before[0],
                                                          before[1] + 1)
        assert y1.node.value.device.type == "cuda"
    for y, w in ((y1, w1), (y2, w2)):
        want = x.astype(np.float64) @ w.astype(np.float64)
        assert np.abs(hnp.asnumpy(y) - want).max() <= 2e-5 * np.abs(want).max()
