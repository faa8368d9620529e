"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (``gpu`` marker) and skips without one.
The file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Tolerances are
``tests/test_kernels.py``'s, f32 2e-5 and bf16 2e-2, of max |plain|.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.ref import decode_attention_ref, gemm_ref

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
