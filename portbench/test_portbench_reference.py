"""The plain references (``reference/``) against the program's plain path
on the same seeded weights, in float32 at a reduced size on the CPU, and
the float8 control well away from both, for every configuration file in
``configs/``."""

import pytest
import torch

from portbench import cells, harness
from portbench.reference import common
from portbench.weights import layout, make_params, rules

CONFIGS = sorted(p.stem for p in (cells.HERE / "configs").glob("*.json"))

def _both(tiny_config, name, b=2, s=48, seed=2 ** 33 + 7):
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model

    cfg = dict(tiny_config(name), torch_dtype="float32")
    if cfg["family"] == "mamba2":
        cfg["chunk_size"] = 16          # three chunks: the recurrence runs
    model = build_model(cells.port_arch(cfg))
    params = make_params(layout(cfg), seed, "cpu", rules(cfg))
    tokens = torch.randint(0, cfg["vocab_size"], (b, s),
                           generator=torch.Generator().manual_seed(seed))
    with offload_policy(mode="device", use_kernels=False), torch.no_grad():
        program = model.forward(params, tokens)[0]
    ref = harness.reference_of(cfg)
    return cfg, params, tokens, program, ref

@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_programs_plain_path(tiny_config, name):
    cfg, params, tokens, program, ref = _both(tiny_config, name)
    want = ref.forward(params, tokens, cfg)
    assert want.dtype == torch.float32 and want.shape == program.shape
    scale = want.abs().max()
    assert float((program - want).abs().max() / scale) < 2e-5

@pytest.mark.parametrize("name", CONFIGS)
def test_fp8_control_departs_from_the_reference(tiny_config, name):
    cfg, params, tokens, program, ref = _both(tiny_config, name)
    want = ref.forward(params, tokens, cfg)
    fp8 = ref.forward(params, tokens, cfg, precision="fp8")
    err = float((fp8 - want).norm() / want.norm())
    assert 0.02 < err < 0.5

def test_mamba_ssd_matches_the_sequential_recurrence():
    """The chunked SSD against h_t = exp(a_t) h_{t−1} + B_t x_tᵀ,
    y_t = C_t h_t, step by step."""
    from portbench.reference.mamba2 import ssd

    g = torch.Generator().manual_seed(3)
    b, length, h, p, n = 2, 24, 3, 4, 5
    x = torch.randn(b, length, h, p, generator=g)
    a = -torch.rand(b, length, h, generator=g)
    bb = torch.randn(b, length, h, n, generator=g)
    cc = torch.randn(b, length, h, n, generator=g)
    state = torch.zeros(b, h, n, p)
    want = []
    for t in range(length):
        state = torch.exp(a[:, t])[..., None, None] * state \
            + bb[:, t, :, :, None] * x[:, t, :, None, :]
        want.append(torch.einsum("bhn,bhnp->bhp", cc[:, t], state))
    want = torch.stack(want, dim=1)
    for chunk in (4, 8, 24):
        got = ssd(x, a, bb, cc, chunk)
        assert torch.allclose(got, want, atol=1e-5, rtol=1e-5), chunk

def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    got = common.fp8_round(t, -1)
    assert got[0, 0] == 1.0 and got[0, 1] == 1.0 and got[0, 2] == 448.0
    assert abs(float(got[0, 3]) + 3.3) <= 3.3 * 2 ** -4

def test_tf32_stays_off_and_is_restored():
    before = torch.backends.cuda.matmul.allow_tf32
    with common.no_tf32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before
