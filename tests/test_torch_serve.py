"""The port's serve path against the reference at reduced yi-6b (2 layers,
d 64, f32), with the reference's weights converted by ``params_from_jax``.

Both packages run under their kernel policy: the reference's Pallas kernels
in interpret mode, the port's kernel wrappers on their plain versions (the
tensors lie on the CPU).
"""

from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.accounting import offload_trace as jtrace
from repro.core.hero import offload_policy as jpolicy
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import build_model as jbuild
from repro_torch.configs import get_arch as tget_arch
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core.accounting import offload_trace as ttrace
from repro_torch.core.hero import offload_policy as tpolicy
from repro_torch.launch.serve import serve_batch as tserve_batch
from repro_torch.models import build_model as tbuild

ARCH = "yi-6b"
BATCH = 8          # decode GEMMs have m = batch; the kernel gate is >= 8
STEPS = 12
# Logits agree to 1e-4 of their scale: the packages sum in different f32
# orders (XLA's dot and Pallas tiles against torch's CPU matmul), and the
# differences compound over 2 layers and 12 cached steps.
LOGIT_TOL = 1e-4
RENAME = {"device-pallas": "device-kernel"}


def _jax_params(seed=0):
    cfg = jget_arch(ARCH).reduced()
    params = jbuild(cfg).init_params(jax.random.PRNGKey(seed))
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def _ref_policy():
    return jpolicy(mode="device", use_pallas=True, interpret=True,
                   platform="tpu-v5e")


def _port_policy():
    return tpolicy(mode="device", use_kernels=True, platform="tpu-v5e")


def _totals(records):
    """Count-weighted totals per (op, backend): the reference writes one
    record per op per step with count = num_layers (its scan body is traced
    once); the port's eager layer loop writes num_layers records of count 1."""
    out = defaultdict(lambda: [0.0, 0.0])
    for r in records:
        key = (r.op, RENAME.get(r.backend, r.backend))
        out[key][0] += r.count
        out[key][1] += r.count * r.cost.flops
    return dict(out)


def test_params_from_jax_bf16_bit_exact():
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    t = tensor_from_numpy(jb)
    assert t.dtype == torch.bfloat16 and t.shape == (3, 5)
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          jb.view(np.uint16))
    jp, tp = _jax_params()
    assert len(tp["stack"]) == jget_arch(ARCH).reduced().num_layers
    np.testing.assert_array_equal(
        tp["stack"][1]["mixer"]["wq"].numpy(),
        np.asarray(jp["stack"]["mixer"]["wq"][1]))


def test_decode_steps_match_reference():
    jp, tp = _jax_params()
    cfg = jget_arch(ARCH).reduced()
    jm, tm = jbuild(cfg), tbuild(tget_arch(ARCH).reduced())
    toks = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(STEPS, BATCH, 1)).astype(np.int32)
    jc = jm.init_decode_cache(BATCH, 16)
    tc = tm.init_decode_cache(BATCH, 16, device="cpu")
    jl, tl = [], []
    with _ref_policy(), jtrace() as jt:
        for s in range(STEPS):
            logits, jc = jm.decode_step(jp, jc, jnp.asarray(toks[s]),
                                        jnp.int32(s))
            jl.append(np.asarray(logits))
    with _port_policy(), ttrace() as tt, torch.no_grad():
        for s in range(STEPS):
            logits, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[s]), s)
            tl.append(logits.numpy())
    jl, tl = np.stack(jl), np.stack(tl)
    assert tl.shape == (STEPS, BATCH, cfg.vocab_size)
    assert np.abs(tl - jl).max() <= LOGIT_TOL * np.abs(jl).max()
    np.testing.assert_allclose(
        np.asarray(jc["k"]), tc["k"].numpy(),
        atol=LOGIT_TOL * np.abs(np.asarray(jc["k"])).max())
    jtot, ttot = _totals(jt.records), _totals(tt.records)
    assert ttot == jtot
    for op in ("gemm", "qkv_project", "mlp_block", "attention"):
        assert (op, "device-kernel") in ttot


class _BlockingJax:
    """``jax`` as the reference's serve module sees it, with every jitted
    step waited for before it returns.

    The reference's ``_run_prefill`` rewrites one numpy token buffer after
    handing it to ``jnp.asarray``, which may alias it without a copy on the
    CPU; with asynchronous dispatch a pending step can then read the next
    step's tokens, and the served tokens change from run to run (ROADMAP
    Queue 3).  Waiting for each step removes the race and nothing else."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kwargs):
        step = jax.jit(fn, **kwargs)
        return lambda *args: jax.block_until_ready(step(*args))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_batch_greedy_tokens_match_reference(use_kernels, monkeypatch):
    """Reference under its kernel policy against the port with and without
    the kernel policy (on the CPU both are the same plain math)."""
    import repro.launch.serve

    monkeypatch.setattr(repro.launch.serve, "jax", _BlockingJax())
    jp, tp = _jax_params()
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, 200, size=4)))
               for _ in range(BATCH)]
    with _ref_policy():
        want = jserve_batch(ARCH, prompts, smoke=True, max_new_tokens=4,
                            params=jp)
    with tpolicy(mode="device", use_kernels=use_kernels, platform="tpu-v5e"):
        got = tserve_batch(ARCH, prompts, smoke=True, max_new_tokens=4,
                           params=tp, device="cpu")
    assert got.tokens.shape == (BATCH, 4)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_serve_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve_batch(ARCH, [[1, 2, 3]], max_new_tokens=1)


def test_cli_serves_every_seam_op_on_the_kernels(capsys):
    """The CLI needs no option to reach the kernels: at its default batch
    of 8 every GEMM-family and decode-attention record is on
    ``device-kernel`` (here on the kernels' plain versions, CPU tensors)."""
    from repro_torch.launch.serve import main

    with ttrace() as tt:
        main(["--arch", ARCH, "--device", "cpu", "--prompt-len", "2",
              "--max-new", "2"])
    backends = defaultdict(set)
    for r in tt.records:
        backends[r.op].add(r.backend)
    for op in ("gemm", "qkv_project", "mlp_block", "attention"):
        assert backends[op] == {"device-kernel"}, (op, backends[op])
    assert "tok/s" in capsys.readouterr().out
