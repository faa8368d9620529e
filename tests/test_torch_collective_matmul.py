"""The ring collective matmul and the int8 psum against the reference's
own functions run under ``jax.vmap(axis_name=)`` (its multi-device
subprocess test does not run here, ROADMAP Queue 3), at
``tests/test_collective_matmul.py``'s sizes and bars: err < 1e-4,
gerr < 1e-3.  Inputs from a seeded numpy generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import compressed_psum as jcompressed_psum
from repro.sharding.collective_matmul import ring_ag_matmul as jring
from repro_torch.core.accounting import offload_trace
from repro_torch.core.hero import offload_policy
from repro_torch.optim import compressed_psum
from repro_torch.sharding.collective_matmul import ring_ag_matmul
from repro_torch.sharding.spmd import Mesh, P, shard_map

N, B, S, D, F = 4, 2, 16, 8, 12


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            rng.standard_normal((D, F)).astype(np.float32))


def _ring_fn(mesh):
    return shard_map(lambda xs, wl: ring_ag_matmul(xs, wl, "model"),
                     mesh=mesh, in_specs=(P(None, "model", None),
                                          P(None, "model")),
                     out_specs=P(None, None, "model"))


def _ref_ring(x, w):
    """The reference's ring under vmap over N stacked shards, assembled
    as its shard_map would (columns in device order)."""
    xs = x.reshape(B, N, S // N, D).transpose(1, 0, 2, 3)
    ws = w.reshape(D, N, F // N).transpose(1, 0, 2)
    ys = jax.vmap(lambda a, b: jring(a, b, "model"), axis_name="model")(
        jnp.asarray(xs), jnp.asarray(ws))
    return np.asarray(ys).transpose(1, 2, 0, 3).reshape(B, S, F)


def test_ring_ag_matmul_matches_reference_and_gather_matmul():
    x, w = _inputs()
    mesh = Mesh((N,), ("model",))
    with offload_policy(mode="device", use_kernels=True), \
            offload_trace() as tr:
        got = _ring_fn(mesh)(torch.from_numpy(x), torch.from_numpy(w))
    assert np.abs(got.numpy() - x @ w).max() < 1e-4
    assert np.abs(got.numpy() - _ref_ring(x, w)).max() < 1e-4
    assert tr.records == []                # the ticks' GEMMs write no record
    # N ticks, each one ppermute a device.
    assert mesh.collectives["ppermute"]["calls"] == [N] * N

    xa = torch.from_numpy(x).requires_grad_(True)
    (_ring_fn(mesh)(xa, torch.from_numpy(w)) ** 2).sum().backward()
    g_want = jax.grad(lambda a: jnp.sum(jnp.einsum("bsd,df->bsf", a,
                                                   jnp.asarray(w)) ** 2))(
        jnp.asarray(x))
    assert np.abs(xa.grad.numpy() - np.asarray(g_want)).max() < 1e-3


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_compressed_psum_matches_reference(dtype):
    """The int8 psum over the data axis (4 devices) against the
    reference's under vmap: the sums are exact int32 ones on a shared
    scale, so outputs and error buffers agree to the last rounding."""
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((N, 3, 4)).astype(np.float32),
             "b": (rng.standard_normal((N, 5)) * 1e-3).astype(np.float32),
             "z": np.zeros((N, 2), np.float32)}
    err = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
           for k, v in grads.items()}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want_g, want_e = jax.vmap(
        lambda g, e: jcompressed_psum(g, e, "data"), axis_name="data")(
        {k: jnp.asarray(v).astype(jdt) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in err.items()})
    mesh = Mesh((N,), ("data",))

    def flat(t):
        return t.reshape(-1, *t.shape[2:])

    fn = shard_map(lambda g, e: compressed_psum(g, e, "data"), mesh=mesh,
                   in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")))
    got_g, got_e = fn({k: flat(torch.from_numpy(v)).to(tdt)
                       for k, v in grads.items()},
                      {k: flat(torch.from_numpy(v)) for k, v in err.items()})
    for k in grads:
        np.testing.assert_allclose(
            got_g[k].float().numpy(),
            flat(np.asarray(want_g[k].astype(jnp.float32))), rtol=1e-6,
            atol=1e-6)
        np.testing.assert_allclose(got_e[k].numpy(),
                                   flat(np.asarray(want_e[k])), rtol=1e-6,
                                   atol=1e-7)
    assert mesh.collective_totals()["pmax"]["calls"] == 3 * N
    assert mesh.collective_totals()["psum"]["calls"] == 3 * N
