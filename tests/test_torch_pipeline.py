"""GPipe over a mesh axis (``repro_torch.launch.pipeline``) against
``tests/test_pipeline.py``'s sequential composition, evaluated by the
reference (its own pipeline is a multi-device subprocess that does not
run here): forward < 1e-5, gradients < 1e-4, and bit for bit against the
port's stages applied microbatch by microbatch (the same ops at the same
shapes).  Each stage's GEMM goes through the seam (``blas.matmul``) from
its mesh device's body."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core import blas
from repro_torch.core.accounting import offload_trace
from repro_torch.core.hero import offload_policy
from repro_torch.launch.pipeline import pipeline_apply
from repro_torch.sharding.spmd import Mesh

S, D, B, M = 4, 16, 8, 4


def _inputs():
    rng = np.random.default_rng(0)
    return ({"w": (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal((S, D)) * 0.1).astype(np.float32)},
            rng.standard_normal((B, D)).astype(np.float32))


def _jstage(p, xmb):
    return jax.nn.gelu(xmb @ p["w"] + p["b"])


def _jsequential(params, x):
    for i in range(S):
        x = _jstage(jax.tree_util.tree_map(lambda a: a[i], params), x)
    return x


def _stage(p, xmb):
    return F.gelu(blas.matmul(xmb, p["w"]) + p["b"], approximate="tanh")


def _torch(params):
    return {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in params.items()}


def test_gpipe_matches_sequential():
    params, x = _inputs()
    want = np.asarray(_jsequential(jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(x)))
    mesh = Mesh((2, 4), ("data", "model"))
    tp = _torch(params)
    with offload_policy(mode="device", use_kernels=True), \
            offload_trace() as tr:
        got = pipeline_apply(tp, torch.from_numpy(x), _stage, mesh,
                             num_microbatches=M)
        (got ** 2).sum().backward()
    assert np.abs(got.detach().numpy() - want).max() < 1e-5
    # every mesh device runs a stage at each of the M + S - 1 ticks.
    assert len(tr.records) == mesh.size * (M + S - 1)

    g_want = jax.grad(lambda p: jnp.sum(_jsequential(p, jnp.asarray(x)) ** 2))(
        jax.tree.map(jnp.asarray, params))
    g_err = max(np.abs(tp[k].grad.numpy() - np.asarray(g_want[k])).max()
                for k in params)
    assert g_err < 1e-4

    # the stages applied microbatch by microbatch: the same bits.
    seq = []
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for j in range(M):
            h = xt[j * (B // M):(j + 1) * (B // M)]
            for i in range(S):
                h = _stage(tree.tree_map(lambda a: a[i], tp), h)
            seq.append(h)
    assert torch.equal(got.detach(), torch.cat(seq))


def test_gpipe_rejects_an_uneven_split():
    params, x = _inputs()
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(_torch(params), torch.from_numpy(x), _stage,
                       Mesh((4,), ("model",)), num_microbatches=3)
