"""The emulated mesh (``repro_torch.sharding.spmd``): each collective
against the reference's ``lax`` collective under ``jax.vmap(axis_name=)``
(the reference's multi-device subprocess tests do not run here, ROADMAP
Queue 3), its gradient against autograd of the unsharded function, and
the mechanism: grad modes reach the bodies, errors abort the call, threads
are reused, counts are exact.

Inputs are drawn from a seeded numpy generator; collectives move and add
values exactly, so the bar is 1e-6 (f32 sums in other orders)."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import _build
from repro_torch.sharding import spmd
from repro_torch.sharding.annotate import _ambient_mesh, constrain
from repro_torch.sharding.spmd import Mesh, P, shard_map

N = 4
TOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _mesh1(n=N):
    return Mesh((n,), ("model",))


def _port(body, x, mesh=None, in_spec=P("model"), out_spec=P("model")):
    mesh = mesh or _mesh1()
    return shard_map(body, mesh=mesh, in_specs=(in_spec,),
                     out_specs=out_spec)(x)


def _ref(body, xs):
    """The reference's collective: ``body`` vmapped over the leading
    (device) axis of ``xs`` with axis name "model"."""
    return np.asarray(jax.vmap(body, axis_name="model")(jnp.asarray(xs)))


def _stacked(out, n=N):
    """The port's assembled P("model") output as (N, local...)."""
    return out.reshape(n, out.shape[0] // n, *out.shape[1:]).numpy()


# ---------------------------------------------------------------------------
# each collective against lax under vmap
# ---------------------------------------------------------------------------

CASES = {
    "psum": (lambda x: jax.lax.psum(x, "model"),
             lambda x: spmd.psum(x, "model"), (N, 3, 5)),
    "pmax": (lambda x: jax.lax.pmax(x, "model"),
             lambda x: spmd.pmax(x, "model"), (N, 3, 5)),
    "pmean": (lambda x: jax.lax.pmean(x, "model"),
              lambda x: spmd.pmean(x, "model"), (N, 3, 5)),
    "all_gather": (
        lambda x: jax.lax.all_gather(x, "model", axis=1, tiled=True),
        lambda x: spmd.all_gather(x, "model", dim=1), (N, 3, 5)),
    "all_gather_dim0": (
        lambda x: jax.lax.all_gather(x, "model", axis=0, tiled=True),
        lambda x: spmd.all_gather(x, "model", dim=-2), (N, 3, 5)),
    "ppermute_ring": (
        lambda x: jax.lax.ppermute(x, "model",
                                   [(i, (i + 1) % N) for i in range(N)]),
        lambda x: spmd.ppermute(x, "model",
                                [(i, (i + 1) % N) for i in range(N)]),
        (N, 3, 5)),
    "ppermute_swap": (
        lambda x: jax.lax.ppermute(x, "model", [(0, 3), (3, 0), (1, 2),
                                                (2, 1)]),
        lambda x: spmd.ppermute(x, "model", [(0, 3), (3, 0), (1, 2),
                                             (2, 1)]), (N, 3, 5)),
    "all_to_all": (
        lambda x: jax.lax.all_to_all(x, "model", 0, 0),
        lambda x: spmd.all_to_all(x, "model", 0, 0), (N, N, 2, 3)),
    "all_to_all_concat_1": (
        lambda x: jax.lax.all_to_all(x, "model", 0, 1),
        lambda x: spmd.all_to_all(x, "model", 0, 1), (N, N, 2, 3)),
    "axis_index": (
        lambda x: x * jax.lax.axis_index("model"),
        lambda x: x * spmd.axis_index("model"), (N, 3, 5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_matches_lax_under_vmap(name):
    ref_body, port_body, shape = CASES[name]
    xs = _rng(1).standard_normal(shape).astype(np.float32)
    want = _ref(ref_body, xs)
    got = _port(port_body, torch.from_numpy(xs.reshape(-1, *shape[2:])))
    np.testing.assert_allclose(_stacked(got), want, rtol=0, atol=TOL)


def test_collectives_over_a_2d_mesh_match_nested_vmap():
    """psum over one axis and over both, and the tuple axis index, on a
    (data 2, model 4) mesh against nested vmaps (data outer)."""
    xs = _rng(2).standard_normal((2, 4, 3)).astype(np.float32)
    mesh = Mesh((2, 4), ("data", "model"))

    def nested(body):
        return np.asarray(jax.vmap(jax.vmap(body, axis_name="model"),
                                   axis_name="data")(jnp.asarray(xs)))

    cases = [
        (lambda x: jax.lax.psum(x, "data"), lambda x: spmd.psum(x, "data")),
        (lambda x: jax.lax.psum(x, ("data", "model")),
         lambda x: spmd.psum(x, ("data", "model"))),
        (lambda x: x + jax.lax.axis_index(("data", "model")),
         lambda x: x + spmd.axis_index(("data", "model"))),
    ]
    xt = torch.from_numpy(xs.reshape(2, 4 * 3))
    for ref_body, port_body in cases:
        got = shard_map(port_body, mesh=mesh, in_specs=(P("data", "model"),),
                        out_specs=P("data", "model"))(xt)
        np.testing.assert_allclose(got.numpy().reshape(2, 4, 3),
                                   nested(ref_body), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# gradients against autograd of the unsharded function
# ---------------------------------------------------------------------------

def _unsharded(name, x):
    """The global function each collective computes on (N·a, b) input."""
    xs = x.reshape(N, -1, *x.shape[1:])
    if name == "psum":
        return xs.sum(0).repeat(N, *([1] * (x.ndim - 1)))
    if name == "all_gather":
        return x.repeat(N, *([1] * (x.ndim - 1)))
    if name == "ppermute_ring":
        return torch.roll(xs, 1, dims=0).reshape(x.shape)
    if name == "all_to_all":
        return xs.transpose(0, 1).reshape(x.shape)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["psum", "all_gather", "ppermute_ring",
                                  "all_to_all"])
def test_collective_gradient_matches_unsharded(name):
    _, port_body, shape = CASES[name]
    if name == "all_gather":
        def port_body(x):
            return spmd.all_gather(x, "model", dim=0)
    xs = _rng(3).standard_normal(shape).astype(np.float32)
    x0 = torch.from_numpy(xs.reshape(-1, *shape[2:]))
    xa = x0.clone().requires_grad_(True)
    xb = x0.clone().requires_grad_(True)
    ya = _port(port_body, xa)
    yb = _unsharded(name, xb)
    assert ya.shape == yb.shape
    w = torch.from_numpy(_rng(4).standard_normal(tuple(ya.shape))
                         .astype(np.float32))
    (ya * w).sum().backward()
    (yb * w).sum().backward()
    torch.testing.assert_close(ya.detach(), yb.detach(), rtol=0, atol=TOL)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# specs, splitting and assembly
# ---------------------------------------------------------------------------

def test_p_normalizes_as_the_references_partition_spec():
    from jax.sharding import PartitionSpec as JP

    for entries in [(None,), (("data",), None), (("pod", "data"), "model"),
                    ((), "model"), ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries))


def test_splits_are_views_and_replicated_operands_shared():
    mesh = Mesh((2, 4), ("data", "model"))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    r = torch.ones(3)
    seen = []

    def body(xl, rl):
        seen.append((xl.untyped_storage().data_ptr(), rl))
        return xl * 2

    out = shard_map(body, mesh=mesh, in_specs=(P("data", "model"), P()),
                    out_specs=P("data", "model"))(x, r)
    torch.testing.assert_close(out, x * 2)
    assert all(ptr == x.untyped_storage().data_ptr() for ptr, _ in seen)
    assert all(rl is r for _, rl in seen)


@settings(deadline=None, max_examples=20)
@given(st.sampled_from([(1, 4), (2, 2), (2, 4), (4, 1)]),
       st.sampled_from([("data", None), (None, "model"), ("model", "data"),
                        (("data", "model"), None), (None, None)]))
def test_split_then_assemble_is_the_identity(shape, spec):
    mesh = Mesh(shape, ("data", "model"))
    x = torch.from_numpy(_rng(5).standard_normal((8, 8)).astype(np.float32))
    out = shard_map(lambda a: a, mesh=mesh, in_specs=(P(*spec),),
                    out_specs=P(*spec))(x)
    assert torch.equal(out, x)
    mesh.close()


def test_uneven_split_raises():
    with pytest.raises(ValueError, match="does not split"):
        _port(lambda a: a, torch.zeros(6, 2))


# ---------------------------------------------------------------------------
# the mechanism
# ---------------------------------------------------------------------------

def test_bodies_run_under_the_callers_grad_and_inference_modes():
    x = torch.ones(N, 2)
    modes = []

    def body(a):
        modes.append((torch.is_grad_enabled(),
                      torch.is_inference_mode_enabled()))
        return spmd.psum(a, "model")

    _port(body, x)
    with torch.no_grad():
        _port(body, x)
    with torch.inference_mode():
        out = _port(body, x)
    assert out.is_inference()
    assert modes == [(True, False)] * N + [(False, False)] * N \
        + [(False, True)] * N


def test_bodies_have_no_ambient_mesh_and_may_not_nest():
    mesh = _mesh1()
    inner = []

    def body(a):
        inner.append(_ambient_mesh())
        return a

    with mesh:
        assert _ambient_mesh() is mesh
        shard_map(body, mesh=mesh, in_specs=(P("model"),),
                  out_specs=P("model"))(torch.zeros(N))
    assert _ambient_mesh() is None and inner == [None] * N

    def nested(a):
        return shard_map(lambda b: b, mesh=mesh, in_specs=(P(),),
                         out_specs=P())(a)

    with pytest.raises(RuntimeError, match="inside a shard_map body"):
        shard_map(nested, mesh=mesh, in_specs=(P("model"),),
                  out_specs=P("model"))(torch.zeros(N))


def test_an_error_aborts_the_call_and_the_mesh_runs_on():
    mesh = _mesh1()

    def bad(a):
        if spmd.axis_index("model") == 2:
            raise ValueError("boom")
        return spmd.psum(a, "model")

    with pytest.raises(ValueError, match="boom"):
        _port(bad, torch.ones(N), mesh)

    def mismatched(a):
        if spmd.axis_index("model") == 1:
            return spmd.pmax(a, "model")
        return spmd.psum(a, "model")

    with pytest.raises(RuntimeError, match="disagree"):
        _port(mismatched, torch.ones(N), mesh)
    out = _port(lambda a: spmd.psum(a, "model"), torch.ones(N), mesh)
    assert out.tolist() == [4.0] * N


def test_threads_are_reused_and_run_in_device_order():
    mesh = _mesh1()
    order, idents = [], []

    def body(a):
        order.append(spmd.axis_index("model"))
        idents.append(threading.get_ident())
        b = spmd.psum(a, "model")
        order.append(spmd.axis_index("model"))
        return b

    for _ in range(3):
        _port(body, torch.ones(N), mesh)
    assert order == list(range(N)) * 6
    assert idents[:N] == idents[N:2 * N] == idents[2 * N:]
    assert len(set(idents[:N])) == N
    mesh.close()


def test_psum_sums_in_device_order_and_repeats_bit_for_bit():
    xs = torch.from_numpy(_rng(6).standard_normal((N * 64,))
                          .astype(np.float32)).to(torch.bfloat16)
    body = lambda a: spmd.psum(a, "model")   # noqa: E731
    a = _port(body, xs)
    b = _port(body, xs)
    parts = xs.reshape(N, 64)
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    assert torch.equal(a, b) and torch.equal(a[:64], want)


def test_the_mesh_counts_collectives_per_device():
    mesh = Mesh((2, 4), ("data", "model"))

    def body(a):
        b = spmd.psum(a, "model")
        return spmd.all_gather(b, "data", dim=0)

    shard_map(body, mesh=mesh, in_specs=(P(("data", "model")),),
              out_specs=P("model"))(torch.zeros(8 * 3))
    assert mesh.collectives["psum"] == {"calls": [1] * 8, "bytes": [12] * 8}
    assert mesh.collective_totals() == {
        "psum": {"calls": 8, "bytes": 96},
        "all_gather": {"calls": 8, "bytes": 96}}
    assert mesh.shard_map_calls == 1
    mesh.reset_collectives()
    assert mesh.collectives == {} and mesh.shard_map_calls == 0


def test_launch_counts_are_exact_under_contention():
    """Many more threads than cores bump one wrapper's counters through
    ``count_launch`` with a short switch interval: no update is lost."""

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.route_launches = {"wgmma": 0}
    threads, per = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper, "wgmma")
                            for _ in range(per)]) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == threads * per
    assert wrapper.route_launches["wgmma"] == threads * per


def test_constrain_is_the_identity_and_checks_its_tokens():
    x = torch.zeros(4, 2)
    assert constrain(x, "dp", "model") is x          # no mesh
    with Mesh((2, 4), ("data", "model")):
        assert constrain(x, "dp", "model") is x
        assert constrain(x, "pod", None) is x         # absent name -> None
        with pytest.raises(ValueError, match="no axis"):
            constrain(x, ("data", "pod"), None)
        with pytest.raises(TypeError):
            constrain(x, 3, None)
        with pytest.raises(ValueError, match="rank"):
            constrain(x, None, None, None)


def test_operands_must_live_on_the_mesh_device():
    mesh = Mesh((2,), ("model",), device="meta")
    with pytest.raises(ValueError, match="the mesh on meta"):
        shard_map(lambda a: a, mesh=mesh, in_specs=(P(),),
                  out_specs=P())(torch.zeros(2))
