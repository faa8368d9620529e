"""The sharding rules (``repro_torch.sharding``), the meshes
(``repro_torch.launch.mesh``) and elastic re-planning
(``repro_torch.runtime.elastic.replan``) against the reference's.

Every ``list_archs()`` arch at its published widths, on a 16 × 16 and a
2 × 16 × 16 mesh, FSDP off and on: the port's parameter and optimizer
specs equal the reference's after the per-layer mapping — a leaf under
``stack`` (one leaf a layer in the port) takes the reference's stacked
leaf's spec without its leading layer entry.  Shapes only: the port's
trees are built on the meta device, the reference's by ``eval_shape``.
The batch and cache specs run on ``tests/test_sharding.py``'s shapes.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import warmup_cosine as jwarmup
from repro.runtime.elastic import replan as jreplan
from repro.sharding import batch_pspecs as jbatch_pspecs
from repro.sharding import cache_pspecs as jcache_pspecs
from repro.sharding import opt_pspecs as jopt_pspecs
from repro.sharding import param_pspecs as jparam_pspecs
from repro_torch import tree
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.optim import warmup_cosine as twarmup
from repro_torch.runtime import ElasticPlan, replan
from repro_torch.sharding import (batch_pspecs, cache_pspecs, named,
                                  opt_pspecs, param_pspecs)
from repro_torch.sharding.partition import NamedSharding
from repro_torch.sharding.spmd import P

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    """Rules read only ``shape`` and ``axis_names`` (the reference's test
    uses the same stand-in)."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _ref_specs(spec_tree):
    """{path: spec} of a reference spec tree, stack indices absent."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP))
    for path, spec in flat:
        keys = []
        for k in path:
            keys.append(str(getattr(k, "key", getattr(k, "name",
                                                      getattr(k, "idx", k)))))
        out["/".join(keys)] = tuple(spec)
    return out


def _port_specs(spec_tree):
    """{mapped path: (spec, under stack)} of a port spec tree: the layer
    index after ``stack`` is dropped to name the reference's leaf."""
    out = {}
    for path, spec in tree.leaves_with_paths(
            spec_tree, is_leaf=lambda x: isinstance(x, P)):
        parts = path.split("/")
        stacked = False
        for i in range(len(parts) - 1):
            if parts[i] == "stack" and parts[i + 1].isdigit():
                del parts[i + 1]
                stacked = True
                break
        out.setdefault("/".join(parts), set()).add((tuple(spec), stacked))
    return out


def _assert_mapped(port, ref):
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))
    for path, variants in port.items():
        for spec, stacked in variants:
            want = ref[path][1:] if stacked else ref[path]
            assert spec == want, (path, spec, ref[path])


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference model, its param shapes, port model, its meta params),
    built once an arch."""
    jm = jbuild(jget_arch(arch))
    jps = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    tm = tbuild(tget_arch(arch))
    tps = tm.init_params(torch.Generator(), device="meta")
    return jm, jps, tm, tps


@functools.lru_cache(maxsize=None)
def _opt_shapes(arch):
    jm, jps, tm, tps = _shapes(arch)
    j_init, _ = jmake_optimizer(jm.cfg, jwarmup(1e-3, 1, 10))
    t_init, _ = tmake_optimizer(tm.cfg, twarmup(1e-3, 1, 10))
    return jax.eval_shape(j_init, jps), t_init(tps)


def test_port_has_the_references_archs():
    assert tlist_archs() == jlist_archs()


@pytest.mark.parametrize("arch", jlist_archs())
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_and_opt_specs_match_reference(arch, mesh_name, fsdp):
    mesh = FakeMesh(*MESHES[mesh_name])
    jm, jps, tm, tps = _shapes(arch)
    _assert_mapped(_port_specs(param_pspecs(tps, mesh, fsdp=fsdp)),
                   _ref_specs(jparam_pspecs(jps, mesh, fsdp=fsdp)))
    jos, tos = _opt_shapes(arch)
    _assert_mapped(_port_specs(opt_pspecs(tos, mesh, fsdp=fsdp)),
                   _ref_specs(jopt_pspecs(jos, mesh, fsdp=fsdp)))


def _meta(*shape):
    return torch.empty(shape, device="meta")


BATCHES = [
    {"tokens": (256, 4096), "positions": (3, 256, 4096)},
    {"tokens": (1, 64)},
    {"tokens": (8, 64), "labels": (8, 64)},
    {"embeds": (32, 128, 1280), "positions": (32, 128)},
]
CACHES = [
    {"k": (9, 1, 8, 524288, 128)},
    {"k": (80, 128, 8, 32768, 128), "v": (80, 128, 8, 32768, 128)},
    {"ssm": (48, 16, 32, 128, 64), "conv": (48, 16, 3, 4352)},
    {"k": (9, 32, 8, 4096, 128), "ssm": (9, 7, 32, 128, 64, 64),
     "conv": (9, 7, 32, 3, 16384)},
]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("i", range(len(BATCHES)))
def test_batch_specs_match_reference(mesh_name, i):
    mesh = FakeMesh(*MESHES[mesh_name])
    shapes = BATCHES[i]
    got = batch_pspecs({k: _meta(*s) for k, s in shapes.items()}, mesh)
    want = jbatch_pspecs({k: jax.ShapeDtypeStruct(s, jnp.int32)
                          for k, s in shapes.items()}, mesh)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("i", range(len(CACHES)))
def test_cache_specs_match_reference(mesh_name, i):
    mesh = FakeMesh(*MESHES[mesh_name])
    shapes = CACHES[i]
    got = cache_pspecs({k: _meta(*s) for k, s in shapes.items()}, mesh)
    want = jcache_pspecs({k: jax.ShapeDtypeStruct(s, jnp.bfloat16)
                          for k, s in shapes.items()}, mesh)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


def test_reference_test_sharding_cases_hold_in_the_port():
    """tests/test_sharding.py's own assertions, on the port's trees."""
    mesh = FakeMesh(*MESHES["16x16"])
    specs = param_pspecs(_shapes("qwen2-72b")[3], mesh)
    st = specs["stack"][0]
    assert st["mixer"]["wq"] == P(None, "model")
    assert st["mixer"]["wo"] == P("model", None)
    assert st["ffn"]["w_gate"] == P(None, "model")
    assert st["ffn"]["w_down"] == P("model", None)
    assert specs["embed"] == P("model", None)
    assert specs["head"] == P(None, "model")
    assert st["norm1"]["scale"] == P(None)
    ffn = param_pspecs(_shapes("qwen3-moe-30b-a3b")[3], mesh)["stack"][0]["ffn"]
    assert ffn["we_gate"] == P("model", None, None)
    assert ffn["router"] == P(None, None)
    assert param_pspecs(_shapes("mamba2-370m")[3], mesh)["embed"] == \
        P(None, None)
    assert batch_pspecs({"tokens": _meta(1, 64)}, mesh)["tokens"] == \
        P(None, None)
    assert cache_pspecs({"k": _meta(9, 1, 8, 524288, 128)}, mesh)["k"] == \
        P(None, None, None, ("data", "model"), None)


def test_meshes():
    prod = make_production_mesh(device="cpu")
    assert prod.axis_names == ("data", "model")
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    pod = make_production_mesh(multi_pod=True, device="cpu")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    local = make_local_mesh(device="cpu")
    assert local.shape == {"data": 1, "model": 1}
    assert local.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_local_mesh()


def test_named_wraps_each_spec():
    mesh = make_production_mesh(device="cpu")
    tree_ = {"a": P(None, "model"), "b": [P(), P("data")]}
    got = named(mesh, tree_)
    assert got["a"] == NamedSharding(mesh, P(None, "model"))
    assert got["b"][1].spec == P("data") and got["b"][1].mesh is mesh


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_replan_matches_reference(arch):
    jm, jps, tm, tps = _shapes(arch)
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    tmesh = make_production_mesh(device="cpu")
    jos, tos = _opt_shapes(arch)
    want = jreplan(jmesh, jps, jos, global_batch=256, num_hosts=8)
    got = replan(tmesh, tps, tos, global_batch=256, num_hosts=8)
    assert isinstance(got, ElasticPlan) and got.mesh is tmesh
    for field in ("global_batch", "local_batch", "num_hosts"):
        assert getattr(got, field) == getattr(want, field)

    def spec_of(x):
        return x.spec

    for g, w in ((got.param_shardings, want.param_shardings),
                 (got.opt_shardings, want.opt_shardings)):
        gp = tree.tree_map(spec_of, g,
                           is_leaf=lambda x: isinstance(x, NamedSharding))
        wp = jax.tree_util.tree_map(
            spec_of, w, is_leaf=lambda x: isinstance(x, JNamedSharding))
        _assert_mapped(_port_specs(gp), _ref_specs(wp))
    no_opt = replan(tmesh, tps, global_batch=16, num_hosts=4)
    assert no_opt.opt_shardings is None and no_opt.local_batch == 4
    with pytest.raises(ValueError, match="not divisible"):
        replan(tmesh, tps, global_batch=10, num_hosts=4)
