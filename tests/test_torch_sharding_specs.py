"""The port's sharding trees against the reference's, with no process:
`ParamDef.spec`, `param_shardings(serve=False/True)`, `opt_shardings`,
`batch_shardings` and `cache_shardings` (batch 1 and batch >= dp) for all
10 full configs on the unbound production meshes (16 x 16 pod and
2 x 16 x 16 multipod), the reference's side on a `jax.sharding.
AbstractMesh` of `Auto` axes (no devices); the mesh context's rules; and
the new modules importing neither jax nor the reference."""
import subprocess
import sys

import jax
import pytest
from jax.sharding import AbstractMesh, AxisType

from repro.configs import get_config as rget
from repro.configs import list_archs
from repro.configs.shapes import SHAPES
from repro.dist.sharding import logical_to_spec as rlogical
from repro.dist.sharding import make_mesh_ctx as rctx
from repro.models.zoo import ModelBundle as RBundle
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.configs import get_config as tget
from repro_torch.dist.sharding import (Mesh, P, entry_axes, logical_to_spec,
                                       make_mesh_ctx)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import params as pm
from repro_torch.models.zoo import ModelBundle as TBundle

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def norm(spec):
    """A spec as a tuple of axis tuples (jax writes a one-axis tuple
    entry as the name)."""
    return tuple(entry_axes(e) for e in spec)


def ctxs(mesh):
    shape, axes = MESHES[mesh]
    ref = rctx(AbstractMesh(shape, axes, axis_types=(AxisType.Auto,)
                            * len(axes)))
    port = make_mesh_ctx(make_production_mesh(multi_pod=mesh == "multipod"))
    return ref, port


def leaves(tree):
    return [(n, norm(s.spec)) for n, s in flatten_with_paths(tree)]


def ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "name", k)))
                      for k in path), norm(s.spec)) for path, s in flat]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_shardings_match_the_reference(arch, mesh):
    rc, tc = ctxs(mesh)
    rb, tb = RBundle(rget(arch)), TBundle(tget(arch))
    assert tc.mesh.shape == dict(rc.mesh.shape)
    assert not tc.mesh.bound
    for serve in (False, True):
        ref = dict(ref_leaves(rb.param_shardings(rc, serve=serve)))
        got = dict(leaves(tb.param_shardings(tc, serve=serve)))
        assert got == ref, (arch, mesh, serve)
    # ParamDef.spec leaf by leaf, and the optimizer's tree
    rdefs = jax.tree_util.tree_leaves(
        rb.defs, is_leaf=lambda x: hasattr(x, "logical"))
    for rd, td in zip(rdefs, pm.tree_leaves(tb.defs)):
        assert norm(td.spec(tc)) == norm(rd.spec(rc))
    ro, to = rb.opt_shardings(rc), tb.opt_shardings(tc)
    assert norm(to.step.spec) == norm(ro.step.spec) == ()
    assert dict(leaves(to.m)) == dict(ref_leaves(ro.mu if hasattr(ro, "mu")
                                                 else ro.m))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_shardings_match_the_reference(arch, mesh):
    rc, tc = ctxs(mesh)
    rb, tb = RBundle(rget(arch)), TBundle(tget(arch))
    for shape, sh in SHAPES.items():
        for batch in (1, sh["batch"]):           # batch 1 drops dp
            ref = {k: norm(v.spec) for k, v in rb.batch_shardings(
                rc, seq=64, batch=batch, mode=sh["mode"]).items()}
            got = {k: norm(v.spec) for k, v in tb.batch_shardings(
                tc, seq=64, batch=batch, mode=sh["mode"]).items()}
            assert got == ref, (shape, batch)
            cache_len = min(sh["seq"], 4096)
            ref = dict(ref_leaves(rb.cache_shardings(
                rc, batch=batch, cache_len=cache_len)))
            got = dict(leaves(tb.cache_shardings(
                tc, batch=batch, cache_len=cache_len)))
            assert got == ref, (shape, batch)


def test_mesh_ctx_rules_match_the_reference():
    """make_mesh_ctx and logical_to_spec on the multipod mesh (the twin of
    `tests/test_sharding.py::test_multipod_mesh_axes`) and on meshes
    without a model or data axis."""
    for shape, axes in (((2, 2, 2), ("pod", "data", "model")),
                        ((8,), ("data",)), ((2, 4), ("data", "model")),
                        ((4,), ("model",))):
        rc = rctx(AbstractMesh(shape, axes,
                               axis_types=(AxisType.Auto,) * len(axes)))
        tc = make_mesh_ctx(Mesh(shape, axes))
        assert (tc.multi_pod, tc.dp, tc.tp, tc.dp_axes, tc.fsdp_axis,
                tc.tp_axis) == (rc.multi_pod, rc.dp, rc.tp, rc.dp_axes,
                                rc.fsdp_axis, rc.tp_axis)
        for logical in (("fsdp", "tp"), ("batch", None, "kv_len"),
                        ("unknown", "tp"), (None,)):
            assert logical_to_spec(tc, *logical) == tuple(
                rlogical(rc, *logical))
    tc = make_mesh_ctx(Mesh((2, 2, 2), ("pod", "data", "model")))
    assert tc.multi_pod and tc.dp == 4 and tc.tp == 2
    assert tc.dp_axes == ("pod", "data")
    assert repr(P("data", None)) == "P('data', None)"


def test_unbound_mesh_has_coordinates_only_when_bound():
    m = make_production_mesh(multi_pod=True)
    assert m.size == 512 and not m.bound
    with pytest.raises(RuntimeError):
        m.coords()
    with pytest.raises(RuntimeError):
        m.group("data")
    # row-major process layout, the first axis major
    assert m.coords(rank=17) == {"pod": 0, "data": 1, "model": 1}
    assert m.coords(rank=256) == {"pod": 1, "data": 0, "model": 0}
    with pytest.raises(ValueError):
        m.ordered(("model", "data"))


def test_sharding_modules_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.dist.sharding, repro_torch.dist.collectives\n"
            "import repro_torch.launch.mesh, repro_torch.launch.spawn\n"
            "import repro_torch.models.spmd, repro_torch.models.zoo\n"
            "import repro_torch.launch.train\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith"
            "('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
