"""The port's sharding rules and mesh planner against the JAX package's,
with no devices: ``param_specs``, ``cache_specs`` and ``batch_specs`` of
``repro_torch.models.sharding`` equal ``repro.models.sharding``'s for
every leaf of the reference's ``jax.eval_shape`` trees on a
``jax.sharding.AbstractMesh``, and ``plan_shape`` equals the
reference's.  A ``PartitionSpec`` is compared as ``tuple(spec)``, the
form the port's specs take.  ``shard_leaf`` is checked here to tile the
whole tensor over every rank's coordinates; ``gather_leaf`` (which runs
collectives) round-trips it in ``tests/test_torch_train_mesh.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_config as jcfg_full
from repro.configs import get_smoke_config as jcfg
from repro.distributed.elastic import plan_shape as j_plan_shape
from repro.models import sharding as jsh
from repro.models.model import init_cache, init_params
from repro_torch.configs import get_config as tcfg_full
from repro_torch.configs import get_smoke_config as tcfg
from repro_torch.distributed import plan_shape
from repro_torch.distributed.mesh import Mesh
from repro_torch.models import sharding as tsh
from repro_torch.models.model import init_model
from test_torch_hygiene import limit_torch_threads  # noqa: F401

MESHES = [(1, 1), (2, 1), (1, 2), (1, 4), (2, 2), (2, 4), (4, 2)]


def _abstract(data, model, pod=1):
    if pod > 1:
        return AbstractMesh((pod, data, model), ("pod", "data", "model"))
    return AbstractMesh((data, model), ("data", "model"))


def _path_key(path):
    return tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


def _by_path(tree):
    """{port path: ShapeDtypeStruct} of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_key(p): leaf for p, leaf in flat}


def _ref_specs(tree_of_specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree_of_specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {_path_key(p): tuple(s) for p, s in flat}


def _param_shapes(cfg):
    return jax.eval_shape(lambda: init_params(cfg, jax.random.key(0)))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_param_specs_match_reference_stablelm(mesh, fsdp, full):
    """stablelm-1.6b, its published widths and its smoke config, on
    every mesh, with and without ``fsdp_params``."""
    cj = (jcfg_full if full else jcfg)("stablelm-1.6b")
    ct = (tcfg_full if full else tcfg)("stablelm-1.6b")
    cj = dataclasses.replace(cj, fsdp_params=fsdp)
    ct = dataclasses.replace(ct, fsdp_params=fsdp)
    shapes = _param_shapes(cj)
    am = _abstract(*mesh)
    want = _ref_specs(jsh.param_specs(cj, shapes, am))
    got = tsh.param_specs(ct, _by_path(shapes), am)
    assert got == want


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b", "xlstm-350m",
                                  "granite-20b"])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 2)])
def test_param_specs_match_reference_other_leaves(arch, mesh):
    """The MoE experts' 3-D leaves (deepseek, jamba), MLA, the MTP
    block's leaves (deepseek-v3), Mamba and xLSTM leaves and
    ``fsdp_params`` as these configs set it: the rules
    are pure, whether or not the port runs the block yet.  The port's
    rules read only the leaf's path, its shape and ``fsdp_params``."""
    cj = jcfg(arch)
    ct = dataclasses.replace(tcfg("stablelm-1.6b"),
                             fsdp_params=cj.fsdp_params)
    shapes = _param_shapes(cj)
    am = _abstract(*mesh)
    want = _ref_specs(jsh.param_specs(cj, shapes, am))
    got = tsh.param_specs(ct, _by_path(shapes), am)
    assert got == want
    if arch == "deepseek-v2-236b":
        assert any(len(s) == 4 and s[-1] == "model" for s in got.values())


@pytest.mark.parametrize("mesh", MESHES)
def test_param_specs_on_the_port_model_tree(mesh):
    """The port's own tree (``Model.stacked_shapes``) has the
    reference's paths and shapes, so the specs key alike."""
    ct = tcfg("stablelm-1.6b")
    model = init_model(ct, seed=0, device="cpu")
    shapes = model.stacked_shapes()
    ref = {k: tuple(v.shape)
           for k, v in _by_path(_param_shapes(jcfg("stablelm-1.6b"))).items()}
    assert shapes == ref
    am = _abstract(*mesh)
    assert tsh.param_specs(ct, shapes, am) == _ref_specs(
        jsh.param_specs(jcfg("stablelm-1.6b"),
                        _param_shapes(jcfg("stablelm-1.6b")), am))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "xlstm-350m",
                                  "jamba-v0.1-52b", "deepseek-v2-236b"])
@pytest.mark.parametrize("batch", [1, 4, 6])
@pytest.mark.parametrize("mesh", [(1, 1), (2, 2), (1, 4), (4, 2)])
def test_cache_specs_match_reference(arch, batch, mesh):
    cj = jcfg(arch)
    cache = jax.eval_shape(lambda: init_cache(cj, batch, 32))
    am = _abstract(*mesh)
    want = _ref_specs(jsh.cache_specs(cj, cache, am, batch))
    got = tsh.cache_specs(tcfg("stablelm-1.6b"), _by_path(cache), am, batch)
    assert got == want


@pytest.mark.parametrize("has_pod", [False, True])
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("mesh", MESHES)
def test_batch_specs_match_reference(mesh, batch, has_pod):
    am = _abstract(*mesh, pod=2) if has_pod else _abstract(*mesh)
    want = {k: tuple(v) for k, v in jsh.batch_specs(
        jcfg("stablelm-1.6b"), am, batch, has_pod).items()}
    got = tsh.batch_specs(tcfg("stablelm-1.6b"), am, batch, has_pod)
    assert got == want


@pytest.mark.parametrize("model_divides", [None, 4, 32])
@pytest.mark.parametrize("max_model", [1, 2, 4, 16])
def test_plan_shape_matches_reference(max_model, model_divides):
    for n in range(1, 17):
        assert plan_shape(n, max_model=max_model,
                          model_divides=model_divides) == j_plan_shape(
            n, max_model=max_model, model_divides=model_divides), n


@pytest.mark.parametrize("spec,axes", [
    ((None, "model"), {"data": 2, "model": 4}),
    (("model", None), {"data": 2, "model": 2}),
    (("data", "model"), {"data": 2, "model": 4}),
    ((None, ("data", "model")), {"data": 2, "model": 2}),
    ((("pod", "data"), None, "model"), {"pod": 2, "data": 2, "model": 2}),
    ((None, None), {"data": 4, "model": 1}),
])
def test_shard_leaf_blocks_tile_the_tensor(spec, axes):
    """Every rank's block, put back at its coordinates, rebuilds the
    whole tensor bit for bit, each element once per replica (the ranks
    that differ only on the axes the spec does not name)."""
    shape = (8,) * len(spec)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32))
    world = int(np.prod(list(axes.values())))
    seen = torch.zeros(shape, dtype=torch.int32)
    out = torch.zeros(shape)
    for r in range(world):
        mesh = Mesh(axes, rank=r)
        blk = tsh.shard_leaf(x, spec, mesh)
        idx = []
        for d, a in enumerate(spec):
            w = blk.shape[d]
            i = tsh._block_index(mesh, a) if a is not None else 0
            idx.append(slice(i * w, (i + 1) * w))
        out[tuple(idx)] = blk
        seen[tuple(idx)] += 1
        assert tsh.global_shape(blk.shape, spec, mesh) == shape
    replicas = world // int(np.prod([tsh.axis_size(axes, a)
                                     for a in spec if a is not None]))
    assert torch.equal(out, x) and bool((seen == replicas).all())


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2},
                                  {"data": 1, "model": 4},
                                  {"pod": 2, "data": 2, "model": 2}])
def test_dp_axes_match_reference(axes):
    from repro.launch.mesh import dp_axes as j_dp_axes
    from repro_torch.distributed.mesh import planning_mesh
    from repro_torch.launch.mesh import dp_axes
    am = AbstractMesh(tuple(axes.values()), tuple(axes))
    assert dp_axes(planning_mesh(axes)) == j_dp_axes(am)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_a_tpu_shape(multi_pod):
    """The reference's production mesh is a TPU pod shape: the port
    raises, naming it, rather than building another."""
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(NotImplementedError, match="TPU pod shape"):
        make_production_mesh(multi_pod=multi_pod)
