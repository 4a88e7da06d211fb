"""The shape cells of the port (``repro_torch.configs.shapes``) against
the reference's (``repro.configs.shapes``), and the parameter counts the
dry run's model flops read (``ArchConfig.param_count`` /
``active_param_count``), for all 10 published configs.

``input_specs`` is compared at full width for every (config × cell):
each key, shape and dtype of the port's meta tensors equal to the
reference's ``ShapeDtypeStruct``s.  The decode cells' caches are mapped
leaf by leaf: the port's per-block list (prefix blocks first, then layer
p·period + i) onto the reference's ``prefix`` / ``periods`` tree, whose
period leaves are stacked on a leading n_periods axis.  Everything runs
on the meta device and under ``jax.eval_shape``: no weight is drawn.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_config
from repro.configs import shapes as jshapes
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes
from test_torch_hygiene import limit_torch_threads  # noqa: F401

CELLS = list(jshapes.SHAPES)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


def test_archs_and_cells_are_the_reference_s():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    assert list(shapes.SHAPES) == CELLS
    for name, cell in shapes.SHAPES.items():
        assert dataclasses.asdict(cell) == \
            dataclasses.asdict(jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", J_ARCHS)
def test_subquadratic_and_cell_applicable(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    assert cfg.subquadratic == jcfg.subquadratic
    assert [shapes.cell_applicable(cfg, c) for c in CELLS] == \
        [jshapes.cell_applicable(jcfg, c) for c in CELLS]


def _check_leaf(where, got: torch.Tensor, want) -> None:
    assert got.device.type == "meta", where
    assert tuple(got.shape) == tuple(want.shape), where
    assert got.dtype == DTYPES[str(want.dtype)], where


def _check_cache(cfg, got, want) -> None:
    """The port's per-block cache against the reference's tree."""
    first = len(cfg.prefix)
    assert len(got) == cfg.n_layers
    assert sorted(want) == (["periods", "prefix"] if first else ["periods"])
    for i in range(first):
        ref = want["prefix"][f"b{i}"]
        assert sorted(got[i]) == sorted(ref), i
        for k in ref:
            _check_leaf(f"prefix/b{i}/{k}", got[i][k], ref[k])
    for i in range(cfg.period):
        ref = want["periods"][f"b{i}"]
        for p in range(cfg.n_periods):
            blk = got[first + p * cfg.period + i]
            assert sorted(blk) == sorted(ref), (p, i)
            for k, leaf in ref.items():
                assert leaf.shape[0] == cfg.n_periods
                _check_leaf(f"periods/b{i}/{k}[{p}]", blk[k],
                            jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", J_ARCHS)
def test_input_specs_match_the_reference(arch, cell):
    """Every key, shape and dtype at full width (scale 1), the decode
    cells' caches leaf by leaf."""
    cfg, jcfg = get_config(arch), j_config(arch)
    got = shapes.input_specs(cfg, cell)
    want = jshapes.input_specs(jcfg, cell)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "cache":
            _check_cache(cfg, got[k], v)
        else:
            _check_leaf(k, got[k], v)


@pytest.mark.parametrize("scale", [32, 256, 1024])
def test_input_specs_scale_divides_the_batch(scale):
    cfg, jcfg = get_config("stablelm_1_6b"), j_config("stablelm_1_6b")
    for cell in CELLS:
        got = shapes.input_specs(cfg, cell, scale=scale)
        want = jshapes.input_specs(jcfg, cell, scale=scale)
        for k in ("tokens", "token", "pos", "labels"):
            if k in want:
                _check_leaf(k, got[k], want[k])


@pytest.mark.parametrize("arch", J_ARCHS)
def test_param_counts_match_the_reference(arch):
    """``param_count`` (a ``Model`` on meta) and ``active_param_count``
    (the reference's inactive-expert formula) exactly the reference's."""
    cfg, jcfg = get_config(arch), j_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
