"""The port's logical-axis rules (``repro_torch/sharding``) against the
reference's: ``tests/test_sharding_rules.py``'s four cases through both
packages (the port's specs, plain tuples, equal the reference's
``PartitionSpec``s), ``make_rules`` and ``data_only_rules`` on 1-, 2- and
3-axis meshes, the models' ``logical_axes`` for all ten configs and
``constrain``.

The reference's rule builders read only ``mesh.shape``, so its side
takes a stand-in mesh of any size in this 1-device process."""
import types

import pytest
import torch
from jax.sharding import PartitionSpec as R_P

from repro.configs import ARCH_IDS
from repro.configs import get_config as R_get_config
from repro.models import build_model as R_build_model
from repro.sharding import Rules as R_Rules
from repro.sharding import data_only_rules as R_data_only_rules
from repro.sharding import make_rules as R_make_rules
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.sharding import (P, Rules, active, constrain,
                                  data_only_rules, make_rules, use_rules)

MESHES = [((8,), ("data",)), ((4, 2), ("data", "model")),
          ((2, 4, 2), ("pod", "data", "model")), ((1, 8), ("data", "model")),
          ((2, 2), ("pod", "data"))]
LOGICAL = ["batch", "seq", "embed", "embed_pod", "heads", "kv", "hd", "ff",
           "experts", "expert_ff", "vocab", "kv_seq", "layers", "conv",
           "state", None]


def _mesh_shape():
    return {"data": 4, "model": 2}


def _both(table, logical, dims):
    """(the reference's spec, the port's) for one rule table."""
    r = R_Rules(table=table, mesh_shape=_mesh_shape())
    t = Rules(table=table, mesh_shape=_mesh_shape())
    return r.spec_for(logical, dims=dims), t.spec_for(logical, dims=dims)


def _same(ref_spec, port_spec):
    assert isinstance(port_spec, P) and isinstance(port_spec, tuple)
    assert tuple(port_spec) == tuple(ref_spec), (port_spec, ref_spec)


def test_divisible_dims_shard():
    want, got = _both({"heads": "model", "embed": "data"},
                      ("embed", "heads"), (8, 6))
    _same(want, got)
    assert got == P("data", "model") and want == R_P("data", "model")


def test_indivisible_dims_replicate():
    for dims in ((25,), (26,)):
        _same(*_both({"heads": "model"}, ("heads",), dims))
    t = Rules(table={"heads": "model"}, mesh_shape=_mesh_shape())
    assert t.spec_for(("heads",), dims=(25,)) == P(None)
    assert t.spec_for(("heads",), dims=(26,)) == P("model")


def test_mesh_axis_used_once():
    want, got = _both({"a": "model", "b": "model"}, ("a", "b"), (4, 4))
    _same(want, got)
    assert got == P("model", None)


def test_tuple_axes():
    for dims in ((8,), (6,)):
        _same(*_both({"batch": ("data", "model")}, ("batch",), dims))
    t = Rules(table={"batch": ("data", "model")}, mesh_shape=_mesh_shape())
    assert t.spec_for(("batch",), dims=(8,)) == P(("data", "model"))
    assert t.spec_for(("batch",), dims=(6,)) == P(None)


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("kind", ["make_rules", "make_rules no fsdp/seq",
                                  "data_only_rules"])
def test_rule_sets_match_reference(shape, axes, kind):
    """Every logical axis's spec, alone and paired, at divisible and
    indivisible sizes, from the port's rule set and the reference's on
    the same mesh."""
    mesh = make_mesh(shape, axes)
    stand_in = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    if kind == "make_rules":
        t, r = make_rules(mesh), R_make_rules(stand_in)
    elif kind == "data_only_rules":
        t, r = data_only_rules(mesh), R_data_only_rules(stand_in)
    else:
        t = make_rules(mesh, fsdp=False, seq_shard=False)
        r = R_make_rules(stand_in, fsdp=False, seq_shard=False)
    assert t.table == r.table and t.mesh_shape == r.mesh_shape
    for a in LOGICAL:
        for b in LOGICAL:
            for dims in ((64, 48), (25, 7), (16, 3)):
                _same(r.spec_for((a, b), dims=dims),
                      t.spec_for((a, b), dims=dims))
        _same(r.spec_for((a,)), t.spec_for((a,)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_match_reference(arch):
    """``Model.logical_axes()`` (and so every ``*_logical_axes``) equals
    the reference's tree, leaf for leaf, for all ten configs."""
    def norm(x):
        return {k: norm(v) for k, v in x.items()} if isinstance(x, dict) \
            else tuple(x)

    want = norm(R_build_model(R_get_config(arch)).logical_axes())
    got = build_model(get_config(arch), device="cpu").logical_axes()
    assert got == want


def test_production_meshes_need_no_device_count():
    """The reference raises without 256 / 512 devices; the port's meshes
    are logical shards on one device."""
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",))


def test_constrain_is_a_checked_no_op():
    x = torch.zeros(4, 6, 8)
    assert constrain(x, "batch", "seq", None) is x      # no rules active
    mesh = make_mesh((4, 2), ("data", "model"))
    with use_rules(make_rules(mesh), mesh):
        assert active()[1] is mesh
        assert constrain(x, "batch", "seq", "ff") is x
        with pytest.raises(ValueError, match="rank"):
            constrain(x, "batch", "seq", "ff", None)
    assert active() == (None, None)
