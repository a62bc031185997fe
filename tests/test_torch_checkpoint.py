"""The port's checkpoint manager (``repro_torch/checkpoint/manager.py``):
the reference's five manager cases of ``tests/test_checkpoint.py``
(roundtrip, retention, async flush, a missing checkpoint, no ``.tmp``
left), and checkpoints carried across packages.  The sixth case,
``shardings_for_params``, runs on the reference's config and on
multi-axis meshes, where the port's specs equal the reference's.

The port restores in place into the state it is given, so a roundtrip
is held to a copy taken before the restore, restored into a fresh state
of another seed.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as R_CheckpointManager
from repro.models import build_model as R_build_model
from repro.models.common import ModelConfig as R_ModelConfig
from repro.optim import adamw as R_adamw
from repro.train import init_train_state as R_init_train_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw, named_tree
from repro_torch.train import init_train_state

KW = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=2,
          num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
          remat=False)
CFG = ModelConfig(**KW)


def _state(seed=0, cfg=CFG):
    return init_train_state(build_model(cfg, device="cpu"), adamw(), seed)


def _leaves(state):
    out = {f"params.{k}": v for k, v in named_tree(state.params).items()}
    for name in ("m", "v"):
        out.update({f"{name}.{k}": v for k, v in
                    getattr(state.opt_state, name).items()})
    out["count"] = state.opt_state.count
    out["step"] = state.step
    return {k: v.detach().clone() for k, v in out.items()}


def _trained(seed=0):
    """A state whose moments, count and step are not zero."""
    state = _state(seed)
    g = {k: torch.full_like(p, 0.5) for k, p in
         named_tree(state.params).items()}
    _, opt = adamw().update(g, state.opt_state, state.params,
                            torch.tensor(1e-3))
    return state._replace(opt_state=opt, step=state.step + 3)


def _assert_equal(want, state):
    got = _leaves(state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_roundtrip(tmp_path):
    state = _trained()
    want = _leaves(state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, state, blocking=True)
    fresh = _state(seed=1)
    got = mgr.restore(fresh)
    assert got is fresh
    _assert_equal(want, got)


def test_latest_and_retention(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    assert mgr.latest_step() == 4
    steps = sorted(mgr.latest_steps())
    assert steps == [3, 4]               # keep-last-2 enforced


def test_async_save_then_restore(tmp_path):
    state = _trained()
    want = _leaves(state)
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(7, state)          # async
    mgr.wait()
    assert mgr.latest_step() == 7
    _assert_equal(want, mgr.restore(_state(seed=2), step=7))


def test_missing_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())


def test_no_tmp_dirs_left(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_layout_and_keys_are_the_references(tmp_path):
    """The same files, flattened key names and stacked [L, ...] leaves as
    the reference's manager writes for the same model."""
    R_cfg = R_ModelConfig(**KW)
    r_state = R_init_train_state(R_build_model(R_cfg), R_adamw(),
                                 jax.random.PRNGKey(0))
    R_CheckpointManager(str(tmp_path / "ref")).save(3, r_state,
                                                    blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(3, _state(),
                                                   blocking=True)
    manifests = [json.load(open(tmp_path / d / "step_00000003" /
                                "manifest.json")) for d in ("ref", "port")]
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert "params/blocks/attn/wq" in manifests[1]["keys"]
    assert manifests[1]["keys"]["params/blocks/attn/wq"][0] == [2, 32, 2,
                                                                16]
    for d in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / d / "step_00000003")) == [
            "arrays.npz", "manifest.json"]


def test_reference_f32_checkpoint_restores_in_the_port(tmp_path):
    R_cfg = R_ModelConfig(**KW)
    r_state = R_init_train_state(R_build_model(R_cfg), R_adamw(),
                                 jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda p: jax.numpy.full(p.shape, 0.25),
                         r_state.params)
    _, opt = R_adamw().update(grads, r_state.opt_state, r_state.params,
                              1e-3)
    r_state = r_state._replace(opt_state=opt, step=r_state.step + 4)
    R_CheckpointManager(str(tmp_path)).save(4, r_state, blocking=True)

    state = CheckpointManager(str(tmp_path)).restore(_state(seed=3))
    tree = jax.tree.map(np.asarray, r_state.params)
    want = named_tree(params_from_numpy(tree, CFG, device="cpu"))
    got = named_tree(state.params)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    m_tree = jax.tree.map(np.asarray, r_state.opt_state.m)
    want_m = named_tree(params_from_numpy(m_tree, CFG, device="cpu"))
    for k in want_m:
        assert torch.equal(state.opt_state.m[k], want_m[k]), k
    assert int(state.opt_state.count) == 1 and int(state.step) == 4


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _trained(seed=4)
    CheckpointManager(str(tmp_path)).save(3, state, blocking=True)
    R_cfg = R_ModelConfig(**KW)
    like = R_init_train_state(R_build_model(R_cfg), R_adamw(),
                              jax.random.PRNGKey(9))
    got = R_CheckpointManager(str(tmp_path)).restore(like)
    back = named_tree(params_from_numpy(jax.tree.map(np.asarray, got.params),
                                       CFG, device="cpu"))
    for k, p in named_tree(state.params).items():
        assert torch.equal(back[k], p.detach()), k
    assert int(got.step) == 3 and int(got.opt_state.count) == 1


def test_bfloat16_state_roundtrips_exactly(tmp_path):
    cfg = ModelConfig(**{**KW, "dtype": "bfloat16"})
    state = _state(cfg=cfg)
    want = _leaves(state)
    assert want["params.embed.table"].dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, blocking=True)
    meta = json.load(open(tmp_path / "step_00000002" / "manifest.json"))
    assert meta["keys"]["params/embed/table"][1] == "bfloat16"
    _assert_equal(want, mgr.restore(_state(seed=5, cfg=cfg)))


def test_restore_rejects_a_mismatched_state(tmp_path):
    CheckpointManager(str(tmp_path)).save(1, _state(), blocking=True)
    other = _state(cfg=ModelConfig(**{**KW, "d_model": 48}))
    with pytest.raises(ValueError, match="has shape"):
        CheckpointManager(str(tmp_path)).restore(other)


def test_reference_bfloat16_checkpoint_restores_in_the_port(tmp_path):
    """The reference writes a bf16 leaf as a 2-byte void array (its
    numpy type is ml_dtypes'); the port reads its bits back exactly."""
    kw = {**KW, "dtype": "bfloat16"}
    r_state = R_init_train_state(R_build_model(R_ModelConfig(**kw)),
                                 R_adamw(), jax.random.PRNGKey(0))
    R_CheckpointManager(str(tmp_path)).save(1, r_state, blocking=True)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as data:
        assert data["params__embed__table"].dtype.kind == "V"
    cfg = ModelConfig(**kw)
    state = CheckpointManager(str(tmp_path)).restore(_state(seed=6,
                                                            cfg=cfg))
    want = named_tree(params_from_numpy(
        jax.tree.map(np.asarray, r_state.params), cfg, device="cpu"))
    for k, p in named_tree(state.params).items():
        assert p.dtype == torch.bfloat16 and torch.equal(p, want[k]), k


def _reference_specs(r_model, r_params, rules_of, mesh):
    """The reference's spec of every stacked leaf, by its key."""
    from repro.checkpoint import shardings_for_params as R_shardings
    sh = R_shardings(r_params, r_model.logical_axes(), mesh, rules_of(mesh))
    return {"/".join(str(k.key) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(
                sh, is_leaf=lambda t: hasattr(t, "spec"))}


def test_shardings_for_params_divisibility():
    """Elastic restore builds divisibility-safe shardings from logical
    axes (the N->M mesh rescale path): every spec's sharded dims divide
    the parameter's, on the reference's (1, 1) mesh and on meshes whose
    axes do not divide every parameter; each spec is the reference's for
    the stacked leaf without its leading ``"layers"`` entry (the
    reference's specs on the larger meshes through its rules on a
    stand-in mesh: a 1-device process builds no such jax mesh)."""
    import types

    from repro import compat
    from repro.sharding import make_rules as R_make_rules
    from repro_torch.checkpoint import shardings_for_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import make_rules

    model = build_model(CFG, device="cpu")
    params = model.init(0)
    r_model = R_build_model(R_ModelConfig(**KW))
    r_params = r_model.init(jax.random.PRNGKey(0))
    for shape in ((1, 1), (4, 2), (3, 5)):
        mesh = make_mesh(shape, ("data", "model"))
        sh = shardings_for_params(params, model.logical_axes(), mesh,
                                  make_rules(mesh))
        assert set(sh) == set(named_tree(params))
        for name, p in named_tree(params).items():
            for dim, ax in zip(p.shape, tuple(sh[name].spec) + (None,) * 8):
                if ax is not None:
                    assert dim % mesh.shape[ax] == 0, (name, shape)
        r_mesh = compat.make_mesh(shape, ("data", "model")) \
            if shape == (1, 1) else types.SimpleNamespace(
                shape=dict(mesh.shape))
        if shape == (1, 1):
            want = _reference_specs(r_model, r_params, R_make_rules, r_mesh)
        else:
            rules = R_make_rules(r_mesh)
            axes = jax.tree.leaves(r_model.logical_axes(),
                                   is_leaf=lambda t: isinstance(t, tuple))
            want = {"/".join(str(k.key) for k in path): tuple(
                        rules.spec_for(ax, dims=leaf.shape))
                    for (path, leaf), ax in zip(
                        jax.tree_util.tree_leaves_with_path(r_params), axes)}
        for name, s in sh.items():
            key = "/".join(p for p in name.split(".") if not p.isdigit())
            stacked = key.count("/") != name.count(".")
            w = want[key][1:] if stacked else want[key]
            assert _trimmed(s.spec) == _trimmed(w), (name, s.spec, w)


def test_shardings_for_logical_axes_match_reference():
    """``elastic.shardings_for`` (no shapes: no divisibility check) maps a
    logical-axes tree to the reference's specs, leaf for leaf."""
    from repro import compat
    from repro.checkpoint.elastic import shardings_for as R_shardings_for
    from repro.sharding import make_rules as R_make_rules
    from repro_torch.checkpoint.elastic import shardings_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import make_rules

    axes = build_model(CFG, device="cpu").logical_axes()
    r_mesh = compat.make_mesh((1, 1), ("data", "model"))
    want = R_shardings_for(R_build_model(R_ModelConfig(**KW)).logical_axes(),
                           r_mesh, R_make_rules(r_mesh))
    mesh = make_mesh((1, 1), ("data", "model"))
    got = shardings_for(axes, mesh, make_rules(mesh))

    def walk(w, g):
        if isinstance(g, dict):
            assert set(w) == set(g)
            for k in g:
                walk(w[k], g[k])
        else:
            assert tuple(g.spec) == tuple(w.spec) and g.mesh is mesh

    walk(want, got)


def _trimmed(spec):
    """A spec without its trailing Nones (the same layout)."""
    t = tuple(spec)
    while t and t[-1] is None:
        t = t[:-1]
    return t
