"""The port's xLSTM family (``models/xlstm.py`` and the ``ssm`` parts of
``models/transformer.py``) against the reference on carried-across
weights.

The reference initialises the parameters; ``params_from_numpy`` carries
them into the port, so both packages compute with identical weights on
identical inputs (made with numpy from a seed).  Smoke size: the
``xlstm-1.3b`` smoke config (4 blocks in units of 1 mLSTM + 1 sLSTM,
d_model 64, 2 heads, chunk 8, vocab 256, float32).  States and logits
within 1e-4 in f32 (another summation order through the chunked form
and the vocab projection).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import build_model as R_build_model
from repro.models import transformer as R_tf
from repro.models import xlstm as R_xlstm
from repro_torch import configs as T_configs
from repro_torch.models import build_model
from repro_torch.models import transformer as T_tf
from repro_torch.models import xlstm as T_xlstm
from repro_torch.models.convert import params_from_numpy

ARCH = "xlstm-1.3b"
TOL = 1e-4


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(want, got, tol=TOL):
    err = float(np.max(np.abs(_np(want) - got.detach().float().numpy())))
    assert err < tol, err


@pytest.fixture(scope="module")
def setup():
    cfg_r = R_configs.get_smoke_config(ARCH)
    cfg_t = T_configs.get_smoke_config(ARCH)
    params_r = R_build_model(cfg_r).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params_r)
    params_t = params_from_numpy(tree, cfg_t, device="cpu")
    return cfg_r, cfg_t, params_r, params_t


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _states(cls, st):
    return {f: np.asarray(getattr(st, f)) for f in cls._fields}


def test_unit_shape_and_param_names_follow_the_reference(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    assert T_tf._xlstm_unit_shape(cfg_t) == R_tf._xlstm_unit_shape(cfg_r)
    full_r, full_t = R_configs.get_config(ARCH), T_configs.get_config(ARCH)
    assert T_tf._xlstm_unit_shape(full_t) == R_tf._xlstm_unit_shape(
        full_r) == (7, 6)
    names = {n for n, _ in params_t.named_parameters()}
    assert "xlstm.m_blocks.0.0.core.wq" in names
    assert "xlstm.s_blocks.1.core.rz" in names
    # mLSTM gate projections and both f_bias stay f32 in a bf16 model
    own = build_model(cfg_t.scaled(dtype="bfloat16"), device="cpu").init(0)
    m = own["xlstm"]["m_blocks"][0][0]["core"]
    s = own["xlstm"]["s_blocks"][0]["core"]
    assert m["wi"].dtype == m["f_bias"].dtype == torch.float32
    assert m["wq"].dtype == s["wi"].dtype == torch.bfloat16
    assert s["f_bias"].dtype == torch.float32
    n_r = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params_r))
    assert n_r == sum(p.numel() for p in params_t.parameters())
    assert sum(p.numel() for p in own.parameters()) == n_r


@pytest.mark.parametrize("s", [16, 13])
def test_mlstm_block_matches_reference(setup, s):
    """13 pads the last chunk of 8."""
    cfg_r, cfg_t, params_r, params_t = setup
    x = _x(cfg_t, 2, s)
    pr = jax.tree.map(lambda l: l[0, 0], params_r["xlstm"]["m_blocks"])
    pt = params_t["xlstm"]["m_blocks"][0][0]
    st_r = R_xlstm.init_mlstm_state(cfg_r, 2)
    st_t = T_xlstm.init_mlstm_state(cfg_t, 2)
    want, wst = R_xlstm.mlstm_block(pr["core"], jnp.asarray(x), cfg_r,
                                    state=st_r)
    got, gst = T_xlstm.mlstm_block(pt["core"], torch.from_numpy(x), cfg_t,
                                   state=st_t)
    _close(want, got)
    for f in T_xlstm.MLSTMState._fields:
        _close(getattr(wst, f), getattr(gst, f))
    # stateless: no state back
    y, none = T_xlstm.mlstm_block(pt["core"], torch.from_numpy(x), cfg_t)
    assert none is None
    _close(want, y)


@pytest.mark.parametrize("s", [8, 5])
def test_slstm_block_matches_reference(setup, s):
    cfg_r, cfg_t, params_r, params_t = setup
    x = _x(cfg_t, 2, s, seed=2)
    pr = jax.tree.map(lambda l: l[1], params_r["xlstm"]["s_blocks"])
    pt = params_t["xlstm"]["s_blocks"][1]
    want, wst = R_xlstm.slstm_block(pr["core"], jnp.asarray(x), cfg_r,
                                    state=R_xlstm.init_slstm_state(cfg_r, 2))
    got, gst = T_xlstm.slstm_block(pt["core"], torch.from_numpy(x), cfg_t,
                                   state=T_xlstm.init_slstm_state(cfg_t, 2))
    _close(want, got)
    for f in T_xlstm.SLSTMState._fields:
        _close(getattr(wst, f), getattr(gst, f))


@pytest.mark.parametrize("s", [16, 13])
def test_forward_matches_reference(setup, s):
    cfg_r, cfg_t, params_r, params_t = setup
    toks = _tokens(cfg_t, 2, s)
    want, aux = R_tf.forward(params_r, jnp.asarray(toks), cfg_r)
    with torch.no_grad():
        got, aux_t = T_tf.forward(params_t, torch.from_numpy(toks), cfg_t)
    _close(want, got)
    assert float(aux_t) == float(aux) == 0.0


def test_prefill_ssm_and_four_decode_steps_match_reference(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    toks = _tokens(cfg_t, 2, 13, seed=3)
    lr, cr = R_tf.prefill_ssm(params_r, jnp.asarray(toks), cfg_r)
    model = build_model(cfg_t, device="cpu")
    with torch.no_grad():
        lt, ct = model.prefill(params_t, {"tokens": torch.from_numpy(toks)},
                               None)
    _close(lr, lt)
    assert [c.kind for c in ct] == [c.kind for c in cr]
    tok = np.argmax(_np(lr)[:, -1], -1)
    for _ in range(4):
        lr, cr = R_tf.decode_step(params_r, cr, jnp.asarray(tok), cfg_r)
        with torch.no_grad():
            lt, ct = model.decode_step(params_t, ct, torch.from_numpy(tok))
        _close(lr, lt)
        tok = np.argmax(_np(lr), -1)
    for c_r, c_t in zip(cr, ct):
        st_r, st_t = (c_r.mls, c_t.mls) if c_r.kind == "mlstm" else \
            (c_r.sls, c_t.sls)
        for f in type(st_t)._fields:
            _close(getattr(st_r, f), getattr(st_t, f))


def test_init_cache_matches_reference(setup):
    cfg_r, cfg_t, _, _ = setup
    want = R_tf.init_cache(cfg_r, 3, 32)
    got = T_tf.init_cache(cfg_t, 3, 32, device="cpu")
    assert [c.kind for c in got] == [c.kind for c in want]
    for c_r, c_t in zip(want, got):
        st_r, st_t = (c_r.mls, c_t.mls) if c_r.kind == "mlstm" else \
            (c_r.sls, c_t.sls)
        for f in type(st_t)._fields:
            assert tuple(getattr(st_t, f).shape) == getattr(st_r, f).shape
            np.testing.assert_array_equal(getattr(st_t, f).numpy(),
                                          np.asarray(getattr(st_r, f)))


def test_all_mlstm_stack_matches_reference():
    """slstm_every past the depth: one flat list of mLSTM blocks."""
    cfg_r = R_configs.get_smoke_config(ARCH).scaled(slstm_every=0,
                                                    num_layers=3)
    cfg_t = T_configs.get_smoke_config(ARCH).scaled(slstm_every=0,
                                                    num_layers=3)
    params_r = R_build_model(cfg_r).init(jax.random.PRNGKey(1))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_r), cfg_t,
                                 device="cpu")
    assert len(params_t["xlstm"]["m_blocks"]) == 3
    toks = _tokens(cfg_t, 2, 11, seed=4)
    want, _ = R_tf.forward(params_r, jnp.asarray(toks), cfg_r)
    with torch.no_grad():
        got, _ = T_tf.forward(params_t, torch.from_numpy(toks), cfg_t)
    _close(want, got)


def test_remat_gives_the_same_loss_and_gradients(setup):
    """``remat`` recomputes each unit in the backward
    (``torch.utils.checkpoint``): the same loss and gradients."""
    _, cfg_t, _, params_t = setup
    toks = _tokens(cfg_t, 2, 12, seed=5)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    params_t.trainable()
    try:
        out = []
        for remat in (False, True):
            model = build_model(cfg_t.scaled(remat=remat), device="cpu")
            loss, _ = model.loss(params_t, batch)
            grads = torch.autograd.grad(loss, list(params_t.parameters()))
            out.append((loss.detach(), grads))
    finally:
        params_t.trainable(False)
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
        assert float(b.abs().max()) > 0
