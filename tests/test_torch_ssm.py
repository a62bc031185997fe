"""The port's selective-SSM block (``models/ssm.py``) against the
reference on carried-across weights.

The reference initialises ``hymba-1.5b``'s smoke config (d_model 80,
n = 8, chunk 8, float32); ``params_from_numpy`` carries the weights into
the port, with ``dt_bias`` drawn from a seed so that softplus sees more
than zeros.  Inputs are made with numpy from a seed.  Both of the port's
scan routes are held to the reference: ``"chunked"`` (the reference's own
scan, the CPU default) and ``"kernel"`` (the CUDA kernel's call, which on
the CPU takes its plain version).  Tolerance 1e-5 in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import build_model as R_build_model
from repro.models import ssm as R_ssm
from repro_torch import configs as T_configs
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.models import ssm as T_ssm
from repro_torch.models.convert import params_from_numpy

ARCH = "hymba-1.5b"
TOL = 1e-5
IMPLS = ["chunked", "kernel"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(want, got, tol=TOL):
    err = float(np.max(np.abs(_np(want) - got.float().numpy())))
    assert err < tol, err


@pytest.fixture(scope="module")
def setup():
    cfg_r = R_configs.get_smoke_config(ARCH)
    cfg_t = T_configs.get_smoke_config(ARCH)
    tree = jax.tree.map(np.array, R_build_model(cfg_r).init(
        jax.random.PRNGKey(0)))
    ssm = tree["blocks"]["ssm"]
    ssm["dt_bias"] = np.random.default_rng(1).normal(
        size=ssm["dt_bias"].shape).astype(np.float32) * 0.5
    params_t = params_from_numpy(tree, cfg_t, device="cpu")
    pr = jax.tree.map(lambda l: jnp.asarray(l[0]), ssm)
    return cfg_r, cfg_t, pr, params_t["blocks"][0]["ssm"]


def _x(cfg, b, s, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
            * scale).astype(np.float32)


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    di = cfg.d_model * max(cfg.ssm_expand, 1)
    return (rng.normal(size=(b, cfg.ssm_conv - 1, di)).astype(np.float32),
            (rng.normal(size=(b, di, cfg.ssm_state)) * 0.3).astype(
                np.float32))


def test_init_ssm_shapes_and_dtypes():
    """A bf16 model: the matrices in bf16, dt_bias / a_log / d_skip in
    float32 (the reference's init), also when carried across."""
    cfg_r = R_configs.get_config(ARCH).scaled(num_layers=1, d_model=64,
                                              vocab_size=64)
    cfg_t = T_configs.get_config(ARCH).scaled(num_layers=1, d_model=64,
                                              vocab_size=64)
    want = jax.eval_shape(lambda: R_ssm.init_ssm(jax.random.PRNGKey(0),
                                                 cfg_r))
    gen = torch.Generator().manual_seed(0)
    own = T_ssm.init_ssm(gen, cfg_t)
    tree = jax.tree.map(np.array, R_build_model(cfg_r).init(
        jax.random.PRNGKey(0)))
    carried = params_from_numpy(tree, cfg_t, device="cpu")[
        "blocks"][0]["ssm"]
    f32 = ("dt_bias", "a_log", "d_skip")
    assert set(dict(own.named_parameters())) == set(want)
    for name, leaf in want.items():
        for p in (own, carried):
            assert tuple(p[name].shape) == leaf.shape, name
            assert p[name].dtype == (torch.float32 if name in f32
                                     else torch.bfloat16), name
        assert str(leaf.dtype) == ("float32" if name in f32
                                   else "bfloat16")
    n, di = cfg_t.ssm_state, cfg_t.d_model
    assert own["in_proj"].shape == (64, 2 * di)
    assert own["x_proj"].shape == (di, 2 * n + 1)
    assert torch.equal(own["dt_bias"], torch.zeros(di))
    assert torch.equal(own["d_skip"], torch.ones(di))
    a_log = tree["blocks"]["ssm"]["a_log"][0]       # log(1..n) per row
    np.testing.assert_array_equal(carried["a_log"].numpy(), a_log)
    # torch's and XLA's log may differ in the last bit
    np.testing.assert_allclose(own["a_log"].numpy(), a_log, rtol=2e-7,
                               atol=0)


def test_scan_routes():
    assert T_ssm.resolve_scan_impl("cpu") == "chunked"
    assert T_ssm.resolve_scan_impl("cuda") == "kernel"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("s", [1, 8, 33, 100])
@pytest.mark.parametrize("stateful", [False, True], ids=["h0=0", "h0"])
def test_ssm_scan_matches_reference(setup, impl, s, stateful):
    """S not a multiple of the chunk (8): the padded tail of the
    reference's last chunk is the identity on the state."""
    cfg_r, cfg_t, pr, pt = setup
    xc = _x(cfg_t, 2, s, seed=s, scale=0.5)
    h0 = _state(cfg_t, 2, seed=s + 1)[1] if stateful else None
    want_y, want_h = R_ssm.ssm_scan(
        pr, jnp.asarray(xc), cfg_r,
        h0=None if h0 is None else jnp.asarray(h0))
    before = smod.LAUNCHES
    y, h = T_ssm.ssm_scan(pt, torch.from_numpy(xc), cfg_t,
                          h0=None if h0 is None else torch.from_numpy(h0),
                          impl=impl)
    assert smod.LAUNCHES == before            # CPU: no kernel launch
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(want_y, y)
    _close(want_h, h)


def test_unknown_scan_impl_raises(setup):
    _, cfg_t, _, pt = setup
    with pytest.raises(ValueError, match="kernel"):
        T_ssm.ssm_scan(pt, torch.zeros((1, 2, cfg_t.d_model)), cfg_t,
                       impl="pallas")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("stateful", [False, True],
                         ids=["stateless", "stateful"])
def test_ssm_block_matches_reference(setup, impl, stateful):
    cfg_r, cfg_t, pr, pt = setup
    x = _x(cfg_t, 2, 19, seed=3)
    state_r = state_t = None
    if stateful:
        conv, h = _state(cfg_t, 2, seed=4)
        state_r = R_ssm.SSMState(conv=jnp.asarray(conv), h=jnp.asarray(h))
        state_t = T_ssm.SSMState(conv=torch.from_numpy(conv),
                                 h=torch.from_numpy(h))
    want, wst = R_ssm.ssm_block(pr, jnp.asarray(x), cfg_r, state=state_r)
    got, st = T_ssm.ssm_block(pt, torch.from_numpy(x), cfg_t,
                              state=state_t, impl=impl)
    _close(want, got)
    if not stateful:
        assert st is None and wst is None
        return
    _close(wst.conv, st.conv)
    _close(wst.h, st.h)
    assert st.conv.shape == (2, cfg_t.ssm_conv - 1, cfg_t.d_model)
    assert st.h.dtype == torch.float32


@pytest.mark.parametrize("impl", IMPLS)
def test_token_by_token_equals_one_pass(setup, impl):
    """The prompt run one token at a time with the carried state gives
    the one-pass outputs and final state (decode vs prefill)."""
    _, cfg_t, _, pt = setup
    x = torch.from_numpy(_x(cfg_t, 2, 13, seed=5))
    st0 = T_ssm.init_ssm_state(cfg_t, 2)
    full, st_full = T_ssm.ssm_block(pt, x, cfg_t, state=st0, impl=impl)
    st = st0
    outs = []
    for t in range(x.shape[1]):
        y, st = T_ssm.ssm_block(pt, x[:, t:t + 1], cfg_t, state=st,
                                impl=impl)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=TOL)
    torch.testing.assert_close(st.h, st_full.h, rtol=0, atol=TOL)
    torch.testing.assert_close(st.conv, st_full.conv, rtol=0, atol=TOL)
