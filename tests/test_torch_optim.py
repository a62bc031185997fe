"""The port's optimizers, schedules, clipping and int8 codec
(``repro_torch/optim/``) against the reference's.

The reference's six ``tests/test_optim.py`` cases run through both
packages on the same problem (made with numpy), and each step's updates
(and the clipped trees, schedules and codec outputs) agree within 1e-6.
Adafactor's are compared over its first 100 steps: by then the
quadratic's parameters lie at float32's floor (|b| ~ 1e-14 at step
100, exactly 0 by 150), where its normalized step turns on last-bit
differences of the two libraries' means and square roots (they part by
more than 1e-6 near step 217); both packages still converge.
The reference's int8 property case (``tests/test_property.py:63``) runs
through the port with the installed hypothesis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro.optim import compression as R_comp
from repro_torch import optim as T
from repro_torch.optim import compression as T_comp

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

TOL = 1e-6
W = np.asarray([1.0, -2.0, 3.0], np.float32)
B = np.asarray([[0.5, 0.5], [1.0, -1.0]], np.float32)


def _r_problem():
    params = {"w": jnp.asarray(W), "b": jnp.asarray(B)}

    def loss(p):
        return jnp.sum(p["w"] ** 2) + jnp.sum(p["b"] ** 2)
    return params, loss


def _t_problem():
    params = {"w": torch.from_numpy(W.copy()).requires_grad_(),
              "b": torch.from_numpy(B.copy()).requires_grad_()}

    def grad(p):
        loss = torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)
        g = torch.autograd.grad(loss, [p["w"], p["b"]])
        return {"w": g[0], "b": g[1]}, float(loss.detach())
    return params, grad


def _close(want, got, tol=TOL):
    err = float(np.max(np.abs(np.asarray(want, np.float32)
                              - got.detach().float().numpy())))
    assert err <= tol, err


def _run_both(r_opt, t_opt, steps, lr, compare=None):
    """The same descent through both packages, updates compared every
    step (the first ``compare`` steps when given); returns both final
    losses."""
    pr, loss = _r_problem()
    pt, grad = _t_problem()
    sr, s_t = r_opt.init(pr), t_opt.init(pt)
    for i in range(steps):
        g = jax.grad(loss)(pr)
        up_r, sr = r_opt.update(g, sr, pr, lr)
        pr = R.apply_updates(pr, up_r)
        gt, _ = grad(pt)
        up_t, s_t = t_opt.update(gt, s_t, pt, torch.tensor(lr))
        T.apply_updates(pt, up_t)
        if compare is not None and i >= compare:
            continue
        for k in ("w", "b"):
            _close(up_r[k], up_t[k])
            _close(pr[k], pt[k])
    return float(loss(pr)), grad(pt)[1]


def test_adamw_converges():
    r_loss, t_loss = _run_both(R.adamw(weight_decay=0.0),
                               T.adamw(weight_decay=0.0), 200, 0.05)
    assert t_loss < 1e-2 and r_loss < 1e-2


def test_adafactor_converges_and_is_factored():
    opt = T.adafactor()
    pt, _ = _t_problem()
    state = opt.init(pt)
    # factored second moment: 2-D leaf stores row+col, not full
    assert state.v_row["b"].shape == (2,)
    assert state.v_col["b"].shape == (2,)
    r_loss, t_loss = _run_both(R.adafactor(), T.adafactor(), 300, 0.05,
                               compare=100)
    assert t_loss < 1e-2 and r_loss < 1e-2


def test_adafactor_momentum_and_decay_match_reference():
    _run_both(R.adafactor(momentum=0.9, weight_decay=0.01),
              T.adafactor(momentum=0.9, weight_decay=0.01), 20, 0.05)


def test_adafactor_memory_is_sublinear():
    st_ = T.adafactor().init({"big": torch.zeros((128, 256))})
    factored = st_.v_row["big"].numel() + st_.v_col["big"].numel()
    assert factored == 128 + 256          # not 128*256


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 10.0)}
    clipped, norm = T.clip_by_global_norm(tree, 1.0)
    assert abs(float(T.global_norm(clipped)) - 1.0) < 1e-5
    assert abs(float(norm) - 20.0) < 1e-4
    tree2 = {"a": torch.full((4,), 0.1)}
    clipped2, _ = T.clip_by_global_norm(tree2, 1.0)
    np.testing.assert_allclose(clipped2["a"].numpy(), 0.1, rtol=1e-6)
    # against the reference on a tree of two leaves; a bf16 leaf keeps
    # its dtype
    r = np.random.default_rng(0)
    leaves = {"x": r.normal(size=(5, 3)).astype(np.float32),
              "y": r.normal(size=(7,)).astype(np.float32)}
    want, wn = R.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in leaves.items()}, 0.5)
    got, gn = T.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in leaves.items()}, 0.5)
    _close(wn, gn)
    for k in leaves:
        _close(want[k], got[k])
    bf = torch.ones(4, dtype=torch.bfloat16) * 3
    out, _ = T.clip_by_global_norm({"z": bf}, 1.0)
    assert out["z"].dtype == torch.bfloat16


def test_schedules():
    lw = T.linear_warmup(1.0, 10)
    assert float(lw(0)) < 0.2
    assert abs(float(lw(torch.tensor(100, dtype=torch.int32))) - 1.0) < 1e-6
    cw = T.cosine_warmup(1.0, 10, 100, min_ratio=0.1)
    assert float(cw(99)) <= float(cw(50))
    assert float(cw(9999)) >= 0.099
    for s in (0, 3, 9, 10, 50, 99, 150):
        step = jnp.int32(s)
        _close(R.cosine_warmup(3e-4, 10, 100)(step),
               T.cosine_warmup(3e-4, 10, 100)(s))
        _close(R.linear_warmup(3e-4, 10)(step), T.linear_warmup(3e-4, 10)(s))
        _close(R.constant(3e-4)(step), T.constant(3e-4)(s))
        assert T.cosine_warmup(3e-4, 10, 100)(s).dtype == torch.float32


def test_error_feedback_carries_residual():
    grads = {"w": torch.tensor([1.0, 1e-4, -1.0])}
    res = T_comp.init_residual(grads)
    qs, deq, res = T_comp.error_feedback_compress(grads, res)
    # residual holds what quantization lost; next round recovers it
    assert float(torch.max(torch.abs(deq["w"] + res["w"] - grads["w"]))
                 ) < 1e-6
    want_qs, want_deq, want_res = R_comp.error_feedback_compress(
        {"w": jnp.asarray(grads["w"].numpy())},
        R_comp.init_residual({"w": jnp.zeros(3)}))
    np.testing.assert_array_equal(np.asarray(want_qs["w"][0]),
                                  qs["w"][0].numpy())
    _close(want_qs["w"][1], qs["w"][1])
    _close(want_deq["w"], deq["w"])
    _close(want_res["w"], res["w"])


def test_error_feedback_scales_a_stacked_leaf_as_one():
    """The port's per-layer tensors of one reference leaf (``blocks.0.w``,
    ``blocks.1.w``: the reference's stacked ``blocks/w``) share that
    leaf's scale, so the int8 values equal the reference's over the
    stacked leaf."""
    rng = np.random.default_rng(3)
    w0 = rng.normal(size=(3, 4)).astype(np.float32)
    w1 = 10 * rng.normal(size=(3, 4)).astype(np.float32)
    e = rng.normal(size=(5,)).astype(np.float32)
    grads = {"blocks.0.w": torch.from_numpy(w0),
             "blocks.1.w": torch.from_numpy(w1), "embed": torch.from_numpy(e)}
    qs, deq, res = T_comp.error_feedback_compress(
        grads, T_comp.init_residual(grads))
    r_grads = {"blocks": {"w": jnp.asarray(np.stack([w0, w1]))},
               "embed": jnp.asarray(e)}
    want_qs, want_deq, want_res = R_comp.error_feedback_compress(
        r_grads, R_comp.init_residual(r_grads))
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(want_qs["blocks"]["w"][0])[i],
            qs[f"blocks.{i}.w"][0].numpy())
        _close(want_qs["blocks"]["w"][1], qs[f"blocks.{i}.w"][1])
        _close(np.asarray(want_deq["blocks"]["w"])[i], deq[f"blocks.{i}.w"])
        _close(np.asarray(want_res["blocks"]["w"])[i], res[f"blocks.{i}.w"])
    np.testing.assert_array_equal(np.asarray(want_qs["embed"][0]),
                                  qs["embed"][0].numpy())


@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=1,
                max_size=128))
@settings(max_examples=30, deadline=None)
def test_int8_compression_error_bound(vals):
    """The reference's ``tests/test_property.py`` int8 case, through the
    port; the codes equal the reference's."""
    x = torch.tensor(vals, dtype=torch.float32)
    q, s = T_comp.compress_int8(x)
    deq = T_comp.decompress_int8(q, s)
    amax = float(torch.max(torch.abs(x)))
    assert float(torch.max(torch.abs(deq - x))) <= max(amax / 127.0, 1e-9)
    rq, rs = R_comp.compress_int8(jnp.asarray(vals, jnp.float32))
    np.testing.assert_array_equal(np.asarray(rq), q.numpy())
    assert q.dtype == torch.int8


def test_apply_updates_adds_in_the_param_dtype_in_place():
    p = {"a": torch.tensor([1.0, 2.0], dtype=torch.bfloat16)}
    u = {"a": torch.tensor([1e-3, -0.3], dtype=torch.float32)}
    want = R.apply_updates({"a": jnp.asarray([1.0, 2.0], jnp.bfloat16)},
                           {"a": jnp.asarray([1e-3, -0.3], jnp.float32)})
    before = p["a"]
    T.apply_updates(p, u)
    assert p["a"] is before and p["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(want["a"], np.float32),
                                  p["a"].float().numpy())
    cast = T.cast_state({"m": torch.ones(2)}, torch.bfloat16)
    assert cast["m"].dtype == torch.bfloat16


def test_optimizers_take_a_model_tree():
    """A Params module is read by its dotted parameter names."""
    from repro_torch.models.common import Params
    mod = Params(a=torch.ones(2, 3), sub=Params(b=torch.zeros(4)))
    for opt in (T.adamw(), T.adafactor()):
        state = opt.init(mod)
        names = set(T.named_tree(mod))
        assert names == {"a", "sub.b"}
        leaves = state.m if hasattr(state, "v") else state.v_row
        assert set(leaves) == names
        grads = {k: torch.ones_like(v) for k, v in T.named_tree(mod).items()}
        ups, state = opt.update(grads, state, mod, torch.tensor(0.1))
        assert int(state.count) == 1 and set(ups) == names
