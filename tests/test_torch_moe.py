"""The port's MoE family against the reference on carried-across weights.

``params_from_numpy`` carries the reference's ``granite-moe-1b-a400m``
smoke-config weights (2 layers, d_model 64, 4 experts top-2, float32)
into the port; inputs are made with numpy from a seed.  Tolerances, as in
``test_torch_models.py``: the MoE layer and its aux loss 1e-5; logits
and caches 2e-4 (another summation order over two layers and the vocab
projection).  Routing indices and the greedy tokens are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.launch import serve as R_serve
from repro.models import build_model as R_build_model
from repro.models import moe as R_moe
from repro.models import transformer as R_tf
from repro_torch import configs as T_configs
from repro_torch.kernels.moe_dispatch import kernel as dmod
from repro_torch.launch import serve as T_serve
from repro_torch.models import build_model, param_count
from repro_torch.models import moe as T_moe
from repro_torch.models import transformer as T_tf
from repro_torch.models.common import param_count_analytic
from repro_torch.models.convert import params_from_numpy

ARCH = "granite-moe-1b-a400m"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(want, got, tol):
    err = float(np.max(np.abs(_np(want) - got.float().numpy())))
    assert err < tol, err


@pytest.fixture(scope="module")
def setup():
    cfg_r = R_configs.get_smoke_config(ARCH)
    cfg_t = T_configs.get_smoke_config(ARCH)
    params_r = R_build_model(cfg_r).init(jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_r), cfg_t,
                                 device="cpu")
    return cfg_r, cfg_t, params_r, params_t


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _layer0(params_r):
    return jax.tree.map(lambda l: l[0], params_r["blocks"]["moe"])


def test_moe_params_carry_across(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    names = {n: tuple(p.shape) for n, p in params_t.named_parameters()}
    E, d, f = cfg_t.num_experts, cfg_t.d_model, cfg_t.moe_d_ff
    assert names["blocks.1.moe.router"] == (d, E)
    assert names["blocks.1.moe.w1"] == names["blocks.1.moe.w3"] == (E, d, f)
    assert names["blocks.1.moe.w2"] == (E, f, d)
    assert not any(".mlp." in n for n in names)
    assert param_count(params_t) == param_count_analytic(cfg_t)
    np.testing.assert_array_equal(
        params_t["blocks"][1]["moe"]["w2"].numpy(),
        np.asarray(params_r["blocks"]["moe"]["w2"][1]))
    # a bf16 model keeps the router in float32, as the reference does
    cfg16 = cfg_r.scaled(dtype="bfloat16")
    p16 = R_build_model(cfg16).init(jax.random.PRNGKey(1))
    t16 = params_from_numpy(jax.tree.map(np.asarray, p16),
                            cfg_t.scaled(dtype="bfloat16"), device="cpu")
    moe16 = t16["blocks"][0]["moe"]
    assert moe16["router"].dtype == torch.float32
    assert moe16["w1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        moe16["w1"].float().numpy(),
        np.asarray(p16["blocks"]["moe"]["w1"][0], np.float32))
    own = build_model(cfg_t.scaled(dtype="bfloat16"), device="cpu").init(0)
    assert own["blocks"][0]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("b,s", [(2, 9), (1, 1)])
def test_moe_ffn_matches_reference(setup, b, s):
    """(1, 1): one token, so two of the four experts get no rows."""
    cfg_r, cfg_t, params_r, params_t = setup
    x = np.random.default_rng(b * 10 + s).normal(
        size=(b, s, cfg_t.d_model)).astype(np.float32)
    pr = _layer0(params_r)
    pt = params_t["blocks"][0]["moe"]
    want, wst = R_moe.moe_ffn(pr, jnp.asarray(x), cfg_r)
    before = dmod.LAUNCHES
    got, st = T_moe.moe_ffn(pt, _t(x), cfg_t)
    assert dmod.LAUNCHES == before          # CPU: no kernel launch
    _close(want, got, 1e-5)
    _close(wst.aux_loss, st.aux_loss, 1e-5)
    assert float(st.dropped) == float(wst.dropped) == 0.0
    ri, rg, _ = R_moe._route(pr, jnp.asarray(x.reshape(-1, x.shape[-1])),
                             cfg_r)
    ti, tg, _ = T_moe._route(pt, _t(x.reshape(-1, x.shape[-1])), cfg_t)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    _close(rg, tg, 1e-6)
    # every mode is the dense path on one card
    got2, _ = T_moe.moe_ffn(pt, _t(x), cfg_t, mode="token_gather")
    assert torch.equal(got, got2)


def test_router_ties_go_to_the_lower_expert(setup):
    """A zero router gives every expert the same probability: lax.top_k
    and the port both pick experts 0..k-1 with equal gates."""
    cfg_r, cfg_t, _, _ = setup
    E, d = cfg_t.num_experts, cfg_t.d_model
    x = np.random.default_rng(5).normal(size=(6, d)).astype(np.float32)
    ri, rg, ra = R_moe._route({"router": jnp.zeros((d, E))},
                              jnp.asarray(x), cfg_r)
    ti, tg, ta = T_moe._route({"router": torch.zeros((d, E))}, _t(x), cfg_t)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert ti.tolist() == [list(range(cfg_t.experts_per_token))] * 6
    np.testing.assert_array_equal(tg.numpy(), np.asarray(rg))
    _close(ra, ta, 1e-6)


def test_forward_and_loss_match_reference(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    toks = _tokens(cfg_t, 2, 12, seed=8)
    want, waux = R_tf.forward(params_r, jnp.asarray(toks, jnp.int32), cfg_r)
    got, aux = T_tf.forward(params_t, _t(toks), cfg_t)
    assert got.shape == (2, 12, cfg_t.vocab_size)
    _close(want, got, 2e-4)
    assert float(aux) > 0.0
    _close(waux, aux, 1e-5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    wl, wm = R_build_model(cfg_r).loss(
        params_r, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    gl, gm = build_model(cfg_t, device="cpu").loss(
        params_t, {k: _t(v) for k, v in batch.items()})
    _close(wl, gl, 2e-5)
    _close(wm["aux_loss"], gm["aux_loss"], 1e-5)
    _close(wm["loss"], gm["loss"], 2e-5)


def test_prefill_and_decode_match_reference(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    b, s, n_gen = 2, 10, 4
    toks = _tokens(cfg_t, b, s + n_gen, seed=10)
    m_r = R_build_model(cfg_r)
    m_t = build_model(cfg_t, device="cpu")
    lg_r, c_r = m_r.prefill(params_r, {"tokens": jnp.asarray(
        toks[:, :s], jnp.int32)}, s + n_gen)
    lg_t, c_t = m_t.prefill(params_t, {"tokens": _t(toks[:, :s])}, s + n_gen)
    _close(lg_r, lg_t, 2e-4)
    assert c_t.k.shape == c_r.k.shape and c_t.pos == int(c_r.pos) == s
    _close(c_r.k, c_t.k, 2e-4)
    _close(c_r.v, c_t.v, 2e-4)
    for t in range(n_gen):
        tok = toks[:, s + t]
        lg_r, c_r = m_r.decode_step(params_r, c_r,
                                    jnp.asarray(tok, jnp.int32))
        lg_t, c_t = m_t.decode_step(params_t, c_t, _t(tok))
        _close(lg_r, lg_t, 2e-4)
    assert c_t.pos == int(c_r.pos) == s + n_gen
    _close(c_r.k, c_t.k, 2e-4)
    _close(c_r.v, c_t.v, 2e-4)


def test_greedy_tokens_match_reference(capsys):
    argv = ["--model-smoke", "--arch", ARCH, "--smoke", "--batch", "3",
            "--prompt-len", "10", "--gen", "6", "--seed", "4"]
    assert R_serve.main(argv) == 0
    ref_out = capsys.readouterr().out.splitlines()
    params = R_build_model(R_configs.get_smoke_config(ARCH)).init(
        jax.random.PRNGKey(4))
    args = T_serve.parse_args(argv + ["--device", "cpu"])
    run = T_serve.model_smoke(args, params=params_from_numpy(
        jax.tree.map(np.asarray, params), T_configs.get_smoke_config(ARCH),
        device="cpu"))
    assert run.generated.shape == (3, 6)
    assert ref_out[2] == f"generated: {run.generated[:2].tolist()}"
    assert T_serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[0].endswith(" ms for 3x10")


def test_collect_stats_reads_each_layers_stats(setup):
    """``collect_stats``: every MoE layer of a forward appends its stats in
    layer order, on the dense path and on the expert-parallel one under a
    mesh (where a prefill keeps only logits and caches); their aux losses
    add up to the forward's, an inner collector takes what runs inside
    it, and nothing is kept outside one."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import make_rules, use_rules
    _, cfg_t, _, params_t = setup
    tokens = _t(_tokens(cfg_t, 2, 8, 3))
    L = cfg_t.num_layers
    mesh = make_mesh((2, 2), ("data", "model"))
    with torch.no_grad():
        for rules in (None, make_rules(mesh)):
            with use_rules(rules, mesh if rules else None):
                with T_moe.collect_stats() as outer:
                    _, aux = T_tf.forward(params_t, tokens, cfg_t)
                    with T_moe.collect_stats() as inner:
                        T_tf.prefill(params_t, tokens, cfg_t, 8)
            assert len(outer) == len(inner) == L
            total = torch.zeros((), dtype=torch.float32)
            for st in outer:
                total = total + st.aux_loss
            assert torch.equal(total, aux)
            assert [float(s.aux_loss) for s in inner] == \
                [float(s.aux_loss) for s in outer]
            assert all(float(s.dropped) >= 0.0 for s in inner)
    T_tf.forward(params_t, tokens, cfg_t)   # no collector: nothing kept
    assert len(outer) == len(inner) == L
