"""The port's dense LM stack against the reference on carried-across
weights.

The reference initialises the parameters; ``params_from_numpy`` carries
them into the port, so both packages compute with identical weights on
identical inputs (all made with numpy from a seed).  Smoke size: the
``llama3.2-1b`` smoke config (2 layers, d_model 64, 4/2 heads, vocab 256,
float32).  Tolerances: layers 1e-5; logits and caches 2e-4 (another
summation order over two layers and the vocab projection); the port's own
prefill/decode consistency 2e-3, as ``tests/test_decode_consistency.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import attention as R_attn
from repro.models import build_model as R_build_model
from repro.models import layers as R_layers
from repro.models import transformer as R_tf
from repro.models.common import param_count as R_param_count
from repro_torch import configs as T_configs
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.models import attention as T_attn
from repro_torch.models import build_model, param_count
from repro_torch.models import layers as T_layers
from repro_torch.models import transformer as T_tf
from repro_torch.models.common import (active_param_count,
                                       param_count_analytic, trunc_normal)
from repro_torch.models.convert import params_from_numpy

ARCH = "llama3.2-1b"


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
    tree = jax.tree.map(np.asarray, params_r)
    params_t = params_from_numpy(tree, cfg_t, device="cpu")
    return cfg_r, cfg_t, params_r, params_t, tree


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# -- configs and parameters ---------------------------------------------------

@pytest.mark.parametrize("arch", R_configs.ARCH_IDS)
def test_configs_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        r = getattr(R_configs, get)(arch)
        t = getattr(T_configs, get)(arch)
        assert dataclasses.asdict(r) == dataclasses.asdict(t)
    cfg_r, cfg_t = R_configs.get_config(arch), T_configs.get_config(arch)
    from repro.models import common as R_common
    assert param_count_analytic(cfg_t) == \
        R_common.param_count_analytic(cfg_r)
    assert active_param_count(cfg_t) == R_common.active_param_count(cfg_r)


def test_llama_full_config_is_1_24b_params():
    cfg = T_configs.get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.hd, cfg.d_ff, cfg.vocab_size) == \
        (16, 2048, 32, 8, 64, 8192, 128256)
    assert cfg.param_dtype == torch.bfloat16
    assert param_count_analytic(cfg) == 1_235_814_400


def test_parameter_names_follow_reference_paths(setup):
    cfg_r, cfg_t, params_r, params_t, tree = setup
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(cfg_t.num_layers):
                name = ".".join(["blocks", str(i)] + keys[1:])
                want[name] = tuple(leaf.shape[1:])
        else:
            want[".".join(keys)] = tuple(leaf.shape)
    got = {n: tuple(p.shape) for n, p in params_t.named_parameters()}
    assert got == want
    assert "blocks.1.attn.wq" in got and "embed.table" in got
    assert got["blocks.0.attn.wo"] == (cfg_t.num_heads, cfg_t.hd,
                                       cfg_t.d_model)
    assert param_count(params_t) == R_param_count(params_r)


def test_trunc_normal_is_truncated_and_scaled():
    g = torch.Generator().manual_seed(0)
    x = trunc_normal(g, (256, 64), torch.float32)
    std = 1 / 16
    assert x.dtype == torch.float32 and x.shape == (256, 64)
    assert float(x.abs().max()) <= 2 * std + 1e-7
    assert 0.8 * std < float(x.std()) < 0.95 * std   # truncated: ~0.88
    y = trunc_normal(torch.Generator().manual_seed(0), (256, 64),
                     torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.allclose(
        y.float(), x, atol=std * 2 ** -8)


def test_model_init_is_seeded_and_on_device():
    cfg = T_configs.get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    a, b = model.init(3), model.init(3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
        assert p.device.type == "cpu" and not p.requires_grad
    assert param_count(a) == param_count_analytic(cfg)


# -- layers -------------------------------------------------------------------

def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 7)).astype(np.int32)
    for theta in (10000.0, 500000.0):
        want = R_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        _close(want, T_layers.apply_rope(_t(x), _t(pos), theta), 1e-5)
        np.testing.assert_allclose(
            T_layers.rope_freqs(16, theta).numpy(),
            _np(R_layers.rope_freqs(16, theta)), rtol=2e-7)


@pytest.mark.parametrize("arch", [ARCH, "whisper-base"])
def test_mlp_matches_reference(arch):
    """SwiGLU (llama) and the GELU branch (whisper's MLP)."""
    cfg_r = R_configs.get_smoke_config(arch)
    cfg_t = T_configs.get_smoke_config(arch)
    p = jax.tree.map(np.asarray, R_layers.init_mlp(jax.random.PRNGKey(1),
                                                    cfg_r))
    if cfg_t.use_gelu:       # non-zero biases, so they are exercised
        rng = np.random.default_rng(2)
        p = dict(p, b1=rng.normal(size=p["b1"].shape).astype(np.float32),
                 b2=rng.normal(size=p["b2"].shape).astype(np.float32))
    x = np.random.default_rng(3).normal(
        size=(2, 5, cfg_t.d_model)).astype(np.float32)
    want = R_layers.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              cfg_r)
    got = T_layers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), cfg_t)
    _close(want, got, 1e-5)


def test_norms_and_cross_entropy_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    p = {"scale": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    pj = jax.tree.map(jnp.asarray, p)
    pt = {k: _t(v) for k, v in p.items()}
    _close(R_layers.apply_layernorm(pj, jnp.asarray(x)),
           T_layers.apply_layernorm(pt, _t(x)), 1e-5)
    _close(R_layers.apply_rmsnorm(pj, jnp.asarray(x)),
           T_layers.apply_rmsnorm(pt, _t(x)), 1e-5)
    _close(R_layers.apply_rmsnorm(pj, jnp.asarray(x)),
           T_layers.apply_rmsnorm(pt, _t(x), use_kernel=True), 1e-5)
    labels = rng.integers(0, 32, (3, 5))
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = R_layers.cross_entropy(
            jnp.asarray(x), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = T_layers.cross_entropy(_t(x), _t(labels),
                                     None if m is None else _t(m))
        _close(want, got, 1e-5)


# -- attention ----------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_self_attention_matches_reference(setup, impl):
    cfg_r, cfg_t, params_r, params_t, tree = setup
    pa = jax.tree.map(lambda l: l[0], params_r["blocks"]["attn"])
    x = np.random.default_rng(5).normal(
        size=(2, 12, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    want, (wk, wv) = R_attn.self_attention(
        pa, jnp.asarray(x), jnp.asarray(pos), cfg_r, impl=impl,
        return_kv=True)
    got, (gk, gv) = T_attn.self_attention(
        params_t["blocks"][0]["attn"], _t(x), _t(pos), cfg_t, impl=impl,
        return_kv=True)
    _close(want, got, 1e-5)
    _close(wk, gk, 1e-5)
    _close(wv, gv, 1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_chunked_attention_matches_reference(window):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(1, 4, 20, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, 20, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, 20, 16)).astype(np.float32)
    want = R_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True, window, chunk=8,
                                    kv_len=jnp.asarray(17))
    got = T_attn.chunked_attention(_t(q), _t(k), _t(v), True, window,
                                   chunk=8, kv_len=17)
    _close(want, got, 1e-5)


def test_resolve_impl():
    cfg = T_configs.get_config(ARCH)
    assert cfg.attn_impl == "auto"
    assert T_attn.resolve_impl(cfg, 2048, "cuda") == "pallas"
    assert T_attn.resolve_impl(cfg, 2048, "cuda:0") == "pallas"
    assert T_attn.resolve_impl(cfg, 2048, "cpu") == "ref"
    assert T_attn.resolve_impl(cfg, 2049, "cpu") == "chunked"
    assert T_attn.resolve_impl(cfg.scaled(attn_impl="chunked"), 8,
                               "cuda") == "chunked"


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_matches_reference(setup, window):
    """Full cache and ring buffer, across the point where the ring
    wraps."""
    cfg_r, cfg_t, params_r, params_t, tree = setup
    pa = jax.tree.map(lambda l: l[0], params_r["blocks"]["attn"])
    rng = np.random.default_rng(7)
    c_r = R_attn.init_kv_cache(cfg_r, 2, 10, window=window or None)
    c_t = T_attn.init_kv_cache(cfg_t, 2, 10, window=window or None,
                               device="cpu")
    for step in range(9):
        x = rng.normal(size=(2, 1, cfg_t.d_model)).astype(np.float32)
        y_r, c_r = R_attn.decode_attention(pa, jnp.asarray(x), c_r, cfg_r)
        y_t, c_t = T_attn.decode_attention(params_t["blocks"][0]["attn"],
                                           _t(x), c_t, cfg_t)
        _close(y_r, y_t, 1e-5)
        assert int(c_r.pos) == c_t.pos == step + 1
    _close(c_r.k, c_t.k, 1e-5)
    _close(c_r.v, c_t.v, 1e-5)


# -- the whole model ----------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_forward_matches_reference(setup, impl):
    cfg_r, cfg_t, params_r, params_t, tree = setup
    toks = _tokens(cfg_t, 2, 12, seed=8)
    want, _ = R_tf.forward(params_r, jnp.asarray(toks, jnp.int32),
                           cfg_r.scaled(attn_impl=impl))
    before = fmod.LAUNCHES
    got, aux = T_tf.forward(params_t, _t(toks), cfg_t.scaled(attn_impl=impl))
    assert fmod.LAUNCHES == before          # CPU: no kernel launch
    assert got.shape == (2, 12, cfg_t.vocab_size)
    assert float(aux) == 0.0
    _close(want, got, 2e-4)


def test_loss_matches_reference(setup):
    cfg_r, cfg_t, params_r, params_t, tree = setup
    toks = _tokens(cfg_t, 2, 9, seed=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, _ = R_build_model(cfg_r).loss(
        params_r, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    got, metrics = build_model(cfg_t, device="cpu").loss(
        params_t, {k: _t(v) for k, v in batch.items()})
    _close(want, got, 2e-5)
    assert float(metrics["aux_loss"]) == 0.0


def test_prefill_and_decode_match_reference(setup):
    cfg_r, cfg_t, params_r, params_t, tree = setup
    b, s, n_gen = 2, 12, 4
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
        lg_r, c_r = m_r.decode_step(params_r, c_r, jnp.asarray(tok,
                                                               jnp.int32))
        lg_t, c_t = m_t.decode_step(params_t, c_t, _t(tok))
        _close(lg_r, lg_t, 2e-4)
    assert c_t.pos == int(c_r.pos) == s + n_gen
    _close(c_r.k, c_t.k, 2e-4)
    _close(c_r.v, c_t.v, 2e-4)


def test_prefill_decode_matches_forward(setup):
    """The port's own teacher-forced decode equals its forward pass, as
    ``tests/test_decode_consistency.py`` holds the reference."""
    cfg_r, cfg_t, params_r, params_t, tree = setup
    model = build_model(cfg_t, device="cpu")
    b, s, n_gen = 2, 12, 4
    toks = _t(_tokens(cfg_t, b, s + n_gen, seed=11))
    full = model.forward(params_t, {"tokens": toks})
    logits_p, cache = model.prefill(params_t, {"tokens": toks[:, :s]},
                                    s + n_gen)
    err = [float((full[:, :s] - logits_p).abs().max())]
    for t in range(n_gen):
        lg, cache = model.decode_step(params_t, cache, toks[:, s + t])
        err.append(float((full[:, s + t] - lg).abs().max()))
    assert max(err) < 2e-3, err


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "hymba-1.5b",
                                  "xlstm-1.3b", "whisper-base",
                                  "internvl2-1b"])
def test_other_families_build(arch):
    cfg = T_configs.get_smoke_config(arch)
    assert build_model(cfg, device="cpu").cfg is cfg


def test_an_unknown_family_does_not_build():
    cfg = T_configs.get_smoke_config(ARCH).scaled(family="rwkv")
    with pytest.raises(NotImplementedError, match="'rwkv'"):
        build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="'rwkv'"):
        params_from_numpy({}, cfg, device="cpu")


#: Each block family's layer kinds, (mixer, feed-forward), by layer.
LAYER_KINDS = {
    "dense": lambda i: ("attention", "mlp"),
    "vlm": lambda i: ("attention", "mlp"),
    "moe": lambda i: ("attention", "moe"),
    "hybrid": lambda i: ("hybrid", "mlp"),
    # jamba2-mini's periods: attention at i % 8 == 4, the MoE at odd i
    "jamba": lambda i: ("attention" if i % 8 == 4 else "mamba",
                        "moe" if i % 2 else "mlp"),
}
#: The parameter groups each kind puts in a block.
KIND_GROUPS = {"attention": {"attn"},
               "hybrid": {"attn", "ssm", "norm_a", "norm_s"},
               "mamba": {"mamba"}, "mlp": {"mlp"}, "moe": {"moe"}}
BLOCK_ARCHS = [a for a in T_configs.ARCH_IDS + T_configs.EXTRA_ARCH_IDS
               if T_configs.get_smoke_config(a).family in LAYER_KINDS]


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_each_block_holds_what_its_layer_kinds_name(arch):
    cfg = T_configs.get_smoke_config(arch)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    assert kinds == [LAYER_KINDS[cfg.family](i)
                     for i in range(cfg.num_layers)]
    params = build_model(cfg, device="cpu").init(0)
    assert len(params["blocks"]) == cfg.num_layers
    for (mixer, ffn), block in zip(kinds, params["blocks"]):
        assert {n for n, _ in block.named_children()} == \
            {"norm1", "norm2"} | KIND_GROUPS[mixer] | KIND_GROUPS[ffn]


def test_entry_points_default_to_cuda():
    cfg = T_configs.get_smoke_config(ARCH)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
