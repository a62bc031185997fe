"""The port's vlm family (internvl2-1b) against the reference on
carried-across weights.

The reference initialises the parameters; ``params_from_numpy`` carries
them into the port (``patch_proj`` with them), so both packages compute
with identical weights on identical inputs (tokens and patch embeddings
made with numpy from a seed).  Smoke size: the ``internvl2-1b`` smoke
config (2 layers, d_model 56, 2/1 heads of 28, 4 patches, vocab 256,
float32).  Tolerances as ``tests/test_torch_models.py``: logits and caches
2e-4 (another summation order over two layers and the vocab projection),
the loss 2e-5, the port's own prefill/decode consistency 2e-3, as
``tests/test_decode_consistency.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.launch import serve as R_serve
from repro.models import build_model as R_build_model
from repro.models import transformer as R_tf
from repro.models.common import param_count as R_param_count
from repro.models.common import param_count_analytic as R_analytic
from repro_torch import configs as T_configs
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.launch import serve as T_serve
from repro_torch.models import build_model, param_count
from repro_torch.models import transformer as T_tf
from repro_torch.models.common import param_count_analytic
from repro_torch.models.convert import params_from_numpy

ARCH = "internvl2-1b"


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


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    patches = rng.normal(size=(b, cfg.num_patches, cfg.d_model)).astype(
        np.float32)
    return toks, patches


def test_parameters_carry_patch_proj(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    assert cfg_t.family == "vlm" and cfg_t.num_patches == 4
    names = dict(params_t.named_parameters())
    assert names["patch_proj"].shape == (cfg_t.d_model, cfg_t.d_model)
    np.testing.assert_array_equal(names["patch_proj"].numpy(),
                                  _np(params_r["patch_proj"]))
    assert param_count(params_t) == R_param_count(params_r)
    own = build_model(cfg_t, device="cpu").init(1)
    assert dict(own.named_parameters()).keys() == names.keys()


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_forward_matches_reference(setup, impl):
    cfg_r, cfg_t, params_r, params_t = setup
    toks, patches = _inputs(cfg_t, 2, 12, seed=8)
    want, _ = R_tf.forward(params_r, jnp.asarray(toks, jnp.int32),
                           cfg_r.scaled(attn_impl=impl),
                           patch_embeds=jnp.asarray(patches))
    before = fmod.LAUNCHES
    got, aux = T_tf.forward(params_t, _t(toks), cfg_t.scaled(attn_impl=impl),
                            patch_embeds=_t(patches))
    assert fmod.LAUNCHES == before          # CPU: no kernel launch
    assert got.shape == (2, cfg_t.num_patches + 12, cfg_t.vocab_size)
    _close(want, got, 2e-4)
    # the text positions depend on the patches
    plain, _ = T_tf.forward(params_t, _t(toks), cfg_t)
    assert plain.shape == (2, 12, cfg_t.vocab_size)
    assert float((plain - got[:, cfg_t.num_patches:]).abs().max()) > 1e-3


def test_loss_skips_patch_positions(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    toks, patches = _inputs(cfg_t, 2, 9, seed=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, _ = R_build_model(cfg_r).loss(params_r, {
        **{k: jnp.asarray(v, jnp.int32) for k, v in batch.items()},
        "patch_embeds": jnp.asarray(patches)})
    model = build_model(cfg_t, device="cpu")
    tb = {**{k: _t(v) for k, v in batch.items()},
          "patch_embeds": _t(patches)}
    got, metrics = model.loss(params_t, tb)
    _close(want, got, 2e-5)
    logits = model.forward(params_t, tb)[:, cfg_t.num_patches:]
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg_t.vocab_size), tb["labels"].reshape(-1))
    assert abs(float(nll) - float(got)) < 1e-5
    assert float(metrics["aux_loss"]) == 0.0


def test_prefill_and_decode_match_reference(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    b, s, n_gen, p = 2, 12, 4, cfg_t.num_patches
    toks, patches = _inputs(cfg_t, b, s + n_gen, seed=10)
    m_r, m_t = R_build_model(cfg_r), build_model(cfg_t, device="cpu")
    lg_r, c_r = m_r.prefill(params_r, {
        "tokens": jnp.asarray(toks[:, :s], jnp.int32),
        "patch_embeds": jnp.asarray(patches)}, s + n_gen + p)
    lg_t, c_t = m_t.prefill(params_t, {"tokens": _t(toks[:, :s]),
                                       "patch_embeds": _t(patches)},
                            s + n_gen + p)
    assert lg_t.shape == (b, p + s, cfg_t.vocab_size)
    _close(lg_r, lg_t, 2e-4)
    assert c_t.k.shape == c_r.k.shape and c_t.pos == int(c_r.pos) == p + s
    _close(c_r.k, c_t.k, 2e-4)
    _close(c_r.v, c_t.v, 2e-4)
    for t in range(n_gen):
        tok = toks[:, s + t]
        lg_r, c_r = m_r.decode_step(params_r, c_r,
                                    jnp.asarray(tok, jnp.int32))
        lg_t, c_t = m_t.decode_step(params_t, c_t, _t(tok))
        _close(lg_r, lg_t, 2e-4)
    assert c_t.pos == int(c_r.pos) == p + s + n_gen
    _close(c_r.k, c_t.k, 2e-4)


def test_prefill_decode_matches_forward(setup):
    """The port's own teacher-forced decode equals its forward pass, as
    ``tests/test_decode_consistency.py`` holds the reference."""
    cfg_r, cfg_t, params_r, params_t = setup
    model = build_model(cfg_t, device="cpu")
    b, s, n_gen, p = 2, 12, 4, cfg_t.num_patches
    toks, patches = _inputs(cfg_t, b, s + n_gen, seed=11)
    pe = _t(patches)
    full = model.forward(params_t, {"tokens": _t(toks), "patch_embeds": pe})
    logits_p, cache = model.prefill(
        params_t, {"tokens": _t(toks[:, :s]), "patch_embeds": pe},
        s + n_gen + p)
    err = [float((full[:, :p + s] - logits_p).abs().max())]
    for t in range(n_gen):
        lg, cache = model.decode_step(params_t, cache, _t(toks[:, s + t]))
        err.append(float((full[:, p + s + t] - lg).abs().max()))
    assert max(err) < 2e-3, err


def test_full_config_param_count():
    """internvl2-1b at full size: the reference's count, in the band of
    ``tests/test_models_smoke.py``; the shapes the card serves."""
    cfg = T_configs.get_config(ARCH)
    n = param_count_analytic(cfg)
    assert n == R_analytic(R_configs.get_config(ARCH))
    assert 0.4e9 <= n <= 1.0e9
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.hd, cfg.num_patches, cfg.param_dtype) == \
        (24, 896, 14, 2, 64, 256, torch.bfloat16)
    assert build_model(cfg, device="cpu").cfg is cfg


def test_greedy_tokens_match_reference(capsys):
    """``serve --model-smoke`` with the patch embeddings drawn as the
    reference draws them: the same greedy tokens."""
    argv = ["--model-smoke", "--arch", ARCH, "--smoke", "--batch", "2",
            "--prompt-len", "8", "--gen", "5", "--seed", "4"]
    assert R_serve.main(argv) == 0
    ref_out = capsys.readouterr().out.splitlines()
    cfg = T_configs.get_smoke_config(ARCH)
    params = R_build_model(R_configs.get_smoke_config(ARCH)).init(
        jax.random.PRNGKey(4))
    run = T_serve.model_smoke(
        T_serve.parse_args(argv + ["--device", "cpu"]),
        params=params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu"))
    assert run.batch["patch_embeds"].shape == (2, 4, cfg.d_model)
    assert run.logits.shape == (2, 4 + 8, cfg.vocab_size)
    assert run.cache.pos == 4 + 8 + 4
    assert ref_out[2] == f"generated: {run.generated[:2].tolist()}"
