"""The port's audio family (whisper-base, ``models/encdec.py``) against
the reference on carried-across weights.

The reference initialises the parameters; ``params_from_numpy`` carries
its encdec tree (``enc_layers``, ``dec_layers``, ``ln_x``,
``cross_attn``, ``enc_ln``, ``dec_ln``) into the port, so both packages
compute with identical weights on identical inputs (tokens and encoder
frames made with numpy from a seed).  Smoke size: the ``whisper-base``
smoke config (2 + 2 layers, d_model 64, 4 heads of 16, 16 frames, vocab
256, float32).  Tolerances as ``tests/test_torch_models.py``: the encoder
memory 1e-5 and logits and caches 2e-4 (another summation order over the
layers and the vocab projection), the loss 2e-5, the port's own
prefill/decode consistency 2e-3, as ``tests/test_decode_consistency.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.launch import serve as R_serve
from repro.models import build_model as R_build_model
from repro.models import encdec as R_ed
from repro.models.common import param_count as R_param_count
from repro.models.common import param_count_analytic as R_analytic
from repro_torch import configs as T_configs
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.launch import serve as T_serve
from repro_torch.models import attention as T_attn
from repro_torch.models import build_model, param_count
from repro_torch.models import encdec as T_ed
from repro_torch.models.common import param_count_analytic
from repro_torch.models.convert import params_from_numpy

ARCH = "whisper-base"


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
    # non-zero LayerNorm biases and MLP biases, so they are exercised
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.1 * rng.normal(size=a.shape).astype(a.dtype)
                         if path[-1].key in ("bias", "b1", "b2") else a),
        tree)
    params_r = jax.tree.map(jnp.asarray, tree)
    params_t = params_from_numpy(tree, cfg_t, device="cpu")
    return cfg_r, cfg_t, params_r, params_t, tree


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    frames = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return toks, frames


def test_parameter_names_follow_reference_paths(setup):
    cfg_r, cfg_t, params_r, params_t, tree = setup
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] in ("enc_layers", "dec_layers"):
            n = cfg_t.encoder_layers if keys[0] == "enc_layers" else \
                cfg_t.num_layers
            for i in range(n):
                want[".".join([keys[0], str(i)] + keys[1:])] = \
                    tuple(leaf.shape[1:])
        else:
            want[".".join(keys)] = tuple(leaf.shape)
    got = {n: tuple(p.shape) for n, p in params_t.named_parameters()}
    assert got == want
    assert "dec_layers.1.cross_attn.wq" in got and "enc_ln.bias" in got
    assert param_count(params_t) == R_param_count(params_r)
    own = build_model(cfg_t, device="cpu").init(2)
    assert {n for n, _ in own.named_parameters()} == set(got)


@pytest.mark.parametrize("d", [64, 512])
def test_sinusoid_matches_reference(d):
    """Equal to 1e-6 over the smoke config's 16 positions.  Over
    whisper's 1,500 encoder positions the two libraries' float32 ``exp``
    (neither correctly rounded) give some frequencies one ulp apart, which
    moves the angle at position p by up to p * freq * 2**-24: 1.5e-4 at
    p = 1,499 and freq 1 (sin and cos have slope at most 1)."""
    for pos, tol in ((np.arange(16), 1e-6), (np.arange(0, 1500, 7), 1.5e-4)):
        _close(R_ed.sinusoid(jnp.asarray(pos), d),
               T_ed.sinusoid(_t(pos), d), tol)


def test_encode_matches_reference(setup):
    cfg_r, cfg_t, params_r, params_t, tree = setup
    _, frames = _inputs(cfg_t, 2, 1, seed=3)
    want = R_ed.encode(params_r, jnp.asarray(frames), cfg_r)
    got = T_ed.encode(params_t, _t(frames), cfg_t)
    assert got.shape == (2, cfg_t.encoder_seq, cfg_t.d_model)
    _close(want, got, 1e-5)


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_forward_matches_reference(setup, impl):
    cfg_r, cfg_t, params_r, params_t, tree = setup
    toks, frames = _inputs(cfg_t, 2, 12, seed=4)
    want = R_build_model(cfg_r.scaled(attn_impl=impl)).forward(
        params_r, {"tokens": jnp.asarray(toks, jnp.int32),
                   "frames": jnp.asarray(frames)})
    before = fmod.LAUNCHES
    got = build_model(cfg_t.scaled(attn_impl=impl), device="cpu").forward(
        params_t, {"tokens": _t(toks), "frames": _t(frames)})
    assert fmod.LAUNCHES == before          # CPU: no kernel launch
    assert got.shape == (2, 12, cfg_t.vocab_size)
    _close(want, got, 2e-4)


def test_loss_matches_reference(setup):
    cfg_r, cfg_t, params_r, params_t, tree = setup
    toks, frames = _inputs(cfg_t, 2, 9, seed=5)
    mask = (np.random.default_rng(6).random((2, 8)) < 0.7).astype(
        np.float32)
    want, _ = R_build_model(cfg_r).loss(params_r, {
        "tokens": jnp.asarray(toks[:, :-1], jnp.int32),
        "labels": jnp.asarray(toks[:, 1:], jnp.int32),
        "frames": jnp.asarray(frames), "mask": jnp.asarray(mask)})
    got, metrics = build_model(cfg_t, device="cpu").loss(params_t, {
        "tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:]),
        "frames": _t(frames), "mask": _t(mask)})
    _close(want, got, 2e-5)
    assert float(metrics["loss"]) == float(got)


def test_prefill_and_decode_match_reference(setup):
    """Logits, the self-attention caches and the cross-attention caches
    (the memory's K/V, fixed through decode)."""
    cfg_r, cfg_t, params_r, params_t, tree = setup
    b, s, n_gen = 2, 12, 4
    toks, frames = _inputs(cfg_t, b, s + n_gen, seed=7)
    m_r, m_t = R_build_model(cfg_r), build_model(cfg_t, device="cpu")
    assert m_t.init_cache is None
    lg_r, c_r = m_r.prefill(params_r, {
        "tokens": jnp.asarray(toks[:, :s], jnp.int32),
        "frames": jnp.asarray(frames)}, s + n_gen)
    lg_t, c_t = m_t.prefill(params_t, {"tokens": _t(toks[:, :s]),
                                       "frames": _t(frames)}, s + n_gen)
    _close(lg_r, lg_t, 2e-4)
    assert len(c_t) == len(c_r) == cfg_t.num_layers
    for cr, ct in zip(c_r, c_t):
        assert ct["cross_k"].shape == (b, cfg_t.num_kv_heads,
                                       cfg_t.encoder_seq, cfg_t.hd)
        _close(cr["cross_k"], ct["cross_k"], 2e-4)
        _close(cr["cross_v"], ct["cross_v"], 2e-4)
        assert ct["self"].k.shape == cr["self"].k.shape
        assert ct["self"].pos == int(cr["self"].pos) == s
        _close(cr["self"].k, ct["self"].k, 2e-4)
        _close(cr["self"].v, ct["self"].v, 2e-4)
    cross = [(c["cross_k"].clone(), c["cross_v"].clone()) for c in c_t]
    for t in range(n_gen):
        tok = toks[:, s + t]
        lg_r, c_r = m_r.decode_step(params_r, c_r,
                                    jnp.asarray(tok, jnp.int32))
        lg_t, c_t = m_t.decode_step(params_t, c_t, _t(tok))
        _close(lg_r, lg_t, 2e-4)
    for cr, ct, (k0, v0) in zip(c_r, c_t, cross):
        assert ct["self"].pos == int(cr["self"].pos) == s + n_gen
        _close(cr["self"].k, ct["self"].k, 2e-4)
        assert torch.equal(ct["cross_k"], k0)
        assert torch.equal(ct["cross_v"], v0)


def test_prefill_decode_matches_forward(setup):
    """The port's own teacher-forced decode equals its forward pass, as
    ``tests/test_decode_consistency.py`` holds the reference."""
    cfg_r, cfg_t, params_r, params_t, tree = setup
    model = build_model(cfg_t, device="cpu")
    b, s, n_gen = 2, 12, 4
    toks, frames = _inputs(cfg_t, b, s + n_gen, seed=8)
    fr = _t(frames)
    full = model.forward(params_t, {"tokens": _t(toks), "frames": fr})
    logits_p, caches = model.prefill(
        params_t, {"tokens": _t(toks[:, :s]), "frames": fr}, s + n_gen)
    err = [float((full[:, :s] - logits_p).abs().max())]
    for t in range(n_gen):
        lg, caches = model.decode_step(params_t, caches, _t(toks[:, s + t]))
        err.append(float((full[:, s + t] - lg).abs().max()))
    assert max(err) < 2e-3, err


def test_attention_calls_keep_the_reference_choices(setup, monkeypatch):
    """With the kernel's implementation resolved (as on a CUDA tensor):
    the prefill runs it once per encoder layer and leaves the decoder's
    self and cross attention chunked; a decode step never runs it (its
    cross attention is "ref"); the teacher-forced forward runs it three
    times a layer pair (encoder, decoder self, decoder cross), not causal
    but for the decoder's self attention.  These are the flash launch
    counts the card is held to (6, 0 and 18 at whisper-base's 6 + 6
    layers)."""
    cfg_r, cfg_t, params_r, params_t, tree = setup
    calls = []
    real = T_attn.full_attention

    def spy(q, k, v, causal, window, impl="ref", **kw):
        calls.append((impl, causal, q.shape[2], k.shape[2]))
        return real(q, k, v, causal, window, impl=impl, **kw)

    monkeypatch.setattr(T_attn, "full_attention", spy)
    model = build_model(cfg_t.scaled(attn_impl="pallas"), device="cpu")
    toks, frames = _inputs(cfg_t, 2, 9, seed=9)
    L, E, S = cfg_t.num_layers, cfg_t.encoder_layers, cfg_t.encoder_seq
    _, caches = model.prefill(params_t, {"tokens": _t(toks[:, :8]),
                                         "frames": _t(frames)}, 9)
    assert calls == [("pallas", False, S, S)] * E + \
        [("chunked", True, 8, 8), ("chunked", False, 8, S)] * L
    calls.clear()
    model.decode_step(params_t, caches, _t(toks[:, 8]))
    assert calls == [("ref", False, 1, S)] * L
    calls.clear()
    model.forward(params_t, {"tokens": _t(toks), "frames": _t(frames)})
    assert calls == [("pallas", False, S, S)] * E + \
        [("pallas", True, 9, 9), ("pallas", False, 9, S)] * L


def test_full_config_param_count():
    """whisper-base at full size: the reference's count, in the band of
    ``tests/test_models_smoke.py``; the shapes the card serves."""
    cfg = T_configs.get_config(ARCH)
    n = param_count_analytic(cfg)
    assert n == R_analytic(R_configs.get_config(ARCH))
    assert 0.05e9 <= n <= 0.11e9
    assert (cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq,
            cfg.d_model, cfg.num_heads, cfg.hd, cfg.param_dtype) == \
        (6, 6, 1500, 512, 8, 64, torch.bfloat16)
    assert build_model(cfg, device="cpu").cfg is cfg


def test_greedy_tokens_match_reference(capsys):
    """``serve --model-smoke`` with the encoder frames drawn as the
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
    assert run.batch["frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    assert run.logits.shape == (2, 8, cfg.vocab_size)
    assert [c["self"].pos for c in run.cache] == [8 + 4] * cfg.num_layers
    assert ref_out[2] == f"generated: {run.generated[:2].tolist()}"
