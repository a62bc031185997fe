"""The port's hybrid family (hymba: attention and an SSM side by side,
sliding-window attention on all but the global layers) against the
reference on carried-across weights.

``params_from_numpy`` carries the reference's ``hymba-1.5b`` smoke-config
weights (3 layers, d_model 80, 5/1 heads, window 8 with layer 1 global,
n = 8, float32) into the port; tokens are made with numpy from a seed.
Prompts are longer than the window, so the ring caches wrap.  Tolerance
2e-4 in f32 for logits and caches (another summation order through three
layers and the vocab projection); the greedy tokens are equal.
"""
import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.launch import serve as R_serve
from repro.models import build_model as R_build_model
from repro.models import transformer as R_tf
from repro_torch import configs as T_configs
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.launch import serve as T_serve
from repro_torch.models import build_model, param_count
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy

ARCH = "hymba-1.5b"
TOL = 2e-4
ARGV = ["--model-smoke", "--arch", ARCH, "--smoke", "--batch", "3",
        "--prompt-len", "12", "--gen", "7", "--seed", "4"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(want, got, tol=TOL):
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


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_parameters_follow_reference_paths(setup):
    """Block i's leaves are the reference's stacked leaves at index i;
    a full-width layer has the reference's shapes, so the full config
    counts the reference's 1,342,006,400 parameters."""
    cfg_r, cfg_t, params_r, params_t = setup
    names = dict(params_t.named_parameters())
    want = {}
    for path, leaf in _leaves(jax.tree.map(np.asarray, params_r)):
        if path.startswith("blocks."):
            for i in range(cfg_t.num_layers):
                want[path.replace("blocks.", f"blocks.{i}.", 1)] = \
                    leaf.shape[1:]
        else:
            want[path] = leaf.shape
    assert {n: tuple(p.shape) for n, p in names.items()} == want
    for n in ("ssm.x_proj", "norm_a.scale", "norm_s.scale", "mlp.w2"):
        np.testing.assert_array_equal(
            names[f"blocks.2.{n}"].numpy(),
            np.asarray(params_r["blocks"][n.split(".")[0]][
                n.split(".")[1]][2]))
    full_r = R_configs.get_config(ARCH)
    counted = sum(l.size for l in jax.tree.leaves(jax.eval_shape(
        lambda: R_build_model(full_r).init(jax.random.PRNGKey(0)))))
    assert counted == 1_342_006_400
    one = T_configs.get_config(ARCH).scaled(num_layers=1, vocab_size=64)
    per_layer = param_count(build_model(one, device="cpu").init(0)) \
        - 64 * one.d_model - one.d_model
    assert 32001 * 1600 + 1600 + 32 * per_layer == counted


def test_layer_windows_match_reference():
    for get in ("get_config", "get_smoke_config"):
        cfg_r = getattr(R_configs, get)(ARCH)
        cfg_t = getattr(T_configs, get)(ARCH)
        assert T_tf.layer_windows(cfg_t) == \
            R_tf.layer_windows(cfg_r).tolist()
    cfg = T_configs.get_config(ARCH)
    assert [T_tf.layer_window(cfg, i) for i in (0, 1, 15, 30, 31)] == \
        [None, 1024, None, 1024, None]
    dense = T_configs.get_smoke_config("llama3.2-1b")
    assert T_tf.layer_windows(dense) is None
    assert T_tf.layer_window(dense, 0) is None


def test_forward_matches_reference(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    toks = _tokens(cfg_t, 2, 20, seed=1)
    want, _ = R_tf.forward(params_r, jnp.asarray(toks), cfg_r)
    f0, s0 = fmod.LAUNCHES, smod.LAUNCHES
    got, aux = T_tf.forward(params_t, torch.from_numpy(toks), cfg_t)
    assert (fmod.LAUNCHES, smod.LAUNCHES) == (f0, s0)   # CPU: no kernel
    assert float(aux) == 0.0
    _close(want, got)
    with pytest.raises(ValueError, match="uniform"):
        T_tf.forward(params_t, torch.from_numpy(toks), cfg_t,
                     return_kv=True)


def _check_caches(want, got, cfg, s):
    assert len(got) == len(want) == cfg.num_layers
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.kind == w.kind == "hybrid"
        assert g.kv.pos == int(w.kv.pos) == s
        assert g.kv.window == w.kv.window == (
            0 if i in cfg.global_layers else cfg.window)
        assert g.kv.k.shape == w.kv.k.shape
        _close(w.kv.k, g.kv.k)
        _close(w.kv.v, g.kv.v)
        assert g.ssm.conv.shape == w.ssm.conv.shape
        _close(w.ssm.conv, g.ssm.conv)
        _close(w.ssm.h, g.ssm.h)
        assert g.ssm.h.dtype == torch.float32


def test_prefill_and_decode_match_reference(setup):
    """Prompt 13 > window 8: the ring caches wrap in the prefill and
    again over the decode steps."""
    cfg_r, cfg_t, params_r, params_t = setup
    b, s, steps, max_len = 2, 13, 5, 20
    toks = _tokens(cfg_t, b, s + steps, seed=2)
    want, wc = R_tf.prefill(params_r, jnp.asarray(toks[:, :s]), cfg_r,
                            max_len=max_len)
    got, gc = T_tf.prefill(params_t, torch.from_numpy(toks[:, :s]), cfg_t,
                           max_len=max_len)
    _close(want, got)
    _check_caches(wc, gc, cfg_t, s)
    # layer 0 keeps a ring of `window` slots, global layer 1 all max_len
    assert cfg_t.global_layers == (1,)
    assert gc[0].kv.k.shape[2] == cfg_t.window
    glob = gc[1].kv
    assert glob.k.shape[2] == max_len
    assert float(glob.k[:, :, s:].abs().max()) == 0.0
    for t in range(steps):
        tok = toks[:, s + t]
        lw, wc = R_tf.decode_step(params_r, wc, jnp.asarray(tok), cfg_r)
        lg, gc = T_tf.decode_step(params_t, gc, torch.from_numpy(tok),
                                  cfg_t)
        _close(lw, lg)
        _check_caches(wc, gc, cfg_t, s + t + 1)


def test_prefill_decode_matches_forward(setup):
    """The port's own consistency: teacher-forced decode after a prefill
    gives the forward pass's logits."""
    _, cfg_t, _, params_t = setup
    toks = torch.from_numpy(_tokens(cfg_t, 2, 16, seed=3))
    full, _ = T_tf.forward(params_t, toks, cfg_t)
    lg, caches = T_tf.prefill(params_t, toks[:, :10], cfg_t, max_len=16)
    torch.testing.assert_close(lg, full[:, :10], rtol=0, atol=TOL)
    for t in range(10, 16):
        lg, caches = T_tf.decode_step(params_t, caches, toks[:, t], cfg_t)
        torch.testing.assert_close(lg, full[:, t], rtol=0, atol=TOL)


def test_init_cache_is_per_layer(setup):
    _, cfg_t, _, _ = setup
    caches = build_model(cfg_t, device="cpu").init_cache(2, 30)
    assert [c.kv.k.shape[2] for c in caches] == [8, 30, 8]
    assert all(c.kv.pos == 0 and c.ssm.h.shape == (2, 80, 8)
               for c in caches)


def test_greedy_tokens_match_reference(capsys):
    assert R_serve.main(ARGV) == 0
    ref_out = capsys.readouterr().out.splitlines()
    params = R_build_model(R_configs.get_smoke_config(ARCH)).init(
        jax.random.PRNGKey(4))
    args = T_serve.parse_args(ARGV + ["--device", "cpu"])
    run = T_serve.model_smoke(args, params=params_from_numpy(
        jax.tree.map(np.asarray, params), T_configs.get_smoke_config(ARCH),
        device="cpu"))
    assert run.generated.shape == (3, 7)
    assert ref_out[2] == f"generated: {run.generated[:2].tolist()}"
    # the full batch, through the reference's model directly
    m = R_build_model(R_configs.get_smoke_config(ARCH))
    logits, cache = m.prefill(
        params, {"tokens": run.batch["tokens"].numpy()}, 19)
    tok = np.argmax(np.asarray(logits[:, -1]), -1)
    want = [tok]
    for _ in range(6):
        lg, cache = m.decode_step(params, cache, tok)
        tok = np.argmax(np.asarray(lg), -1)
        want.append(tok)
    np.testing.assert_array_equal(run.generated, np.stack(want, 1))
    assert [c.kv.pos for c in run.cache] == [18, 18, 18]


def test_cli_runs_on_the_cpu_and_needs_a_gpu_by_default(capsys):
    assert T_serve.main(ARGV + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith(" ms for 3x12")
    assert np.asarray(ast.literal_eval(out[2][len("generated: "):])
                      ).shape == (2, 7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T_serve.main(ARGV)
