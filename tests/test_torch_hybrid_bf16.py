"""bf16 hymba in the port against bf16 hymba in the reference, on the CPU.

hymba-1.5b at full width (d_model 1600, 25/5 heads, SSM state 16, d_ff
5504) cut to two layers (layer 1 global, layer 0 windowed at 1024) and a
vocab of 512, with ``attn_impl="ref"`` in both packages.  The reference
draws the bf16 weights from ``PRNGKey(0)``; ``params_from_numpy`` carries
them into the port, so both packages hold the same bf16 values and the
same values widened to f32.

In bf16 the hybrid stack rounds differently from f32 (``norm_s`` rescales
SSM rows of small RMS), in both packages.  So the port's bf16 logits are
held to its own f32 logits by relative RMS error (over all logits), and
that error must be at most ``RATIO`` = 1.5x the reference's own bf16-vs-
f32 error on the same prompt; the two f32 models agree to ``F32_TOL`` =
1e-4 relative RMS (summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import build_model as R_build_model
from repro.models import transformer as R_tf
from repro_torch import configs as T_configs
from repro_torch.models import transformer as T_tf
from repro_torch.models.convert import params_from_numpy

ARCH = "hymba-1.5b"
CUT = dict(num_layers=2, global_layers=(1,), vocab_size=512,
           attn_impl="ref", remat=False)
BATCH, PROMPT = 1, 96
RATIO = 1.5
F32_TOL = 1e-4


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).sum() / (want ** 2).sum()))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def logits():
    cfg16_r = R_configs.get_config(ARCH).scaled(**CUT, dtype="bfloat16")
    cfg32_r = cfg16_r.scaled(dtype="float32")
    cfg16_t = T_configs.get_config(ARCH).scaled(**CUT, dtype="bfloat16")
    cfg32_t = cfg16_t.scaled(dtype="float32")
    p16_r = R_build_model(cfg16_r).init(jax.random.PRNGKey(0))
    # f32 leaves holding the bf16 values: the same weights, widened
    p32_np = jax.tree.map(_f32, p16_r)
    p32_r = jax.tree.map(jnp.asarray, p32_np)
    toks = np.random.default_rng(7).integers(0, cfg16_r.vocab_size,
                                             (BATCH, PROMPT))
    out = {"ref16": _f32(R_tf.forward(p16_r, jnp.asarray(toks), cfg16_r)[0]),
           "ref32": _f32(R_tf.forward(p32_r, jnp.asarray(toks), cfg32_r)[0])}
    with torch.no_grad():
        for tag, cfg in (("port16", cfg16_t), ("port32", cfg32_t)):
            params = params_from_numpy(p32_np, cfg, device="cpu")
            out[tag] = T_tf.forward(params, torch.from_numpy(toks),
                                    cfg)[0].float().numpy()
            del params
    return out


def test_bf16_weights_carry_over_exactly():
    cfg = R_configs.get_config(ARCH).scaled(**CUT, dtype="bfloat16")
    p16_r = R_build_model(cfg).init(jax.random.PRNGKey(0))
    p16_t = params_from_numpy(jax.tree.map(_f32, p16_r),
                              T_configs.get_config(ARCH).scaled(
                                  **CUT, dtype="bfloat16"), device="cpu")
    blk = p16_t.blocks[1]
    for name, leaf in (("ssm", "x_proj"), ("mlp", "w2"), ("ssm", "in_proj")):
        want = _f32(p16_r["blocks"][name][leaf][1])
        got = getattr(blk, name)[leaf]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_f32_models_agree(logits):
    err = rel_rms(logits["port32"], logits["ref32"])
    assert err <= F32_TOL, err


def test_bf16_error_within_reference_bf16_error(logits):
    ref = rel_rms(logits["ref16"], logits["ref32"])
    port = rel_rms(logits["port16"], logits["port32"])
    assert np.isfinite(logits["port16"]).all()
    assert ref > 0 and port > 0
    assert port <= RATIO * ref, (port, ref)
