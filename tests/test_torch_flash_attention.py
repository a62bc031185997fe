"""Flash attention: the port's plain version of the kernel against the
reference's Pallas kernel in interpret mode, on the same inputs.

On a CPU tensor the port's ``flash_attention`` takes the kernel's plain
version.  The cases are those of ``tests/test_kernels_flash.py`` plus a
query row that sees no key, where the kernel (and so its plain version)
gives 0 and the reference's ``attention_ref`` NaN.  Tolerances as in the
reference's tests: f32 2e-5 (summation order), bf16 2e-2 (one rounding
of the output to 8 mantissa bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_ref as jax_attention_ref
from repro.kernels import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention)

CASES = [
    # (b, hq, hkv, sq, sk, d, causal, window)
    (2, 4, 2, 64, 64, 32, True, None),
    (1, 8, 2, 40, 40, 64, False, None),
    (1, 4, 4, 96, 96, 32, True, 32),
    (1, 2, 1, 16, 128, 32, True, None),    # cross lengths (right-aligned)
    (1, 3, 1, 33, 77, 16, True, None),     # unaligned everything
    (2, 2, 2, 128, 128, 128, True, None),  # MXU-aligned
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _err(jax_out, torch_out):
    return float(np.max(np.abs(np.asarray(jax_out.astype(jnp.float32))
                               - torch_out.float().numpy())))


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_flash_matches_reference_kernel(case, dtype):
    b, hq, hkv, sq, sk, d, causal, window = case
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(0, b, hq, hkv, sq, sk, d), jdt, tdt)
    want = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=32, block_k=32, interpret=True)
    before = fmod.LAUNCHES
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert fmod.LAUNCHES == before          # CPU: no kernel launch
    assert got.dtype == tdt and got.shape == (b, hq, sq, d)
    assert _err(want, got) < tol, (case, dtype, _err(want, got))


@pytest.mark.parametrize("blocks", [(8, 8), (16, 64), (64, 16), (128, 128)],
                         ids=str)
def test_block_sizes(blocks):
    """The reference's block-size sweep: every tiling of its kernel gives
    what the port's (untiled) plain version gives."""
    bq, bk = blocks
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 1, 2, 1, 64, 64, 32),
                                       jnp.float32, torch.float32)
    want = jax_flash_attention(jq, jk, jv, causal=True, block_q=bq,
                               block_k=bk, interpret=True)
    assert _err(want, flash_attention(tq, tk, tv, causal=True)) < 2e-5


def test_rows_without_keys_give_zero():
    """Sq > Sk, causal: the first Sq - Sk query rows see no key.  The
    reference kernel and the port give 0 there; ``attention_ref`` (both
    packages) gives NaN."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 1, 4, 2, 50, 20, 16),
                                       jnp.float32, torch.float32)
    want = jax_flash_attention(jq, jk, jv, causal=True, block_q=16,
                               block_k=16, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True)
    assert _err(want, got) < 2e-5
    assert bool((got[:, :, :30] == 0).all())
    assert bool(got[:, :, 30:].abs().sum(-1).gt(0).all())
    assert np.isnan(np.asarray(jax_attention_ref(jq, jk, jv))[:, :, :30]).all()
    assert bool(attention_ref(tq, tk, tv)[:, :, :30].isnan().all())


@pytest.mark.parametrize("case", CASES[:3] + CASES[4:5], ids=str)
def test_attention_ref_matches_reference_oracle(case):
    b, hq, hkv, sq, sk, d, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(3, b, hq, hkv, sq, sk, d),
                                       jnp.float32, torch.float32)
    want = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = attention_ref(tq, tk, tv, causal=causal, window=window)
    assert _err(want, got) < 2e-5


def test_sm_scale_is_honoured():
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(4, 1, 2, 2, 24, 24, 16),
                                       jnp.float32, torch.float32)
    want = jax_flash_attention(jq, jk, jv, sm_scale=0.3, block_q=8,
                               block_k=8, interpret=True)
    assert _err(want, flash_attention(tq, tk, tv, sm_scale=0.3)) < 2e-5
