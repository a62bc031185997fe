"""The port's fused selective scan against the reference.

``repro_torch.kernels.ssm_scan.ssm_scan_fused`` on CPU tensors takes the
CUDA kernel's plain version; it is held to the reference's Pallas kernel
(``ssm_scan_fused(..., interpret=True)``, as ``tests/test_kernels_ssm.py``
runs it) and to its sequential oracle ``ssm_scan_ref``, on inputs made
with numpy from a seed.  Tolerance 1e-4 in f32, as the reference's own
test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssm_scan_fused as R_fused
from repro.kernels import ssm_scan_ref as R_ref
from repro_torch.kernels.ssm_scan import (ssm_scan_fused, ssm_scan_kernel,
                                          ssm_scan_ref)
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.kernels.ssm_scan.ref import softplus

TOL = 1e-4


def _inputs(seed, b, t, d, n, dt_scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, d)).astype(np.float32),
            (rng.normal(size=(d, 2 * n + 1)) * 0.3).astype(np.float32),
            (rng.normal(size=(d,)) * dt_scale).astype(np.float32),
            np.log(rng.uniform(0.5, 2.0, (d, n))).astype(np.float32),
            (rng.normal(size=(b, d, n)) * 0.2).astype(np.float32))


def _close(want, got, tol=TOL):
    err = float(np.max(np.abs(np.asarray(want, np.float32)
                              - got.float().numpy())))
    assert err < tol, err


def _both(args, chunk):
    """(reference kernel, reference oracle, port) outputs."""
    ja = [jnp.asarray(a) for a in args]
    return (R_fused(*ja, chunk=chunk, interpret=True), R_ref(*ja),
            ssm_scan_fused(*[torch.from_numpy(a) for a in args],
                           chunk=chunk))


@pytest.mark.parametrize("b,t,d,n,chunk", [
    (2, 64, 32, 8, 16), (1, 100, 16, 4, 32), (1, 33, 8, 4, 8),
    (3, 16, 8, 2, 16),
])
def test_fused_scan_matches_reference(b, t, d, n, chunk):
    (ky, kh), (ry, rh), (y, h) = _both(_inputs(b * t + n, b, t, d, n),
                                       chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (b, t, d) and h.shape == (b, d, n)
    for want in ((ky, kh), (ry, rh)):
        _close(want[0], y)
        _close(want[1], h)


def test_two_halves_chained_equal_one_pass():
    xc, xp, dtb, al, _ = _inputs(3, 1, 64, 16, 4)
    h0 = np.zeros((1, 16, 4), np.float32)
    t = [torch.from_numpy(a) for a in (xc, xp, dtb, al, h0)]
    y_full, h_full = ssm_scan_fused(*t)
    y1, h_mid = ssm_scan_fused(t[0][:, :32], *t[1:])
    y2, h_end = ssm_scan_fused(t[0][:, 32:], *t[1:4], h_mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0,
                               atol=TOL)
    torch.testing.assert_close(h_end, h_full, rtol=0, atol=TOL)
    (ky, kh), _, _ = _both((xc, xp, dtb, al, h0), 16)
    _close(ky, y_full)
    _close(kh, h_full)


def test_one_step_from_a_carried_state():
    """T = 1 with a nonzero h0: the decode step's shape."""
    args = _inputs(5, 4, 1, 24, 16)
    assert np.abs(args[4]).max() > 0
    (ky, kh), (ry, rh), (y, h) = _both(args, 128)
    _close(ky, y)
    _close(kh, h)
    _close(ry, y)
    _close(rh, h)


@pytest.mark.parametrize("proj_dtype", ["float32", "bfloat16"])
def test_bf16_activations(proj_dtype):
    """A bf16 xc (and x_proj): both packages widen to f32 before the
    product, so the results agree to the f32 tolerance."""
    xc, xp, dtb, al, h0 = _inputs(6, 2, 40, 16, 8)
    xc16 = jnp.asarray(xc, jnp.bfloat16)
    xp_r = jnp.asarray(xp, getattr(jnp, proj_dtype))
    ky, kh = R_fused(xc16, xp_r, jnp.asarray(dtb), jnp.asarray(al),
                     jnp.asarray(h0), chunk=16, interpret=True)
    xc_t = torch.from_numpy(np.array(xc16.astype(jnp.float32))).to(
        torch.bfloat16)
    xp_t = torch.from_numpy(np.array(xp_r.astype(jnp.float32))).to(
        getattr(torch, proj_dtype))
    y, h = ssm_scan_fused(xc_t, xp_t, torch.from_numpy(dtb),
                          torch.from_numpy(al), torch.from_numpy(h0))
    _close(ky, y)
    _close(kh, h)


def test_cpu_takes_the_plain_version_and_launches_nothing():
    args = [torch.from_numpy(a) for a in _inputs(7, 2, 9, 8, 4)]
    before = smod.LAUNCHES
    y, h = ssm_scan_kernel(*args)
    assert smod.LAUNCHES == before
    y2, h2 = ssm_scan_ref(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    # h0 defaults to zeros; chunk changes nothing
    z = torch.zeros_like(args[4])
    for chunk in (1, 4, 128):
        y3, _ = ssm_scan_fused(*args[:4], chunk=chunk)
        assert torch.equal(y3, ssm_scan_ref(*args[:4], z)[0])


def test_kernel_rejects_bad_shapes():
    xc, xp, dtb, al, h0 = [torch.from_numpy(a)
                           for a in _inputs(8, 1, 4, 8, 4)]
    with pytest.raises(ValueError, match="x_proj"):
        ssm_scan_kernel(xc, xp[:, :-1], dtb, al, h0)
    with pytest.raises(ValueError, match="h0"):
        ssm_scan_kernel(xc, xp, dtb, al, h0[:, :4])
    with pytest.raises(ValueError, match="T >= 1"):
        ssm_scan_kernel(xc[:, :0], xp, dtb, al, h0)


def test_softplus_matches_jax_past_the_threshold():
    """``jax.nn.softplus`` is logaddexp(x, 0); torch's F.softplus turns
    into x above 20, which differs from it by exp(-x)."""
    import jax
    x = np.array([-30.0, -5.0, 0.0, 3.0, 19.9, 20.0, 20.5, 40.0],
                 np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
