"""The selective scan's gradient in the port against the reference.

* ``ssm_scan_bwd_ref`` (the CUDA backward kernel's plain version, the
  reverse recurrence in tensor code) against autograd of the port's
  ``ssm_scan_ref`` and against ``jax.vjp`` of the reference's
  ``kernels/ssm_scan/ref.py:ssm_scan_ref``, at T = 1, 7, 128, 130 and 300,
  n = 8 and 16, d = 80, with h0 and dh non-zero, some channels' dt past
  softplus's threshold (20) and some channels' a_log large enough that
  a = exp(-A dt) underflows to 0;
* ``ssm_scan_bwd_spans_ref`` (the CUDA backward's decomposition: spans
  walked from the last, lanes' maps scanned from the saved entering
  states and, in reverse, from the carried gradient, group partials
  summed in group order) against ``jax.vjp`` of the same reference, at
  T = 1, 7, 130 and 300 over spans of 64 steps, n = 5, 8 and 16, d = 80
  in the kernel's groups of 28 (the last one short), with the same
  planted channels;
* the port's ``models/ssm.ssm_scan`` through the kernel's call (on the
  CPU: ``SSMScan`` with the plain forward and ``ssm_scan_bwd_ref``)
  against ``jax.vjp`` of the reference's ``models/ssm.py:ssm_scan`` (its
  chunked ``lax.scan`` under ``jax.checkpoint``, with d_skip);
* the autograd Function on the CPU: the plain gradients whichever
  outputs are used (an unused output's gradient is None), no Function
  where no gradient is taken, and remat's recompute giving the same
  gradients.

Inputs are made with numpy from a seed.  Tolerance: each gradient within
1e-5 of its own norm (``||g - want|| <= 1e-5 ||want||``), in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_scan_ref as R_ref
from repro.models import ssm as R_ssm
from repro.models.common import ModelConfig as R_ModelConfig
from repro_torch.kernels.ssm_scan import (SSMScan, ssm_scan_bwd_kernel,
                                          ssm_scan_bwd_ref, ssm_scan_fused,
                                          ssm_scan_kernel, ssm_scan_ref)
from repro_torch.kernels.ssm_scan import backward as sbmod
from repro_torch.kernels.ssm_scan import kernel as smod
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_spans_ref
from repro_torch.models import ssm as T_ssm
from repro_torch.models.common import ModelConfig

TOL = 1e-5
D = 80
GRADS = ("dxc", "dx_proj", "ddt_bias", "da_log", "dh0")


def _inputs(seed, b, t, d, n):
    """(xc, x_proj, dt_bias, a_log, h0, dy, dh); channels 0-4 with dt
    past softplus's threshold, 5-9 with a underflowing to 0."""
    rng = np.random.default_rng(seed)
    dt_bias = (rng.normal(size=(d,)) * 0.5).astype(np.float32)
    a_log = np.log(rng.uniform(0.5, 2.0, (d, n))).astype(np.float32)
    dt_bias[:5] += 30.0
    a_log[5:10] += 6.0
    return (rng.normal(size=(b, t, d)).astype(np.float32),
            (rng.normal(size=(d, 2 * n + 1)) * 0.3).astype(np.float32),
            dt_bias, a_log,
            (rng.normal(size=(b, d, n)) * 0.3).astype(np.float32),
            rng.normal(size=(b, t, d)).astype(np.float32),
            rng.normal(size=(b, d, n)).astype(np.float32))


def _rel(got, want) -> float:
    want = torch.from_numpy(np.array(want, np.float32))
    return float((got.float() - want).norm() / want.norm())


def _autograd(args, dy, dh):
    leaves = [a.clone().requires_grad_() for a in args]
    y, h = ssm_scan_ref(*leaves)
    return torch.autograd.grad((y, h), leaves, (dy, dh))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("t", [1, 7, 128, 130, 300])
def test_bwd_ref_matches_autograd_and_jax(t, n):
    arrs = _inputs(100 * t + n, 2, t, D, n)
    ts = [torch.from_numpy(a) for a in arrs]
    got = ssm_scan_bwd_ref(*ts)
    # the cases are exercised: dt past 20 and a == 0 somewhere
    xf = ts[0] @ ts[1]
    z = xf[..., 2 * n, None] + ts[2]
    dt = torch.logaddexp(z, torch.zeros(()))
    assert bool((z > 20).any())
    assert bool((torch.exp(-torch.exp(ts[3]) * dt[..., None]) == 0).any())
    want = _autograd(ts[:5], ts[5], ts[6])
    _, vjp = jax.vjp(R_ref, *[jnp.asarray(a) for a in arrs[:5]])
    jax_want = vjp((jnp.asarray(arrs[5]), jnp.asarray(arrs[6])))
    for what, g, w, j in zip(GRADS, got, want, jax_want):
        assert g.dtype == torch.float32 and g.shape == w.shape, what
        assert bool(torch.isfinite(g).all()), what
        assert _rel(g, w) <= TOL, (what, _rel(g, w))
        assert _rel(g, j) <= TOL, (what, _rel(g, j))


@pytest.mark.parametrize("n", [5, 8, 16])
@pytest.mark.parametrize("t", [1, 7, 130, 300])
def test_bwd_spans_decomposition_matches_jax(t, n):
    """The kernel's algebra: spans of 64 steps (16 lanes of 4), so that T
    crosses them, and the kernel's channel groups of 28, which do not
    divide d = 80."""
    arrs = _inputs(1000 + 10 * t + n, 2, t, D, n)
    ts = [torch.from_numpy(a) for a in arrs]
    got = ssm_scan_bwd_spans_ref(*ts, span=64, lanes=16,
                                 group=sbmod.GROUP)
    _, vjp = jax.vjp(R_ref, *[jnp.asarray(a) for a in arrs[:5]])
    jax_want = vjp((jnp.asarray(arrs[5]), jnp.asarray(arrs[6])))
    for what, g, j in zip(GRADS, got, jax_want):
        assert g.dtype == torch.float32 and g.shape == j.shape, what
        assert bool(torch.isfinite(g).all()), what
        assert _rel(g, j) <= TOL, (what, _rel(g, j))


def _model_cfgs(n, chunk):
    kw = dict(name="s", family="hybrid", num_layers=1, d_model=D,
              num_heads=5, num_kv_heads=1, head_dim=16, d_ff=160,
              vocab_size=64, ssm_state=n, ssm_chunk=chunk,
              dtype="float32")
    return R_ModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("n,chunk", [(8, 8), (16, 128)])
@pytest.mark.parametrize("t", [7, 130])
def test_model_scan_gradients_match_jax(t, n, chunk):
    """The port's ``ssm_scan`` on the kernel's call (d_skip added after
    it) against the reference's chunked scan, differentiated by JAX."""
    cfg_r, cfg_t = _model_cfgs(n, chunk)
    xc, x_proj, dt_bias, a_log, h0, dy, dh = _inputs(7 * t + n, 2, t, D, n)
    d_skip = np.random.default_rng(t).normal(size=(D,)).astype(np.float32)
    names = ("x_proj", "dt_bias", "a_log", "d_skip")
    p = dict(zip(names, (x_proj, dt_bias, a_log, d_skip)))

    def r_fn(pr, x, h):
        return R_ssm.ssm_scan(pr, x, cfg_r, h0=h)

    (ry, rh), vjp = jax.vjp(r_fn, {k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(xc), jnp.asarray(h0))
    r_dp, r_dxc, r_dh0 = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt, ht = (torch.from_numpy(a).requires_grad_() for a in (xc, h0))
    before = (smod.LAUNCHES, sbmod.LAUNCHES)
    y, h = T_ssm.ssm_scan(pt, xt, cfg_t, h0=ht, impl="kernel")
    assert y.grad_fn is not None
    grads = torch.autograd.grad((y, h), [*pt.values(), xt, ht],
                                (torch.from_numpy(dy), torch.from_numpy(dh)))
    assert (smod.LAUNCHES, sbmod.LAUNCHES) == before   # CPU: no launch
    assert _rel(y.detach(), ry) <= TOL and _rel(h.detach(), rh) <= TOL
    want = [r_dp[k] for k in names] + [r_dxc, r_dh0]
    for what, g, w in zip([*names, "xc", "h0"], grads, want):
        assert _rel(g, w) <= TOL, (what, _rel(g, w))


@pytest.mark.parametrize("used", ["y and h", "y", "h"])
def test_function_gives_the_plain_gradients(used):
    """``ssm_scan_fused`` where an input requires grad goes through
    ``SSMScan`` (plain forward, ``ssm_scan_bwd_ref``); a gradient of None
    for the unused output counts as zeros."""
    arrs = _inputs(3, 2, 37, 16, 4)
    args = [torch.from_numpy(a) for a in arrs[:5]]
    dy, dh = (torch.from_numpy(a) for a in arrs[5:])
    leaves = [a.clone().requires_grad_() for a in args]
    y, h = ssm_scan_fused(*leaves)
    assert type(y.grad_fn).__name__ == "SSMScanBackward"
    outs, cots = {"y and h": ((y, h), (dy, dh)), "y": ((y,), (dy,)),
                  "h": ((h,), (dh,))}[used]
    got = torch.autograd.grad(outs, leaves, cots)
    if "y" not in used:
        dy = torch.zeros_like(dy)
    if "h" not in used:
        dh = torch.zeros_like(dh)
    for want in (ssm_scan_bwd_ref(*args, dy, dh), _autograd(args, dy, dh)):
        for what, g, w in zip(GRADS, got, want):
            assert _rel(g, w) <= TOL, (what, _rel(g, w))


def test_fused_op_casts_and_gradients_flow_through_them():
    """``ssm_scan_fused`` widens a bf16 xc beside an f32 x_proj and casts
    the rest to f32 before the Function: the gradients come back in each
    leaf's own dtype, equal to autograd of the plain version on the same
    casts."""
    arrs = _inputs(4, 1, 20, 16, 4)
    xc = torch.from_numpy(arrs[0]).bfloat16().requires_grad_()
    x_proj = torch.from_numpy(arrs[1]).requires_grad_()
    y, _ = ssm_scan_fused(xc, x_proj, *(torch.from_numpy(a)
                                        for a in arrs[2:4]))
    dy = torch.from_numpy(arrs[5])
    gx, gw = torch.autograd.grad(y, (xc, x_proj), dy)
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    xc2 = xc.detach().clone().requires_grad_()
    w2 = x_proj.detach().clone().requires_grad_()
    y2, _ = ssm_scan_ref(xc2.float(), w2, *(torch.from_numpy(a)
                                            for a in arrs[2:4]),
                         torch.zeros((1, 16, 4)))
    want = torch.autograd.grad(y2, (xc2, w2), dy)
    assert torch.equal(gx, want[0])
    assert _rel(gw, want[1]) <= TOL


def test_no_function_where_no_gradient_is_taken():
    args = [torch.from_numpy(a) for a in _inputs(5, 1, 9, 8, 4)[:5]]
    assert ssm_scan_kernel(*args)[0].grad_fn is None
    leaves = [a.clone().requires_grad_() for a in args]
    with torch.no_grad():
        assert ssm_scan_fused(*leaves)[0].grad_fn is None
    # the kernel's wrapper alone is no Function: on the CPU, autograd of
    # its plain version
    assert type(ssm_scan_kernel(*leaves)[0].grad_fn).__name__ != \
        "SSMScanBackward"
    # the Function's own forward runs without grad: no nested Function
    y, _ = SSMScan.apply(*leaves)
    assert type(y.grad_fn).__name__ == "SSMScanBackward"


def test_bwd_kernel_on_cpu_takes_plain_version_and_counts_nothing():
    ts = [torch.from_numpy(a) for a in _inputs(6, 2, 140, 16, 8)]
    sbmod.reset_launches()
    got = ssm_scan_bwd_kernel(*ts)
    assert sbmod.LAUNCHES == 0 and sbmod.LAUNCHES_BY_ROUTE == {"scan": 0}
    for g, w in zip(got, ssm_scan_bwd_ref(*ts)):
        assert torch.equal(g, w)


def test_bwd_kernel_checks_shapes_first():
    ts = [torch.from_numpy(a) for a in _inputs(7, 2, 10, 16, 4)]
    with pytest.raises(ValueError, match="dy"):
        ssm_scan_bwd_kernel(*ts[:5], ts[5][:, :9], ts[6])
    with pytest.raises(ValueError, match="dh"):
        ssm_scan_bwd_kernel(*ts[:5], ts[5], ts[6][..., :3])
    with pytest.raises(ValueError, match="x_proj"):
        ssm_scan_bwd_kernel(ts[0], ts[1][:, :3], *ts[2:])


@pytest.mark.parametrize("t", [1, 2, 300])
def test_a_call_that_saves_takes_the_chunked_route(t):
    """Only the chunked route writes what the backward starts from, so a
    call under grad on CUDA takes it at every T; on the CPU nothing is
    saved."""
    for dt in (torch.float32, torch.bfloat16):
        assert smod.route(t, dt, "cuda", save=True) == "chunked"
        assert smod.route(t, dt, "cuda") == ("step" if t == 1
                                             else "chunked")
        assert smod.route(t, dt, "cpu", save=True) == "plain"
    args = [torch.from_numpy(a) for a in _inputs(8, 1, t, 8, 4)[:5]]
    y, h, saved = smod.ssm_scan_kernel(*args, save=True)
    assert saved == ()
    want = ssm_scan_ref(*args)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])


def test_remat_recompute_gives_the_same_gradients():
    """A hybrid block under ``torch.utils.checkpoint`` (remat) calls the
    Function again in the backward: the gradients equal the run that
    keeps everything."""
    from repro_torch.models.common import Params, remat
    _, cfg = _model_cfgs(8, 8)
    gen = torch.Generator().manual_seed(0)
    p = T_ssm.init_ssm(gen, cfg)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 19, D)).astype(np.float32))
    grads = {}
    for flag in (False, True):
        leaves = Params(**{k: v.detach().clone() for k, v in
                           p.named_parameters()}).trainable()
        out = remat(cfg.scaled(remat=flag),
                    lambda x_: T_ssm.ssm_block(leaves, x_, cfg,
                                               impl="kernel")[0], x)
        out.square().sum().backward()
        grads[flag] = {k: v.grad for k, v in leaves.named_parameters()}
    assert grads[True].keys() == grads[False].keys()
    for k in grads[False]:
        assert torch.equal(grads[True][k], grads[False][k]), k
