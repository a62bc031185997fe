"""The flash-attention backward's plain version (``flash_attention_bwd_plain``,
the recompute algebra the CUDA backward kernel follows) against autograd
of ``attention_ref`` in the port and ``jax.grad`` of the reference's
``attention_ref``, and the autograd plumbing around the kernels on the
CPU.

Inputs are made with numpy from a seed; every comparison is in f32
within 1e-5.  A query row that sees no key has a NaN output in either
package's ``attention_ref`` (and NaN gradients through it); the kernel's
function gives it 0 and a zero gradient, so there the oracles run on
the rows that see a key (right-aligned positions are unchanged by
dropping leading rows) and those rows' dq must be 0.  The kernel itself
runs only on the card (``tests/test_torch_kernels_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as R_attention_ref
from repro_torch.kernels.build import require_no_grad
from repro_torch.kernels.flash_attention import backward as bmod
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, flash_attention_bwd_plain, flash_attention_plain)

TOL = 1e-5

CASES = [
    # name, b, hq, hkv, sq, sk, d, causal, window
    ("causal", 2, 4, 4, 33, 33, 16, True, None),
    ("windowed", 1, 4, 2, 40, 40, 32, True, 8),
    ("not causal", 2, 2, 2, 20, 37, 16, False, None),
    ("gqa 4", 1, 8, 2, 24, 24, 16, True, None),
    ("no-key rows", 1, 4, 2, 30, 12, 16, True, None),
]


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      (b, hq, sq, d))]


def _plain_grads(q, k, v, do, causal, window):
    """(dq, dk, dv) [B, H, S, D] from the plain forward's o and lse and
    the plain backward, on the flattened layout."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    q3, k3, v3, do3 = (torch.from_numpy(x).reshape(-1, x.shape[2], d)
                       for x in (q, k, v, do))
    o, lse = flash_attention_plain(q3, k3, v3, hq // hkv, causal=causal,
                                   window=window, return_lse=True)
    dq, dk, dv = flash_attention_bwd_plain(q3, k3, v3, o, do3, lse,
                                           hq // hkv, causal=causal,
                                           window=window)
    return (dq.reshape(b, hq, sq, d), dk.reshape(b, hkv, sk, d),
            dv.reshape(b, hkv, sk, d))


def _empty(sq, sk, causal):
    return sq - sk if causal and sq > sk else 0


def _close(got, want, what):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err < TOL, (what, err)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_torch_autograd_of_attention_ref(case):
    _, b, hq, hkv, sq, sk, d, causal, window = case
    q, k, v, do = _inputs(b, hq, hkv, sq, sk, d)
    dq, dk, dv = _plain_grads(q, k, v, do, causal, window)
    e = _empty(sq, sk, causal)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_()
                  for x in (q[:, :, e:], k, v))
    out = attention_ref(qt, kt, vt, causal=causal, window=window)
    want = torch.autograd.grad(out, (qt, kt, vt),
                               torch.from_numpy(do[:, :, e:]))
    _close(dq[:, :, e:], want[0], "dq")
    _close(dk, want[1], "dk")
    _close(dv, want[2], "dv")
    assert bool((dq[:, :, :e] == 0).all())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax_grad_of_reference(case):
    _, b, hq, hkv, sq, sk, d, causal, window = case
    q, k, v, do = _inputs(b, hq, hkv, sq, sk, d, seed=1)
    dq, dk, dv = _plain_grads(q, k, v, do, causal, window)
    e = _empty(sq, sk, causal)
    _, vjp = jax.vjp(lambda a, b_, c: R_attention_ref(
        a, b_, c, causal=causal, window=window),
        jnp.asarray(q[:, :, e:]), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do[:, :, e:]))
    _close(dq[:, :, e:], want[0], "dq")
    _close(dk, want[1], "dk")
    _close(dv, want[2], "dv")
    assert bool((dq[:, :, :e] == 0).all())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_lse_is_the_masked_logsumexp(case):
    _, b, hq, hkv, sq, sk, d, causal, window = case
    q, k, v, _ = _inputs(b, hq, hkv, sq, sk, d, seed=2)
    q3, k3, v3 = (torch.from_numpy(x).reshape(-1, x.shape[2], d)
                  for x in (q, k, v))
    group = hq // hkv
    o, lse = flash_attention_plain(q3, k3, v3, group, causal=causal,
                                   window=window, return_lse=True)
    assert torch.equal(o, flash_attention_plain(q3, k3, v3, group,
                                                causal=causal,
                                                window=window))
    s = torch.einsum("bqd,bkd->bqk", q3, k3.repeat_interleave(group, 0))
    s = s / d ** 0.5
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    kpos = torch.arange(sk)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal or window is not None:
        keep &= qpos >= kpos
    if window is not None:
        keep &= kpos > qpos - window
    want = torch.logsumexp(torch.where(keep, s, float("-inf")), dim=-1)
    e = _empty(sq, sk, causal)
    _close(lse[:, e:], want[:, e:], "lse")
    assert bool((lse[:, :e] == float("inf")).all())


def test_flash_attention_takes_the_function_where_grads_are_taken():
    """With an input requiring grad the op goes through FlashAttention (a
    ``grad_fn`` whose backward is the backward wrapper, the plain version
    on the CPU) and its gradients equal the plain backward's; without,
    the forward runs alone."""
    q, k, v, do = _inputs(1, 4, 2, 24, 24, 16, seed=3)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    want = _plain_grads(q, k, v, do, True, None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert flash_attention(qt, kt, vt).grad_fn is None
    assert flash_attention(*(torch.from_numpy(x) for x in (q, k, v))
                           ).grad_fn is None


def test_function_saves_lse_and_returns_no_grads_for_arguments():
    q, k, v, do = (torch.from_numpy(x).reshape(-1, x.shape[2], 16)
                   for x in _inputs(1, 2, 1, 10, 10, 16, seed=4))
    q.requires_grad_()
    out = FlashAttention.apply(q, k, v, 2, True, None, None)
    (dq,) = torch.autograd.grad(out, (q,), do)
    o, lse = flash_attention_plain(q.detach(), k, v, 2, return_lse=True)
    assert torch.equal(out.detach(), o)
    assert torch.equal(dq, flash_attention_bwd_plain(
        q.detach(), k, v, o, do, lse, 2)[0])


def test_backward_wrapper_cpu_takes_plain_and_moves_no_counter():
    q, k, v, do = (torch.from_numpy(x).reshape(-1, x.shape[2], 16)
                   for x in _inputs(1, 4, 2, 12, 12, 16, seed=5))
    o, lse = fmod.flash_attention_kernel(q, k, v, group=2, return_lse=True)
    bmod.reset_launches()
    got = bmod.flash_attention_bwd_kernel(q, k, v, o, do, lse, group=2)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bmod.LAUNCHES == 0
    assert bmod.LAUNCHES_BY_ROUTE == {"wgmma": 0, "simt": 0}
    assert bmod.LAUNCHES_BY_SHAPE == {}
    # the forward's rule: bf16 at head dim 64 or 128 takes the tensor cores
    for dt in (torch.float32, torch.bfloat16):
        assert bmod.route(dt, 64, "cpu") == "plain"
    cuda = torch.device("cuda")
    assert bmod.route(torch.bfloat16, 64, cuda) == "wgmma"
    assert bmod.route(torch.bfloat16, 128, cuda) == "wgmma"
    for dt, d in ((torch.float32, 64), (torch.float32, 128),
                  (torch.bfloat16, 16), (torch.bfloat16, 32),
                  (torch.bfloat16, 96)):
        assert bmod.route(dt, d, cuda) == "simt"
    assert all(bmod.route(dt, d, cuda) == fmod.route(dt, d, cuda)
               for dt in (torch.float32, torch.bfloat16)
               for d in fmod.HEAD_DIMS)


@pytest.mark.parametrize("bad", ["o", "do", "lse"])
def test_backward_wrapper_checks_shapes_first(bad):
    q, k, v, do = (torch.from_numpy(x).reshape(-1, x.shape[2], 16)
                   for x in _inputs(1, 4, 2, 12, 12, 16, seed=6))
    o, lse = fmod.flash_attention_kernel(q, k, v, group=2, return_lse=True)
    args = {"o": o, "do": do, "lse": lse}
    args[bad] = args[bad][:, :-1]
    with pytest.raises(ValueError, match="backward takes"):
        bmod.flash_attention_bwd_kernel(q, k, v, args["o"], args["do"],
                                        args["lse"], group=2)


def test_require_no_grad_names_the_roadmap_item():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(RuntimeError, match="ROADMAP Queue 1, item 23"):
        require_no_grad("rmsnorm", y, x)
    require_no_grad("rmsnorm", y, y)
    with torch.no_grad():
        require_no_grad("rmsnorm", y, x)
