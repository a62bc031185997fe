"""CUDA causal conv + bias + SiLU of the published Mamba-1 mixer: bind and
launch.

The kernel (``repro_torch/csrc/mamba_conv.cu``) replaces no Pallas kernel
(the reference has no Jamba): it takes the place of the mixer's tensor
code, one float32 pass over [T, d] a tap, then the bias, SiLU and a cast,
with one pass that reads the in-projection's first half in place through
its row stride and writes u once in its type.  The source says what
bounds it.

:func:`mamba_conv` takes ``xi [B, T, d]`` (any row stride, the last
dimension contiguous) and the carried window.  A CPU tensor takes the plain
version (:func:`~repro_torch.kernels.mamba_conv.ref.mamba_conv_ref`); a
CUDA tensor launches the kernel or raises, with no fallback; a meta tensor
takes the CUDA checks and empty outputs, no launch.  One launch at every
T; the scan's :func:`~repro_torch.kernels.ssm_scan.kernel.route` names it
(``"step"`` at T = 1, ``"chunked"`` above), so that a request's conv and
scan launches split alike.  A call on CUDA or meta reports its work
(:func:`repro_torch.kernels.work.mamba_conv`) to the active work counter
(:mod:`repro_torch.launch.hlo_cost`).  ``LAUNCHES`` counts launches,
``LAUNCHES_BY_ROUTE`` splits them by route.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Optional, Tuple

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import (KernelLibrary, check_launch,
                                      require_no_grad)
from repro_torch.kernels.common import cdiv, row_stride
from repro_torch.kernels.mamba_conv.ref import mamba_conv_ref
from repro_torch.kernels.ssm_scan.kernel import route
from repro_torch.launch import hlo_cost

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 6 + [_I] * 5 + [_P]
LIBRARY = KernelLibrary("mamba_conv", "mamba_conv.cu",
                        {"mamba_conv_f32": _ARGS, "mamba_conv_bf16": _ARGS})
_ENTRY = {torch.float32: "mamba_conv_f32",
          torch.bfloat16: "mamba_conv_bf16"}
#: The conv width the kernel takes (its register window): the published
#: Mamba's ``d_conv``.
TAPS = 4
#: Steps a thread walks (the source's ``CONV_ROWS``): the grid's second
#: dimension is T over this.
ROWS = 64

#: Kernel launches since the last reset, in all and by route.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"chunked": 0, "step": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0


def _check(xi, conv_w, conv_b, window) -> None:
    if xi.ndim != 3 or conv_w.ndim != 2:
        raise ValueError(f"mamba conv takes xi [B, T, d] and conv_w [K, d], "
                         f"got {tuple(xi.shape)} and {tuple(conv_w.shape)}")
    b, t, d = xi.shape
    k = conv_w.shape[0]
    want = {"conv_w": (conv_w, (k, d)), "conv_b": (conv_b, (d,)),
            "window": (window, (b, k - 1, d))}
    for name, (v, shape) in want.items():
        if v is not None and tuple(v.shape) != shape:
            raise ValueError(f"mamba conv: {name} is {tuple(v.shape)}, "
                             f"expected {shape}")
    if t < 1 or k < 2:
        raise ValueError(f"mamba conv takes T >= 1 and K >= 2, got T={t}, "
                         f"K={k}")
    given = [v for v in (conv_w, conv_b, window) if v is not None]
    if len({xi.device, *(v.device for v in given)}) != 1:
        raise ValueError("mamba conv inputs on several devices")
    if xi.device.type == "cpu":
        return
    if xi.device.type not in ("cuda", "meta"):
        raise ValueError(f"mamba conv runs on cpu, cuda or meta, got "
                         f"{xi.device}")
    if xi.dtype not in _ENTRY or any(v.dtype != xi.dtype for v in given):
        raise TypeError(f"mamba conv kernel takes float32 or bfloat16 xi and "
                        f"weights, bias and window of its dtype, got "
                        f"{xi.dtype}, {[v.dtype for v in given]}")
    if k != TAPS:
        raise ValueError(f"mamba conv kernel takes K = {TAPS}, got {k}")
    if b > 65535 or cdiv(t, ROWS) > 65535:
        raise ValueError("mamba conv kernel: sizes past its grid")
    if not all(v.is_contiguous() for v in given):
        raise ValueError("mamba conv kernel takes contiguous weights, bias "
                         "and window")
    pack = 16 // xi.element_size()
    if d % pack or row_stride(xi) % pack or any(
            v.data_ptr() % 16 for v in (xi, *given)):
        raise ValueError(f"mamba conv kernel loads 16 bytes a thread: d and "
                         f"xi's row stride multiples of {pack}, every "
                         f"pointer 16-byte aligned")
    require_no_grad("mamba conv", xi, *given)


def mamba_conv(xi: torch.Tensor, conv_w: torch.Tensor,
               conv_b: Optional[torch.Tensor],
               window: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xi [B, T, d] (read through its row stride); conv_w [K, d]; conv_b
    [d] or None; window [B, K-1, d], the carried inputs before xi (None:
    zeros, a prefill) -> (u = silu(conv(xi) + conv_b) [B, T, d] in xi's
    dtype, the new window [B, K-1, d]: the last K-1 inputs).  One launch
    on CUDA, counted in ``LAUNCHES`` / ``LAUNCHES_BY_ROUTE``."""
    global LAUNCHES
    _check(xi, conv_w, conv_b, window)
    b, t, d = xi.shape
    k = conv_w.shape[0]
    kind = route(t, xi.dtype, xi.device)
    if kind == "plain":
        return mamba_conv_ref(xi, conv_w, conv_b, window)
    xs = row_stride(xi)
    dev = xi.device
    u = torch.empty((b, t, d), dtype=xi.dtype, device=dev)
    win_out = torch.empty((b, k - 1, d), dtype=xi.dtype, device=dev)
    cost = partial(work.mamba_conv, b, t, d, k, xi.element_size(),
                   window is not None, conv_b is not None)
    if kind == "meta":
        hlo_cost.report_kernel("mamba_conv", cost)
        return u, win_out

    def ptr(v):
        return None if v is None else v.data_ptr()
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, _ENTRY[xi.dtype])(
            xi.data_ptr(), ptr(window), conv_w.data_ptr(), ptr(conv_b),
            u.data_ptr(), win_out.data_ptr(), b, t, d, k, xs, stream)
    check_launch(f"mamba_conv ({kind})", err)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[kind] += 1
    hlo_cost.report_kernel("mamba_conv", cost)
    return u, win_out
