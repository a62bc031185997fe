"""CUDA selective-scan backward: bind and launch.

The kernels (``repro_torch/csrc/ssm_scan_bwd.cu``) are the port's own: the
reference has no backward for its Pallas scan (``jax.grad`` through it
raises); it trains through XLA's autodiff of the chunked ``lax.scan`` in
``repro/models/ssm.py:ssm_scan``.  Given the forward's inputs, the
cotangents ``dy`` of y and ``dh`` of the final state, and what the
forward's chunked route saved (its projection rows and the states
entering each chunk but the first,
:func:`~repro_torch.kernels.ssm_scan.kernel.ssm_scan_kernel` with
``save``), they compute ``dxc``, ``dx_proj``, ``ddt_bias``, ``da_log`` and
``dh0`` with no float atomics: time-parallel scans over spans of 128
steps, walked from the last, that keep every state on chip (forward from
the saved entering states, in reverse from the carried gradient), and the
sums over channels and over (batch, step) as partials added in a fixed
order.  The source says what bounds it;
:func:`~repro_torch.kernels.ssm_scan.ref.ssm_scan_bwd_spans_ref` is the
same decomposition in tensor code.

:func:`ssm_scan_bwd_kernel` takes the plain version
(:func:`~repro_torch.kernels.ssm_scan.ref.ssm_scan_bwd_ref`) for a CPU
tensor; a CUDA tensor launches the kernels (route ``"scan"``) or raises;
a meta tensor takes the CUDA checks and empty gradients, no launch.  A
call on CUDA or meta reports its function's work
(:func:`repro_torch.kernels.work.ssm_bwd`) to the active work counter
(:mod:`repro_torch.launch.hlo_cost`).
``LAUNCHES`` counts calls that launched, ``LAUNCHES_BY_ROUTE`` splits them
by route.  The first design (the chunks re-run through device memory)
stays callable only as :func:`rerun_launch`, for timing beside the
route; it counts no launch.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Optional, Tuple

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.ssm_scan.kernel import (CHUNK, _check, _check_cuda,
                                                 _proj_row_floats, route)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
from repro_torch.launch import hlo_cost

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 15 + [_I] * 4 + [_P]
LIBRARY = KernelLibrary("ssm_scan_bwd", "ssm_scan_bwd.cu", {
    "ssm_scan_bwd_f32": _ARGS,
    "ssm_scan_bwd_bf16": _ARGS,
    "ssm_scan_bwd_scratch_floats": [_I] * 4 + [
        ctypes.POINTER(ctypes.c_int64)],
    # the first design, kept for timing beside the route
    "ssm_scan_bwd_rerun_f32": _ARGS,
    "ssm_scan_bwd_rerun_bf16": _ARGS,
    "ssm_scan_bwd_rerun_scratch_floats": [_I] * 4 + [
        ctypes.POINTER(ctypes.c_int64)],
})
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: Steps of a span of the scan route's walk (the source's ``SPAN``, which
#: is the forward's ``CHUNK``: a span starts where the forward saved h) and
#: channels of a group whose sums over channels one block takes (its
#: ``GROUP_CH``); both fixed when the source is compiled.
SPAN = CHUNK
GROUP = 28

#: Backward calls that launched since the last reset, in all and by route.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"scan": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0


def ssm_scan_bwd_kernel(xc: torch.Tensor, x_proj: torch.Tensor,
                        dt_bias: torch.Tensor, a_log: torch.Tensor,
                        h0: torch.Tensor, dy: torch.Tensor, dh: torch.Tensor,
                        proj: Optional[torch.Tensor] = None,
                        h_end: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The forward's inputs, dy [B, T, d] and dh [B, d, n] (float32), and
    on CUDA the forward's saved ``proj`` and ``h_end`` -> (dxc in xc's
    dtype, dx_proj in x_proj's, ddt_bias, da_log, dh0 in float32)."""
    global LAUNCHES
    got = _check(xc, x_proj, dt_bias, a_log, h0)
    b, t, d = xc.shape
    n = a_log.shape[1]
    if tuple(dy.shape) != (b, t, d) or tuple(dh.shape) != (b, d, n):
        raise ValueError(f"ssm scan backward takes dy {(b, t, d)} and dh "
                         f"{(b, d, n)}, got {tuple(dy.shape)} and "
                         f"{tuple(dh.shape)}")
    if route(t, xc.dtype, xc.device, save=True) == "plain":
        return ssm_scan_bwd_ref(xc, x_proj, dt_bias, a_log, h0, dy, dh)
    _check_cuda(xc, got)
    ends = cdiv(t, CHUNK) - 1
    want = {"proj": (b * t, _proj_row_floats(n)), "h_end": (b, ends, n, d)}
    for name, v in (("proj", proj), ("h_end", h_end)):
        if v is None or tuple(v.shape) != want[name]:
            raise ValueError(f"ssm scan backward takes the forward's saved "
                             f"{name} {want[name]}, got "
                             f"{None if v is None else tuple(v.shape)}")
    inputs = (dy, dh, proj, h_end)
    if any(v.device != xc.device or v.dtype != torch.float32
           or not v.is_contiguous() for v in inputs):
        raise TypeError("ssm scan backward takes contiguous float32 dy, dh "
                        "and saved states on xc's device")
    cost = partial(work.ssm_bwd, b, t, d, n, xc.element_size())
    if xc.device.type == "meta":
        hlo_cost.report_kernel("ssm_scan_bwd", cost)
        return (torch.empty_like(xc), torch.empty_like(x_proj),
                *(torch.empty(shape, dtype=torch.float32, device=xc.device)
                  for shape in ((d,), (d, n), (b, d, n))))
    out = _launch("", xc, x_proj, dt_bias, a_log, h0, dy, dh, proj, h_end)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE["scan"] += 1
    hlo_cost.report_kernel("ssm_scan_bwd", cost)
    return out


def _launch(design: str, xc, x_proj, dt_bias, a_log, h0, dy, dh, proj,
            h_end) -> Tuple[torch.Tensor, ...]:
    """Allocates the outputs and the scratch of ``design`` (``""`` the
    route's, ``"rerun_"`` the first design's) and launches its C entry."""
    b, t, d = xc.shape
    n = a_log.shape[1]
    dev = xc.device
    dxc, dx_proj = torch.empty_like(xc), torch.empty_like(x_proj)
    ddt_bias = torch.empty((d,), dtype=torch.float32, device=dev)
    da_log = torch.empty((d, n), dtype=torch.float32, device=dev)
    dh0 = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    lib = LIBRARY.load()
    floats = ctypes.c_int64()
    getattr(lib, f"ssm_scan_bwd_{design}scratch_floats")(
        b, t, d, n, ctypes.byref(floats))
    scratch = torch.empty(floats.value, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"ssm_scan_bwd_{design}{_SUFFIX[xc.dtype]}")(
            xc.data_ptr(), x_proj.data_ptr(), dt_bias.data_ptr(),
            a_log.data_ptr(), h0.data_ptr(), proj.data_ptr(),
            h_end.data_ptr(), dy.data_ptr(), dh.data_ptr(),
            scratch.data_ptr(), dxc.data_ptr(), dx_proj.data_ptr(),
            ddt_bias.data_ptr(), da_log.data_ptr(), dh0.data_ptr(), b, t, d,
            n, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(f"ssm_scan_bwd ({design or 'scan'})", err)
    return dxc, dx_proj, ddt_bias, da_log, dh0


def rerun_launch(xc, x_proj, dt_bias, a_log, h0, dy, dh, proj, h_end
                 ) -> Tuple[torch.Tensor, ...]:
    """The first design (each chunk's reverse walk from zero, the carries
    between chunks, each chunk re-run from its saved state with h_t
    through device memory) on CUDA inputs the route would take: the same
    results, timed beside the route.  Never a route of the wrapper; counts
    no launch."""
    got = _check(xc, x_proj, dt_bias, a_log, h0)
    _check_cuda(xc, got)
    return _launch("rerun_", xc, x_proj, dt_bias, a_log, h0, dy, dh, proj,
                   h_end)
