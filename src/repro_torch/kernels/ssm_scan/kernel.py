"""CUDA selective-scan kernel: bind and launch.

The kernels (``repro_torch/csrc/ssm_scan.cu``) replace the reference's
Pallas kernel ``repro/kernels/ssm_scan/kernel.py:ssm_scan_kernel`` (body
``_ssm_kernel``): the projection ``xc @ x_proj`` into B, C and dt, the
discretisation and the recurrence ``h = a * h + dt * x * B``, with
``y = sum_n h * C``, all in float32 and with the state carried from
``h0``.  The source says how the TPU's sequential grid over chunks becomes
a scan that is parallel over T, and what bounds it.

:func:`ssm_scan_kernel` takes ``xc [B, T, d]`` and :func:`route` picks
its route from T, the device and whether the call saves for a gradient:
a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.ssm_scan.ref.ssm_scan_ref`); on CUDA, T = 1
(a decode step) takes the step route, one fused launch, and T > 1 or a
call that ``save``s the chunked route (projection, chunk ends, carry and
re-run), whose projection rows and chunk-entering states the backward
(:mod:`~repro_torch.kernels.ssm_scan.backward`) starts from.  The kernel
writes through raw pointers, so a CUDA input that requires grad in grad
mode raises here: gradients go through
:class:`~repro_torch.kernels.ssm_scan.ops.SSMScan`, which
:func:`~repro_torch.kernels.ssm_scan.ops.ssm_scan_fused` picks.  A meta
tensor takes ``"meta"``: the CUDA checks and empty outputs of the
kernel's shapes and dtypes (the saved states too), no launch.  A CUDA
tensor launches its route or raises: there is no fallback.  A call on
CUDA or meta reports its function's work
(:func:`repro_torch.kernels.work.ssm`) to the active work counter
(:mod:`repro_torch.launch.hlo_cost`).  ``LAUNCHES``
counts calls that launched (one per call, whatever passes it runs);
``LAUNCHES_BY_ROUTE`` splits them by route.
"""
from __future__ import annotations

import ctypes
from functools import partial
import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.common import cdiv, row_stride
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_dt_ref,
                                              ssm_scan_ref)
from repro_torch.launch import hlo_cost

_P, _I = ctypes.c_void_p, ctypes.c_int
_CHUNKED_ARGS = [_P] * 10 + [_I] * 4 + [_P]
_STEP_ARGS = [_P] * 7 + [_I] * 3 + [_P]
_SERIAL_ARGS = [_P] * 8 + [_I] * 4 + [_P]
_DT_CHUNKED_ARGS = [_P] * 13 + [_I] * 5 + [_P]
_DT_STEP_ARGS = [_P] * 11 + [_I] * 4 + [_P]
LIBRARY = KernelLibrary("ssm_scan", "ssm_scan.cu", {
    "ssm_scan_chunked_f32": _CHUNKED_ARGS,
    "ssm_scan_chunked_bf16": _CHUNKED_ARGS,
    "ssm_scan_step_f32": _STEP_ARGS,
    "ssm_scan_step_bf16": _STEP_ARGS,
    # the serial kernel the routes replaced, kept for timing beside them
    "ssm_scan_serial_f32": _SERIAL_ARGS,
    "ssm_scan_serial_bf16": _SERIAL_ARGS,
    "ssm_scan_serial_splits": [_I] * 3,
    # the dt route: dt a channel, B and C given, the mixer's gate after it
    "ssm_scan_dt_chunked_f32": _DT_CHUNKED_ARGS,
    "ssm_scan_dt_chunked_bf16": _DT_CHUNKED_ARGS,
    "ssm_scan_dt_step_f32": _DT_STEP_ARGS,
    "ssm_scan_dt_step_bf16": _DT_STEP_ARGS,
})
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: Largest state size the kernels take (their register arrays).
MAX_STATE = 32
#: Steps a chunk of the chunked route (the source's ``CHUNK``, fixed when
#: it is compiled).
CHUNK = 128
_INT_MAX = 2 ** 31 - 1

#: Calls that launched since the last reset, in all and by route.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"chunked": 0, "step": 0}
#: Calls of the dt route (:func:`ssm_scan_dt_kernel`) that launched, in
#: all and by route; the counters above count the fused route alone.
DT_LAUNCHES = 0
DT_LAUNCHES_BY_ROUTE = {"chunked": 0, "step": 0}


def reset_launches() -> None:
    global LAUNCHES, DT_LAUNCHES
    LAUNCHES = DT_LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0
        DT_LAUNCHES_BY_ROUTE[name] = 0


def route(t: int, dtype: torch.dtype, device, save: bool = False) -> str:
    """The route a call of ``t`` steps takes: ``"plain"`` for a CPU
    tensor, ``"meta"`` for a meta tensor, ``"step"`` for T = 1 on CUDA,
    ``"chunked"`` for T > 1 and for every call that ``save``s what the
    backward starts from (only the chunked route writes it).  Both dtypes
    the kernels take (float32, bfloat16) have both routes; only the
    chunked route's projection differs (tensor cores for bf16)."""
    del dtype
    kind = torch.device(device).type
    if kind in ("cpu", "meta"):
        return "plain" if kind == "cpu" else "meta"
    return "step" if t == 1 and not save else "chunked"


def _proj_row_floats(n: int) -> int:
    """Floats a step of the chunked route's projection scratch holds: B, C
    and dt in slots of n rounded up to 4, 8, 16 or 32, padded to a
    16-byte row (the source's ``row_floats``)."""
    slots = next(s for s in (4, 8, 16, MAX_STATE) if n <= s)
    return 2 * slots + 4


def _check(xc, x_proj, dt_bias, a_log, h0) -> dict:
    if xc.ndim != 3 or a_log.ndim != 2:
        raise ValueError(f"ssm scan takes xc [B, T, d] and a_log [d, n], "
                         f"got {tuple(xc.shape)} and {tuple(a_log.shape)}")
    b, _, d = xc.shape
    n = a_log.shape[1]
    want = {"x_proj": (d, 2 * n + 1), "dt_bias": (d,), "a_log": (d, n),
            "h0": (b, d, n)}
    got = {"x_proj": x_proj, "dt_bias": dt_bias, "a_log": a_log, "h0": h0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"ssm scan: {name} is {tuple(got[name].shape)}"
                             f", expected {shape}")
    if xc.shape[1] < 1 or n < 1:
        raise ValueError(f"ssm scan takes T >= 1 and n >= 1, got "
                         f"T={xc.shape[1]}, n={n}")
    if len({xc.device, *(v.device for v in got.values())}) != 1:
        raise ValueError("ssm scan inputs on several devices")
    return got


def _check_cuda(xc, got: dict) -> None:
    """The kernel's checks, on a CUDA or a meta tensor."""
    if xc.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssm scan runs on cpu, cuda or meta, got "
                         f"{xc.device}")
    if xc.dtype not in _SUFFIX or got["x_proj"].dtype != xc.dtype:
        raise TypeError(f"ssm scan kernel takes float32 or bfloat16 xc and "
                        f"an x_proj of the same dtype, got {xc.dtype} and "
                        f"{got['x_proj'].dtype}")
    if any(got[k].dtype != torch.float32 for k in ("dt_bias", "a_log",
                                                   "h0")):
        raise TypeError("ssm scan kernel takes float32 dt_bias, a_log, h0")
    b, t, d = xc.shape
    n = got["a_log"].shape[1]
    if n > MAX_STATE:
        raise ValueError(f"ssm scan kernel takes n <= {MAX_STATE}, got {n}")
    if b * t * max(d, 2 * n + 1) > _INT_MAX or b > 65535:
        raise ValueError("ssm scan kernel: sizes past its grid")
    if not all(v.is_contiguous() for v in (xc, *got.values())):
        raise ValueError("ssm scan kernel takes contiguous tensors")


def ssm_scan_kernel(xc: torch.Tensor, x_proj: torch.Tensor,
                    dt_bias: torch.Tensor, a_log: torch.Tensor,
                    h0: torch.Tensor, save: bool = False) -> tuple:
    """xc: [B, T, d]; x_proj: [d, 2n+1]; dt_bias: [d]; a_log: [d, n];
    h0: [B, d, n] -> (y [B, T, d] f32, h_final [B, d, n] f32), one launch
    of the route :func:`route` picks.  With ``save``, (y, h_final, saved):
    on CUDA ``saved`` is the chunked route's scratch the backward starts
    from, its projection rows ``[B*T, row]`` (B, C and dt in slots, see
    :func:`_proj_row_floats`) and the states entering chunks 1 .. nc-1,
    ``h_end [B, nc-1, n, d]``; on the CPU ``()``."""
    global LAUNCHES
    got = _check(xc, x_proj, dt_bias, a_log, h0)
    b, t, d = xc.shape
    kind = route(t, xc.dtype, xc.device, save)
    if kind == "plain":
        y, h = ssm_scan_ref(xc, x_proj, dt_bias, a_log, h0)
        return (y, h, ()) if save else (y, h)
    _check_cuda(xc, got)
    if torch.is_grad_enabled() and any(v.requires_grad
                                       for v in (xc, *got.values())):
        raise RuntimeError("the ssm_scan kernel writes through raw pointers"
                           ", so autograd would drop every gradient through"
                           " it: where grads are taken call "
                           "ops.ssm_scan_fused (SSMScan)")
    n = a_log.shape[1]
    dev = xc.device
    y = torch.empty((b, t, d), dtype=torch.float32, device=dev)
    h = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    cost = partial(work.ssm, b, t, d, n, xc.element_size(), save=save)
    if kind == "meta":
        ends = cdiv(t, CHUNK) - 1
        saved = (torch.empty((b * t, _proj_row_floats(n)),
                             dtype=torch.float32, device=dev),
                 torch.empty((b, ends, n, d), dtype=torch.float32,
                             device=dev)) if save else ()
        hlo_cost.report_kernel("ssm_scan", cost)
        return (y, h, saved) if save else (y, h)
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    suffix = _SUFFIX[xc.dtype]
    saved: tuple = ()
    with torch.cuda.device(dev):
        if kind == "step":
            err = getattr(lib, f"ssm_scan_step_{suffix}")(
                xc.data_ptr(), x_proj.data_ptr(), dt_bias.data_ptr(),
                a_log.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(),
                b, d, n, stream)
        else:
            ends = cdiv(t, CHUNK) - 1
            sizes = (b * t * _proj_row_floats(n), b * ends * d * n,
                     b * ends * d)
            scratch = torch.empty(sum(sizes), dtype=torch.float32,
                                  device=dev)
            proj, h_end, dt_sum = torch.split(scratch, sizes)
            err = getattr(lib, f"ssm_scan_chunked_{suffix}")(
                xc.data_ptr(), x_proj.data_ptr(), dt_bias.data_ptr(),
                a_log.data_ptr(), h0.data_ptr(), proj.data_ptr(),
                h_end.data_ptr(), dt_sum.data_ptr(), y.data_ptr(),
                h.data_ptr(), b, t, d, n, stream)
            if save:
                saved = (proj.view(b * t, _proj_row_floats(n)),
                         h_end.view(b, ends, n, d))
    check_launch(f"ssm_scan ({kind})", err)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[kind] += 1
    hlo_cost.report_kernel("ssm_scan", cost)
    return (y, h, saved) if save else (y, h)


# ---------------------------------------------------------------------------
# The dt route: dt a channel, B and C given (the published Mamba-1 mixer)
# ---------------------------------------------------------------------------

def _check_dt(u, dt, dt_bias, bm, cm, a_log, h0, z, d_skip) -> None:
    if u.ndim != 3 or a_log.ndim != 2:
        raise ValueError(f"ssm dt scan takes u [B, T, d] and a_log [d, n], "
                         f"got {tuple(u.shape)} and {tuple(a_log.shape)}")
    b, t, d = u.shape
    n = a_log.shape[1]
    want = {"dt": (b, t, d), "dt_bias": (d,), "B": (b, t, n),
            "C": (b, t, n), "a_log": (d, n), "h0": (b, d, n),
            "z": (b, t, d), "d_skip": (d,)}
    got = {"dt": dt, "dt_bias": dt_bias, "B": bm, "C": cm, "a_log": a_log,
           "h0": h0, "z": z, "d_skip": d_skip}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"ssm dt scan: {name} is "
                             f"{tuple(got[name].shape)}, expected {shape}")
    if t < 1 or n < 1:
        raise ValueError(f"ssm dt scan takes T >= 1 and n >= 1, got T={t}, "
                         f"n={n}")
    if len({u.device, *(v.device for v in got.values())}) != 1:
        raise ValueError("ssm dt scan inputs on several devices")
    if u.device.type == "cpu":
        return
    if u.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssm dt scan runs on cpu, cuda or meta, got "
                         f"{u.device}")
    if u.dtype not in _SUFFIX or any(v.dtype != u.dtype
                                     for v in (dt, bm, cm, z)):
        raise TypeError(f"ssm dt scan kernel takes float32 or bfloat16 u, "
                        f"dt, B, C and z of one dtype, got {u.dtype}, "
                        f"{dt.dtype}, {bm.dtype}, {cm.dtype}, {z.dtype}")
    if any(v.dtype != torch.float32 for v in (dt_bias, a_log, h0, d_skip)):
        raise TypeError("ssm dt scan kernel takes float32 dt_bias, a_log, "
                        "h0, d_skip")
    if n > MAX_STATE:
        raise ValueError(f"ssm dt scan kernel takes n <= {MAX_STATE}, "
                         f"got {n}")
    if b * t * d > _INT_MAX or b > 65535:
        raise ValueError("ssm dt scan kernel: sizes past its grid")
    row_stride(z)
    if not all(v.is_contiguous() for v in (u, *got.values()) if v is not z):
        raise ValueError("ssm dt scan kernel takes contiguous tensors but z")
    if torch.is_grad_enabled() and any(v.requires_grad
                                       for v in (u, *got.values())):
        raise RuntimeError("the ssm dt scan has no backward: call it where "
                           "no gradient is taken")


def ssm_scan_dt_kernel(u: torch.Tensor, dt: torch.Tensor,
                       dt_bias: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a_log: torch.Tensor,
                       h0: torch.Tensor, z: torch.Tensor,
                       d_skip: torch.Tensor) -> tuple:
    """The dt route with the mixer's gate: u [B, T, d]; dt [B, T, d]
    (before ``dt_bias`` and softplus); ``bm``, ``cm`` [B, T, n] (u's dtype
    on CUDA); dt_bias [d], a_log [d, n], h0 [B, d, n] float32; the gate z
    [B, T, d] (read through its row stride, see
    :func:`~repro_torch.kernels.common.row_stride`) and d_skip
    [d] float32 -> (out = T(T(y + d_skip u) T(silu(z))) [B, T, d] in u's
    dtype T, h_final [B, d, n] f32).  :func:`route` picks as for the fused
    route (``"step"`` at T = 1, ``"chunked"`` above it, ``"plain"`` on the
    CPU: :func:`~repro_torch.kernels.ssm_scan.ref.ssm_scan_dt_ref`;
    ``"meta"``).  One launch a call on CUDA, counted in
    ``DT_LAUNCHES`` / ``DT_LAUNCHES_BY_ROUTE``; its work
    (:func:`repro_torch.kernels.work.ssm_dt`) goes to the active work
    counter."""
    global DT_LAUNCHES
    _check_dt(u, dt, dt_bias, bm, cm, a_log, h0, z, d_skip)
    b, t, d = u.shape
    n = a_log.shape[1]
    kind = route(t, u.dtype, u.device)
    if kind == "plain":
        return ssm_scan_dt_ref(u, dt, dt_bias, bm, cm, a_log, h0, z, d_skip)
    dev = u.device
    out = torch.empty((b, t, d), dtype=u.dtype, device=dev)
    h = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    cost = partial(work.ssm_dt, b, t, d, n, u.element_size())
    if kind == "meta":
        hlo_cost.report_kernel("ssm_scan", cost)
        return out, h
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    suffix = _SUFFIX[u.dtype]
    zs = row_stride(z)
    ptrs = (u.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            z.data_ptr(), dt_bias.data_ptr(), d_skip.data_ptr(),
            a_log.data_ptr(), h0.data_ptr())
    with torch.cuda.device(dev):
        if kind == "step":
            err = getattr(lib, f"ssm_scan_dt_step_{suffix}")(
                *ptrs, out.data_ptr(), h.data_ptr(), b, d, n, zs, stream)
        else:
            ends = cdiv(t, CHUNK) - 1
            sizes = (b * ends * n * d, b * ends * d)
            scratch = torch.empty(max(1, sum(sizes)), dtype=torch.float32,
                                  device=dev)
            h_end, dt_sum = torch.split(scratch[:sum(sizes)], sizes)
            err = getattr(lib, f"ssm_scan_dt_chunked_{suffix}")(
                *ptrs, h_end.data_ptr(), dt_sum.data_ptr(), out.data_ptr(),
                h.data_ptr(), b, t, d, n, zs, stream)
    check_launch(f"ssm_scan dt ({kind})", err)
    DT_LAUNCHES += 1
    DT_LAUNCHES_BY_ROUTE[kind] += 1
    hlo_cost.report_kernel("ssm_scan", cost)
    return out, h
