"""CUDA selective-scan kernel: bind and launch.

The kernels (``repro_torch/csrc/ssm_scan.cu``) replace the reference's
Pallas kernel ``repro/kernels/ssm_scan/kernel.py:ssm_scan_kernel`` (body
``_ssm_kernel``): the projection ``xc @ x_proj`` into B, C and dt, the
discretisation and the recurrence ``h = a * h + dt * x * B``, with
``y = sum_n h * C``, all in float32 and with the state carried from
``h0``.  The source says how the TPU's sequential grid over chunks becomes
a scan that is parallel over T, and what bounds it.

:func:`ssm_scan_kernel` takes ``xc [B, T, d]`` and :func:`route` picks
its route from T and the device alone: a CPU tensor takes the plain
version (:func:`~repro_torch.kernels.ssm_scan.ref.ssm_scan_ref`); on CUDA,
T = 1 (a decode step) takes the step route, one fused launch, and T > 1
the chunked route (projection, chunk ends, carry and re-run).  A CUDA
tensor launches its route or raises: there is no fallback.  ``LAUNCHES``
counts calls that launched (one per call, whatever passes it runs);
``LAUNCHES_BY_ROUTE`` splits them by route.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import (KernelLibrary, check_launch,
                                      require_no_grad)
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_CHUNKED_ARGS = [_P] * 10 + [_I] * 4 + [_P]
_STEP_ARGS = [_P] * 7 + [_I] * 3 + [_P]
_SERIAL_ARGS = [_P] * 8 + [_I] * 4 + [_P]
LIBRARY = KernelLibrary("ssm_scan", "ssm_scan.cu", {
    "ssm_scan_chunked_f32": _CHUNKED_ARGS,
    "ssm_scan_chunked_bf16": _CHUNKED_ARGS,
    "ssm_scan_step_f32": _STEP_ARGS,
    "ssm_scan_step_bf16": _STEP_ARGS,
    # the serial kernel the routes replaced, kept for timing beside them
    "ssm_scan_serial_f32": _SERIAL_ARGS,
    "ssm_scan_serial_bf16": _SERIAL_ARGS,
    "ssm_scan_serial_splits": [_I] * 3,
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


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0


def route(t: int, dtype: torch.dtype, device) -> str:
    """The route a call of ``t`` steps takes: ``"plain"`` for a CPU
    tensor, ``"step"`` for T = 1 on CUDA, ``"chunked"`` for T > 1.  Both
    dtypes the kernels take (float32, bfloat16) have both routes; only the
    chunked route's projection differs (tensor cores for bf16)."""
    del dtype
    if torch.device(device).type == "cpu":
        return "plain"
    return "step" if t == 1 else "chunked"


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
    if xc.device.type != "cuda":
        raise ValueError(f"ssm scan runs on cpu or cuda, got {xc.device}")
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
                    h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: [B, T, d]; x_proj: [d, 2n+1]; dt_bias: [d]; a_log: [d, n];
    h0: [B, d, n] -> (y [B, T, d] f32, h_final [B, d, n] f32)."""
    global LAUNCHES
    got = _check(xc, x_proj, dt_bias, a_log, h0)
    b, t, d = xc.shape
    kind = route(t, xc.dtype, xc.device)
    if kind == "plain":
        return ssm_scan_ref(xc, x_proj, dt_bias, a_log, h0)
    _check_cuda(xc, got)
    require_no_grad("ssm_scan", xc, x_proj, dt_bias, a_log, h0)
    n = a_log.shape[1]
    dev = xc.device
    y = torch.empty((b, t, d), dtype=torch.float32, device=dev)
    h = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    suffix = _SUFFIX[xc.dtype]
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
    check_launch(f"ssm_scan ({kind})", err)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[kind] += 1
    return y, h
