"""CUDA selective-scan kernel: bind and launch.

The kernel (``repro_torch/csrc/ssm_scan.cu``) replaces the reference's
Pallas kernel ``repro/kernels/ssm_scan/kernel.py:ssm_scan_kernel`` (body
``_ssm_kernel``): the projection ``xc @ x_proj`` into B, C and dt, the
discretisation and the recurrence ``h = a * h + dt * x * B``, with
``y = sum_n h * C``, all in float32 and with the state carried from
``h0``.  The source says how the TPU's sequential grid over chunks becomes
two passes and what bounds it.

:func:`ssm_scan_kernel` takes ``xc [B, T, d]``.  A tensor on the CPU takes
the plain version (:func:`~repro_torch.kernels.ssm_scan.ref.ssm_scan_ref`);
a CUDA tensor launches the kernel or raises — there is no fallback.
``LAUNCHES`` counts kernel launches (one per call: both passes).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
LIBRARY = KernelLibrary("ssm_scan", "ssm_scan.cu",
                        {"ssm_scan_f32": _ARGS, "ssm_scan_bf16": _ARGS})
_ENTRY = {torch.float32: "ssm_scan_f32", torch.bfloat16: "ssm_scan_bf16"}
#: Largest state size the kernel takes (one warp's lanes per channel).
MAX_STATE = 32
#: The projection pass takes 64 rows and 32 channels at a time, and splits
#: d into slices until it has this many blocks: two on each of the H100's
#: 132 SMs.
_PROJ_ROWS, _PROJ_K, _PROJ_BLOCKS = 64, 32, 264
_INT_MAX = 2 ** 31 - 1

#: Kernel launches since the last reset.
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def ssm_scan_kernel(xc: torch.Tensor, x_proj: torch.Tensor,
                    dt_bias: torch.Tensor, a_log: torch.Tensor,
                    h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: [B, T, d]; x_proj: [d, 2n+1]; dt_bias: [d]; a_log: [d, n];
    h0: [B, d, n] -> (y [B, T, d] f32, h_final [B, d, n] f32)."""
    global LAUNCHES
    if xc.ndim != 3 or a_log.ndim != 2:
        raise ValueError(f"ssm scan takes xc [B, T, d] and a_log [d, n], "
                         f"got {tuple(xc.shape)} and {tuple(a_log.shape)}")
    b, t, d = xc.shape
    n = a_log.shape[1]
    want = {"x_proj": (d, 2 * n + 1), "dt_bias": (d,), "a_log": (d, n),
            "h0": (b, d, n)}
    got = {"x_proj": x_proj, "dt_bias": dt_bias, "a_log": a_log, "h0": h0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"ssm scan: {name} is {tuple(got[name].shape)}"
                             f", expected {shape}")
    if t < 1 or n < 1:
        raise ValueError(f"ssm scan takes T >= 1 and n >= 1, got T={t}, "
                         f"n={n}")
    if len({xc.device, *(v.device for v in got.values())}) != 1:
        raise ValueError("ssm scan inputs on several devices")
    if xc.device.type == "cpu":
        return ssm_scan_ref(xc, x_proj, dt_bias, a_log, h0)
    if xc.device.type != "cuda":
        raise ValueError(f"ssm scan runs on cpu or cuda, got {xc.device}")
    if xc.dtype not in _ENTRY or x_proj.dtype != xc.dtype:
        raise TypeError(f"ssm scan kernel takes float32 or bfloat16 xc and "
                        f"an x_proj of the same dtype, got {xc.dtype} and "
                        f"{x_proj.dtype}")
    if any(v.dtype != torch.float32 for v in (dt_bias, a_log, h0)):
        raise TypeError("ssm scan kernel takes float32 dt_bias, a_log, h0")
    if n > MAX_STATE:
        raise ValueError(f"ssm scan kernel takes n <= {MAX_STATE}, got {n}")
    if b * t * max(d, 2 * n + 1) > _INT_MAX or b > 65535:
        raise ValueError("ssm scan kernel: sizes past its grid")
    if not all(v.is_contiguous() for v in (xc, *got.values())):
        raise ValueError("ssm scan kernel takes contiguous tensors")
    y = torch.empty((b, t, d), dtype=torch.float32, device=xc.device)
    h = torch.empty((b, d, n), dtype=torch.float32, device=xc.device)
    splits = max(1, min(cdiv(d, _PROJ_K),
                        cdiv(_PROJ_BLOCKS, cdiv(b * t, _PROJ_ROWS))))
    proj = torch.empty((splits, b * t, 2 * n + 1), dtype=torch.float32,
                       device=xc.device)
    lib = LIBRARY.load()
    with torch.cuda.device(xc.device):
        err = getattr(lib, _ENTRY[xc.dtype])(
            xc.data_ptr(), x_proj.data_ptr(), dt_bias.data_ptr(),
            a_log.data_ptr(), h0.data_ptr(), proj.data_ptr(), y.data_ptr(),
            h.data_ptr(), b, t, d, n, splits,
            torch.cuda.current_stream(xc.device).cuda_stream)
    check_launch("ssm_scan", err)
    LAUNCHES += 1
    return y, h
