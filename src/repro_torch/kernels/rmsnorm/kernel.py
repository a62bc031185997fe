"""CUDA RMSNorm kernel: bind and launch.

The kernel (``repro_torch/csrc/rmsnorm.cu``) replaces the reference's
Pallas kernel ``repro/kernels/rmsnorm/kernel.py:rmsnorm_kernel`` (body
``_rmsnorm_kernel``): ``x * rsqrt(mean(x**2) + eps) * w`` per row, in f32,
cast back to x's dtype.  The source says what bounds it.

:func:`rmsnorm_kernel` takes ``x [rows, d]``.  A tensor on the CPU takes
the plain version (:func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`);
a CUDA tensor launches the kernel or raises — there is no fallback.
:func:`path` names the kernel's path for a call: ``"one_pass"`` (the row
kept in registers) where the width and alignment allow, else two passes
over the row (``"loop16"``, 16 bytes a lane, or ``"loop"``).
``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_PATH`` splits them by
path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (KernelLibrary, check_launch,
                                      require_no_grad)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
LIBRARY = KernelLibrary("rmsnorm", "rmsnorm.cu",
                        {"rmsnorm_f32": _ARGS, "rmsnorm_bf16": _ARGS})
_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}

#: Most 16-byte packs a row of the one-pass path holds (d <= 8192 in
#: bf16, <= 4096 in float32).
ONE_PASS_MAX_PACKS = 1024
_MODE = {"one_pass": 2, "loop16": 1, "loop": 0}

#: Kernel launches since the last reset, in all and by path.
LAUNCHES = 0
LAUNCHES_BY_PATH = {"one_pass": 0, "loop16": 0, "loop": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_PATH:
        LAUNCHES_BY_PATH[name] = 0


def path(d: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The kernel's path for rows of width ``d``: ``"one_pass"`` when
    ``d`` is a whole number of 16-byte packs, at most
    :data:`ONE_PASS_MAX_PACKS`, and every pointer is 16-byte aligned;
    ``"loop16"`` (two passes, 16 bytes a lane) when only the first and
    last hold; else ``"loop"`` (two passes, one element a lane)."""
    per16 = 16 // dtype.itemsize
    if d % per16 or not aligned:
        return "loop"
    return "one_pass" if d // per16 <= ONE_PASS_MAX_PACKS else "loop16"


def rmsnorm_kernel(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x: [rows, d], weight: [d] -> [rows, d] in x's dtype."""
    global LAUNCHES
    if x.ndim != 2 or weight.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm kernel takes x [rows, d] and weight "
                         f"[d], got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    if x.device != weight.device:
        raise ValueError(f"rmsnorm inputs on {x.device} and "
                         f"{weight.device}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda, got {x.device}")
    require_no_grad("rmsnorm", x, weight)
    if x.dtype not in _ENTRY or weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x and a "
                        f"weight of the same dtype, got {x.dtype} and "
                        f"{weight.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous tensors")
    rows, d = x.shape
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return out
    kind = path(d, x.dtype, all(t.data_ptr() % 16 == 0
                                for t in (x, weight, out)))
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
            float(eps), _MODE[kind],
            torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("rmsnorm", err)
    LAUNCHES += 1
    LAUNCHES_BY_PATH[kind] += 1
    return out
