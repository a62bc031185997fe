"""CUDA segment-sum kernel: build, bind and launch.

The kernel (``repro_torch/csrc/segment_sum.cu``) replaces the reference's
Pallas kernel ``repro/kernels/segment_reduce/kernel.py:segment_sum_tiled``
(body ``_segment_sum_tiled_kernel``): a masked keyed sum into a bounded
table, plus per-key counts and an overflow count of valid out-of-range
keys.  The source says what bounds it and why it scatters with atomics
instead of the TPU's one-hot matmul.

It is compiled at first use by the port's shared build helper
(:mod:`repro_torch.kernels.build`) into a shared library with a plain C
interface and loaded with ``ctypes``.

:func:`segment_sum` is the only entry point.  A tensor on the CPU takes
the plain version (:func:`~repro_torch.kernels.segment_reduce.ref.
segment_sum_ref`); a CUDA tensor launches the kernel or raises — there is
no fallback.  ``LAUNCHES`` counts kernel launches, so a run can show that
its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.segment_reduce.ref import segment_sum_ref

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
LIBRARY = KernelLibrary("segment_sum", "segment_sum.cu",
                        {"segment_sum_i32": _ARGS, "segment_sum_f32": _ARGS})

#: Kernel launches since the last reset (a plain counter, read by tests
#: and by chip_smoke.py to prove the main path ran through the kernel).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


_ENTRY = {torch.int32: "segment_sum_i32", torch.float32: "segment_sum_f32"}


def _check(keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
           num_keys: int) -> None:
    if values.dtype not in _ENTRY:
        raise TypeError(f"segment_sum kernel takes int32 or float32 values, "
                        f"got {values.dtype}")
    if keys.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"segment_sum kernel takes int32 keys and bool "
                        f"valid, got {keys.dtype} and {valid.dtype}")
    if values.ndim != 2 or keys.ndim != 1 or valid.shape != keys.shape \
            or values.shape[0] != keys.shape[0]:
        raise ValueError(f"segment_sum kernel takes keys [n], values [n, d] "
                         f"and valid [n], got {tuple(keys.shape)}, "
                         f"{tuple(values.shape)} and {tuple(valid.shape)}")
    devs = {keys.device, values.device, valid.device}
    if len(devs) != 1:
        raise ValueError(f"segment_sum inputs on several devices: {devs}")
    if not (keys.is_contiguous() and values.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("segment_sum kernel takes contiguous tensors")
    if num_keys < 1:
        raise ValueError(f"num_keys must be >= 1, got {num_keys}")


def segment_sum(keys: torch.Tensor, values: torch.Tensor, num_keys: int,
                valid: torch.Tensor):
    """Masked keyed sum.

    ``keys`` [n] int32, ``values`` [n, d] int32 or float32, ``valid`` [n]
    bool -> ``(table [num_keys, d], counts [num_keys] int32, overflow [1]
    int32)``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (none for ``n == 0``).
    """
    global LAUNCHES
    _check(keys, values, valid, num_keys)
    dev = keys.device
    if dev.type == "cpu":
        return segment_sum_ref(keys, values, num_keys, valid)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on cpu or cuda, got {dev}")
    n, d = values.shape
    table = torch.zeros((num_keys, d), dtype=values.dtype, device=dev)
    counts = torch.zeros((num_keys,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    if n == 0:
        return table, counts, overflow
    lib = LIBRARY.load()
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 16
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, _ENTRY[values.dtype])(
            keys.data_ptr(), values.data_ptr(), valid.data_ptr(), n, d,
            num_keys, table.data_ptr(), counts.data_ptr(),
            overflow.data_ptr(), blocks, stream)
    check_launch("segment_sum", err)
    LAUNCHES += 1
    return table, counts, overflow
