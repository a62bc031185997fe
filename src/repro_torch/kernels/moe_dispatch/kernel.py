"""CUDA MoE dispatch kernel: bind and launch.

The kernel (``repro_torch/csrc/moe_dispatch.cu``) replaces the
reference's Pallas kernel ``repro/kernels/moe_dispatch/kernel.py:
moe_dispatch_kernel`` (body ``_dispatch_kernel``): for each group id its
stable slot within its group, plus the groups' sizes.  The source says
how the TPU's sequential carry becomes three passes and what bounds it.

:func:`moe_dispatch_kernel` takes ``assignments [n]`` int32.  A tensor on
the CPU takes the plain version (:func:`~repro_torch.kernels.
moe_dispatch.ref.dispatch_ref`); a CUDA tensor launches the kernel or
raises — there is no fallback.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.moe_dispatch.ref import dispatch_ref

LIBRARY = KernelLibrary("moe_dispatch", "moe_dispatch.cu", {
    "moe_dispatch_i32": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p]})

#: Per-warp group histograms live in shared memory: at most 227 KB a
#: block on Hopper, so at most this many groups.
MAX_GROUPS = 227 * 1024 // 4
_SMEM_DEFAULT = 48 * 1024

#: Kernel launches since the last reset.
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def moe_dispatch_kernel(assignments: torch.Tensor, num_groups: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """assignments: [n] int32 -> (positions [n], counts [num_groups])
    int32."""
    global LAUNCHES
    if assignments.ndim != 1:
        raise ValueError(f"moe_dispatch takes assignments [n], got "
                         f"{tuple(assignments.shape)}")
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    dev = assignments.device
    if dev.type == "cpu":
        return dispatch_ref(assignments, num_groups)
    if dev.type != "cuda":
        raise ValueError(f"moe_dispatch runs on cpu or cuda, got {dev}")
    if assignments.dtype != torch.int32 or not assignments.is_contiguous():
        raise TypeError(f"moe_dispatch kernel takes contiguous int32 "
                        f"assignments, got {assignments.dtype}")
    if num_groups > MAX_GROUPS:
        raise ValueError(f"moe_dispatch kernel takes at most {MAX_GROUPS} "
                         f"groups, got {num_groups}")
    n = assignments.shape[0]
    positions = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return positions, torch.zeros((num_groups,), dtype=torch.int32,
                                      device=dev)
    counts = torch.empty((num_groups,), dtype=torch.int32, device=dev)
    # tiles of at least num_groups elements keep the [G, tiles] scratch
    # within n + G ints
    chunks = max(8, cdiv(num_groups, 32))
    tiles = cdiv(n, 32 * chunks)
    warps = max(1, min(4, _SMEM_DEFAULT // (4 * num_groups)))
    scratch = torch.empty((num_groups * tiles if tiles > 1 else 1,),
                          dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.moe_dispatch_i32(
            assignments.data_ptr(), n, num_groups, chunks, warps,
            positions.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("moe_dispatch", err)
    LAUNCHES += 1
    return positions, counts
