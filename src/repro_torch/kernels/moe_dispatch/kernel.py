"""CUDA MoE dispatch kernels: bind and launch.

The kernels (``repro_torch/csrc/moe_dispatch.cu``) replace the
reference's Pallas kernel ``repro/kernels/moe_dispatch/kernel.py:
moe_dispatch_kernel`` (body ``_dispatch_kernel``): for each group id its
stable slot within its group, plus the groups' sizes.  The source says
how the TPU's sequential carry crosses blocks on each route and what
bounds it.

:func:`moe_dispatch_kernel` takes ``assignments [n]`` int32, and
:func:`route` picks its route from n, the group count and the device
alone: a CPU tensor takes the plain version (:func:`~repro_torch.kernels.
moe_dispatch.ref.dispatch_ref`); on CUDA the ``cluster`` route (one
launch: one thread-block cluster ranks the ids and adds the earlier
blocks' counts through distributed shared memory) takes every input of
at most ``CLUSTER_REACH`` ids over at most ``CLUSTER_GROUPS`` groups,
and the ``tiled`` route (three passes) the rest.  A CUDA tensor launches
its route or raises — there is no fallback.  A meta tensor takes the CUDA
checks and empty outputs of the kernel's shapes and dtypes, no launch.
A call on CUDA or meta reports its function's work
(:func:`repro_torch.kernels.work.dispatch`) to the active work counter
(:mod:`repro_torch.launch.hlo_cost`).  ``LAUNCHES`` counts calls
that launched, ``LAUNCHES_BY_ROUTE`` splits them by route.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Tuple

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.moe_dispatch.ref import dispatch_ref
from repro_torch.launch import hlo_cost

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LIBRARY = KernelLibrary("moe_dispatch", "moe_dispatch.cu", {
    "moe_dispatch_cluster_i32": [_P, _L, _I, _P, _P, _P],
    "moe_dispatch_cluster_width": [],
    "moe_dispatch_tiled_i32": [_P, _L, _I, _I, _I, _P, _P, _P, _P]})

#: The cluster route's reach: a portable cluster of 8 blocks of 32 warps
#: at 16 ids a lane (constants of the source), and the most groups its
#: per-warp histograms hold in shared memory.
CLUSTER_REACH = 8 * 1024 * 16
CLUSTER_GROUPS = 1024
#: The tiled route's per-warp group histograms live in shared memory: at
#: most 227 KB a block on Hopper, so at most this many groups.
MAX_GROUPS = 227 * 1024 // 4
_SMEM_DEFAULT = 48 * 1024

#: Calls that launched since the last reset, in all and by route.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"cluster": 0, "tiled": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0


def route(n: int, num_groups: int, device) -> str:
    """The route a call takes: ``"plain"`` for a CPU tensor; on CUDA
    ``"cluster"`` for at most ``CLUSTER_REACH`` ids over at most
    ``CLUSTER_GROUPS`` groups, else ``"tiled"``."""
    if torch.device(device).type == "cpu":
        return "plain"
    if n <= CLUSTER_REACH and num_groups <= CLUSTER_GROUPS:
        return "cluster"
    return "tiled"


def tiled_launch(assignments: torch.Tensor, num_groups: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tiled route's launch, outputs and scratch allocated here (for
    any n >= 1); counts no launch."""
    dev = assignments.device
    n = assignments.shape[0]
    positions = torch.empty((n,), dtype=torch.int32, device=dev)
    counts = torch.empty((num_groups,), dtype=torch.int32, device=dev)
    # tiles of at least num_groups elements keep the [G, tiles] scratch
    # within n + G ints
    chunks = max(8, cdiv(num_groups, 32))
    tiles = cdiv(n, 32 * chunks)
    warps = max(1, min(4, _SMEM_DEFAULT // (4 * num_groups)))
    scratch = torch.empty((num_groups * tiles if tiles > 1 else 1,),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = LIBRARY.load().moe_dispatch_tiled_i32(
            assignments.data_ptr(), n, num_groups, chunks, warps,
            positions.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("moe_dispatch (tiled)", err)
    return positions, counts


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
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"moe_dispatch runs on cpu, cuda or meta, got "
                         f"{dev}")
    if assignments.dtype != torch.int32 or not assignments.is_contiguous():
        raise TypeError(f"moe_dispatch kernel takes contiguous int32 "
                        f"assignments, got {assignments.dtype}")
    if num_groups > MAX_GROUPS:
        raise ValueError(f"moe_dispatch kernel takes at most {MAX_GROUPS} "
                         f"groups, got {num_groups}")
    n = assignments.shape[0]
    if n == 0:
        return (torch.empty((0,), dtype=torch.int32, device=dev),
                torch.zeros((num_groups,), dtype=torch.int32, device=dev))
    cost = partial(work.dispatch, n, num_groups)
    if dev.type == "meta":
        hlo_cost.report_kernel("moe_dispatch", cost)
        return (torch.empty((n,), dtype=torch.int32, device=dev),
                torch.empty((num_groups,), dtype=torch.int32, device=dev))
    kind = route(n, num_groups, dev)
    if kind == "tiled":
        positions, counts = tiled_launch(assignments, num_groups)
    else:
        positions = torch.empty((n,), dtype=torch.int32, device=dev)
        counts = torch.empty((num_groups,), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = LIBRARY.load().moe_dispatch_cluster_i32(
                assignments.data_ptr(), n, num_groups, positions.data_ptr(),
                counts.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        check_launch("moe_dispatch (cluster)", err)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[kind] += 1
    hlo_cost.report_kernel("moe_dispatch", cost)
    return positions, counts
