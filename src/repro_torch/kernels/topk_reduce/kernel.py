"""CUDA top-k kernels: bind and launch.

The kernels (``repro_torch/csrc/topk_reduce.cu``) replace the reference's
Pallas kernel ``repro/kernels/topk_reduce/kernel.py:topk_reduce_kernel``
(body ``_topk_kernel``): the k best of ``scores[n]`` with entries at or
past ``valid_count`` masked to -inf, ties to the earlier index.  The
source says how the TPU's sequential running buffer crosses blocks on
each route and what bounds it.

:func:`topk_reduce_kernel` takes float32 ``scores [n]``, and :func:`route`
picks its route from k, n and the device alone: a tensor on the CPU takes
the plain version (:func:`~repro_torch.kernels.
topk_reduce.ref.topk_ref`); on CUDA the ``select`` route (one launch:
sorted per-warp lists merged by shuffles, the last block to finish merging
the blocks' lists) takes every k up to ``SELECT_MAX_K``, and the ``tree``
route (levels of block-wide argmax rounds) larger k.  A CUDA tensor
launches its route or raises — there is no fallback.  A meta tensor takes
the CUDA checks and empty outputs of the kernel's shapes and dtypes, no
launch.  A call on CUDA or meta reports its function's work
(:func:`repro_torch.kernels.work.topk`) to the active work counter
(:mod:`repro_torch.launch.hlo_cost`).  ``LAUNCHES`` counts calls that
launched, ``LAUNCHES_BY_ROUTE`` splits them by route.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Tuple, Union

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.topk_reduce.ref import topk_ref
from repro_torch.launch import hlo_cost

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LIBRARY = KernelLibrary("topk_reduce", "topk_reduce.cu", {
    "topk_select_f32": [_P, _L, _P, _I, _P, _P, _P],
    "topk_tree_f32": [_P, _L, _P, _I, _P, _P, _P, _P, _P]})

#: The select route's largest k: a warp's list is one key a lane.
SELECT_MAX_K = 32
#: Candidates a block of the tree route takes (256 threads x 16), and the
#: largest k: each level of the tree must leave fewer candidates than it
#: took.
TILE = 4096
MAX_K = 1024

#: Calls that launched since the last reset, in all and by route.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"select": 0, "tree": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0


def route(k: int, n: int, device) -> str:
    """The route a call takes: ``"plain"`` for a CPU tensor; on CUDA
    ``"select"`` for k up to ``SELECT_MAX_K``, else ``"tree"`` (n does
    not change the route: both take any n below 2**31)."""
    if torch.device(device).type == "cpu":
        return "plain"
    return "select" if k <= SELECT_MAX_K else "tree"


def _valid_on(valid_count: Union[int, torch.Tensor], n: int,
              dev: torch.device) -> torch.Tensor:
    """valid_count as an int32 [1] tensor on ``dev``, without a host
    sync."""
    if torch.is_tensor(valid_count):
        if valid_count.numel() != 1:
            raise ValueError(f"valid_count must be a scalar, got shape "
                             f"{tuple(valid_count.shape)}")
        vc = valid_count.reshape(1).to(dev)
        if vc.dtype != torch.int32:
            vc = torch.clamp(vc, -1, n).to(torch.int32)
        return vc
    return torch.full((1,), max(-1, min(int(valid_count), n)),
                      dtype=torch.int32, device=dev)


def topk_reduce_kernel(scores: torch.Tensor, k: int,
                       valid_count: Union[int, torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores: [n] float32 -> (values [k] float32 descending, indices [k]
    int32)."""
    global LAUNCHES
    if scores.ndim != 1:
        raise ValueError(f"top-k takes scores [n], got "
                         f"{tuple(scores.shape)}")
    n = scores.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"top-k needs 0 <= k <= n, got k={k}, n={n}")
    dev = scores.device
    if dev.type == "cpu":
        return topk_ref(scores, k, valid_count)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"top-k runs on cpu, cuda or meta, got {dev}")
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise TypeError(f"top-k kernel takes contiguous float32 scores, "
                        f"got {scores.dtype}")
    if k > MAX_K or n >= 2 ** 31:
        raise ValueError(f"top-k kernel takes k <= {MAX_K} and n < 2**31, "
                         f"got k={k}, n={n}")
    if k == 0:
        return (torch.empty((0,), dtype=torch.float32, device=dev),
                torch.empty((0,), dtype=torch.int32, device=dev))
    vc = _valid_on(valid_count, n, dev)
    cost = partial(work.topk, n, k)
    if dev.type == "meta":
        hlo_cost.report_kernel("topk_reduce", cost)
        return (torch.empty((k,), dtype=torch.float32, device=dev),
                torch.empty((k,), dtype=torch.int32, device=dev))
    kind = route(k, n, dev)
    if kind == "tree":
        values, indices = tree_launch(scores, k, vc)
    else:
        values = torch.empty((k,), dtype=torch.float32, device=dev)
        indices = torch.empty((k,), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = LIBRARY.load().topk_select_f32(
                scores.data_ptr(), n, vc.data_ptr(), k, values.data_ptr(),
                indices.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        check_launch("topk_reduce (select)", err)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[kind] += 1
    hlo_cost.report_kernel("topk_reduce", cost)
    return values, indices


def tree_launch(scores: torch.Tensor, k: int, vc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tree route's launches, outputs and scratch allocated here (for
    any 1 <= k <= min(n, MAX_K)); counts no launch.  ``vc`` is
    valid_count as an int32 [1] tensor on the device."""
    dev = scores.device
    n = scores.shape[0]
    values = torch.empty((k,), dtype=torch.float32, device=dev)
    indices = torch.empty((k,), dtype=torch.int32, device=dev)
    tiles = cdiv(n, TILE)
    scratch = 2 * tiles * k if tiles > 1 else 1
    sv = torch.empty((scratch,), dtype=torch.float32, device=dev)
    si = torch.empty((scratch,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = LIBRARY.load().topk_tree_f32(
            scores.data_ptr(), n, vc.data_ptr(), k, values.data_ptr(),
            indices.data_ptr(), sv.data_ptr(), si.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("topk_reduce (tree)", err)
    return values, indices
