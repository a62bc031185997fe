"""CUDA top-k kernel: bind and launch.

The kernel (``repro_torch/csrc/topk_reduce.cu``) replaces the reference's
Pallas kernel ``repro/kernels/topk_reduce/kernel.py:topk_reduce_kernel``
(body ``_topk_kernel``): the k best of ``scores[n]`` with entries at or
past ``valid_count`` masked to -inf, ties to the earlier index.  The
source says how the TPU's sequential running buffer becomes a tree of
tiles and what bounds it.

:func:`topk_reduce_kernel` takes float32 ``scores [n]``.  A tensor on the
CPU takes the plain version (:func:`~repro_torch.kernels.topk_reduce.ref.
topk_ref`); a CUDA tensor launches the kernel or raises — there is no
fallback.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.topk_reduce.ref import topk_ref

LIBRARY = KernelLibrary("topk_reduce", "topk_reduce.cu", {
    "topk_f32": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]})

#: Candidates a block takes (256 threads x 16), and the largest k: each
#: level of the tree must leave fewer candidates than it took.
TILE = 4096
MAX_K = 1024

#: Kernel launches since the last reset.
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


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
    if dev.type != "cuda":
        raise ValueError(f"top-k runs on cpu or cuda, got {dev}")
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise TypeError(f"top-k kernel takes contiguous float32 scores, "
                        f"got {scores.dtype}")
    if k > MAX_K or n >= 2 ** 31:
        raise ValueError(f"top-k kernel takes k <= {MAX_K} and n < 2**31, "
                         f"got k={k}, n={n}")
    values = torch.empty((k,), dtype=torch.float32, device=dev)
    indices = torch.empty((k,), dtype=torch.int32, device=dev)
    if k == 0:
        return values, indices
    vc = _valid_on(valid_count, n, dev)
    tiles = cdiv(n, TILE)
    scratch = 2 * tiles * k if tiles > 1 else 1
    sv = torch.empty((scratch,), dtype=torch.float32, device=dev)
    si = torch.empty((scratch,), dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.topk_f32(scores.data_ptr(), n, vc.data_ptr(), k,
                           values.data_ptr(), indices.data_ptr(),
                           sv.data_ptr(), si.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    check_launch("topk_reduce", err)
    LAUNCHES += 1
    return values, indices
