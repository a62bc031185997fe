"""CUDA flash-attention backward: bind and launch.

The kernels (``repro_torch/csrc/flash_attention_bwd.cu``) are the port's
own: the reference has no backward kernel (no ``pl.pallas_call`` computes
a gradient, and ``jax.grad`` through its Pallas forward raises); it
trains through XLA's autodiff of ``attention_ref``.  Given the forward's
inputs, its output ``o``, the output's gradient ``do`` and the rows'
log-sum-exp ``lse`` (the forward kernel's second output), they compute
``dq``, ``dk`` and ``dv`` on the flattened layout, GQA's ``dk``/``dv``
summed over the group's query heads, with no float atomics: a delta
pre-pass, one kernel over key tiles and one over query tiles, both
recomputing P from ``lse``.

:func:`flash_attention_bwd_kernel` takes its route as the forward does
(:func:`~repro_torch.kernels.flash_attention.kernel.route`): the plain
version
(:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_bwd_plain`)
for a CPU tensor; bf16 at head dim 64 or 128 on CUDA the tensor-core
kernels (``"wgmma"``: TMA-staged tiles, all five products by ``wgmma``);
every other CUDA call the CUDA-core kernels (``"simt"``, float32); a meta
tensor the CUDA checks but the head dim and empty gradients, no launch
(``"meta"``).  A CUDA tensor launches its route or raises — no route falls
back to another.  A call on CUDA or meta reports its function's work
(:func:`repro_torch.kernels.work.flash_bwd`) to the active work counter
(:mod:`repro_torch.launch.hlo_cost`).  ``LAUNCHES`` counts calls that
launched, :func:`simt_launch`'s too (one a backward, its kernels
together), ``LAUNCHES_BY_ROUTE`` splits them by route and
``LAUNCHES_BY_SHAPE`` by shape.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Optional, Tuple

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS, _check,
                                                        route)
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_plain
from repro_torch.launch import hlo_cost

_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
LIBRARY = KernelLibrary("flash_attention_bwd", "flash_attention_bwd.cu",
                        {"flash_attention_bwd_f32": _ARGS,
                         "flash_attention_bwd_bf16": _ARGS,
                         "flash_attention_bwd_bf16_wgmma": _ARGS})
_ENTRY = {torch.float32: "flash_attention_bwd_f32",
          torch.bfloat16: "flash_attention_bwd_bf16"}
_WGMMA_ENTRY = "flash_attention_bwd_bf16_wgmma"
#: The wgmma route's scratch rows (lse and delta a query head) are padded
#: to a multiple of this (``PAD`` in the source).
WGMMA_PAD = 128
_INT_MAX = 2 ** 31 - 1

#: Backward calls that launched since the last reset, in all, by route
#: and by shape: (route, BH, group, Sq, Sk, D, causal, window) -> calls.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"wgmma": 0, "simt": 0}
LAUNCHES_BY_SHAPE: dict = {}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0
    LAUNCHES_BY_SHAPE.clear()


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               do: torch.Tensor, lse: torch.Tensor, *,
                               group: int, causal: bool = True,
                               window: Optional[int] = None,
                               sm_scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """q, o, do: [BH, Sq, D]; k, v: [BH // group, Sk, D]; lse: float32 [BH,
    Sq] from the forward -> (dq, dk, dv) in the inputs' dtype."""
    _check(q, k, v, group)
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != tuple(q.shape[:2]):
        raise ValueError(f"flash attention backward takes o, do like q "
                         f"{tuple(q.shape)} and lse [BH, Sq], got "
                         f"{tuple(o.shape)}, {tuple(do.shape)} and "
                         f"{tuple(lse.shape)}")
    if route(q.dtype, q.shape[2], q.device) == "plain":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, group,
                                         causal=causal, window=window,
                                         sm_scale=sm_scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _launch(q, k, v, o, do, lse, group, causal, window, sm_scale, dq, dk,
            dv, None)
    return dq, dk, dv


def _work(q: torch.Tensor, k: torch.Tensor, group: int, causal: bool,
          window: Optional[int]) -> work.Work:
    bh, sq, d = q.shape
    return work.flash_bwd(bh, group, sq, k.shape[1], d, causal, window,
                          q.element_size())


def simt_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                group: int, causal: bool = True,
                window: Optional[int] = None,
                sm_scale: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA-core route's kernels on CUDA tensors whatever their dtype
    and head dim, to check and time them beside the route the wrapper
    takes; counted under ``"simt"`` as the wrapper counts its launches."""
    _check(q, k, v, group)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _launch(q, k, v, o, do, lse, group, causal, window, sm_scale, dq, dk,
            dv, "simt")
    return dq, dk, dv


def _launch(q, k, v, o, do, lse, group, causal, window, sm_scale, dq, dk,
            dv, kind: Optional[str]) -> None:
    """Check a CUDA call, launch its route (``kind``, or the one
    :func:`route` picks) into dq, dk, dv and count the launch (none where
    BH is 0: nothing to launch); on a meta tensor check it and report its
    work, launching nothing."""
    global LAUNCHES
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention backward runs on cpu, cuda or "
                         f"meta, got {q.device}")
    if q.dtype not in _ENTRY or any(t.dtype != q.dtype
                                    for t in (k, v, o, do)) \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash attention backward takes float32 or "
                        f"bfloat16 q, k, v, o, do of one dtype and float32 "
                        f"lse, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{o.dtype}, {do.dtype} and {lse.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS and q.device.type == "cuda":
        raise ValueError(f"flash attention backward takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if max(bh, sq, sk) > _INT_MAX // 2:
        raise ValueError("flash attention backward: sizes past int32")
    if not all(t.is_contiguous() for t in (q, k, v, o, do, lse)):
        raise ValueError("flash attention backward takes contiguous "
                         "tensors")
    kind = kind or route(q.dtype, d, q.device)
    if q.device.type == "meta":
        if bh:
            hlo_cost.report_kernel("flash_attention_bwd", partial(
                _work, q, k, group, causal, window))
        return
    if kind == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash attention backward wgmma route: tensor maps "
                         "take 16-byte aligned q, k, v, do")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    if bh == 0:
        return
    # wgmma: lse log2e and delta, each [BH, Sq padded]; simt: delta
    scratch = (torch.empty((2, bh, -(-sq // WGMMA_PAD) * WGMMA_PAD),
                           dtype=torch.float32, device=q.device)
               if kind == "wgmma" else
               torch.empty((bh, sq), dtype=torch.float32, device=q.device))
    win = min(int(window or 0), sq + sk + 1)
    lib = LIBRARY.load()
    entry = _WGMMA_ENTRY if kind == "wgmma" else _ENTRY[q.dtype]
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d,
            group, float(scale), int(causal), int(window is not None), win,
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention_bwd", err)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[kind] += 1
    shape = (kind, bh, group, sq, sk, d, bool(causal), window)
    LAUNCHES_BY_SHAPE[shape] = LAUNCHES_BY_SHAPE.get(shape, 0) + 1
    hlo_cost.report_kernel("flash_attention_bwd", partial(
        _work, q, k, group, causal, window))
