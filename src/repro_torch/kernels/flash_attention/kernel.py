"""CUDA flash-attention kernel: bind and launch.

The kernels (``repro_torch/csrc/flash_attention.cu``) replace the
reference's Pallas kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_kernel`` (body
``_flash_kernel``): online-softmax attention on the flattened layout
``q [B*Hq, Sq, D]``, ``k, v [B*Hkv, Sk, D]``, with GQA (query head ``bh``
reads kv head ``bh // group``), right-aligned queries, causal and window
masks, and 0 for a row that sees no key.  The source says what bounds
them.

:func:`flash_attention_kernel` is the entry point and :func:`route` picks
its route from dtype, head dim and device alone: a CPU tensor takes the
plain version (:func:`~repro_torch.kernels.flash_attention.ref.
flash_attention_plain`); bf16 at head dim 64 or 128 on CUDA takes the
tensor-core kernel (``"wgmma"``, ``flash_fwd_wgmma``); every other CUDA
call takes the CUDA-core kernel (``"simt"``, ``flash_fwd``).  A CUDA
tensor launches its route's kernel or raises — no route falls back to
another.  With ``return_lse`` both routes also write each row's
log-sum-exp (float32 ``[BH, Sq]``, +inf for a row that sees no key), which
the backward (:mod:`~repro_torch.kernels.flash_attention.backward`)
recomputes the probabilities from; serving asks for none.  ``LAUNCHES``
counts kernel launches, ``LAUNCHES_BY_ROUTE`` splits them by route and
``LAUNCHES_BY_SHAPE`` by shape.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

# q, k, v, o, lse; bh, sq, sk, d, group; scale; causal, use_window,
# window; stream
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
LIBRARY = KernelLibrary("flash_attention", "flash_attention.cu",
                        {"flash_attention_f32": _ARGS,
                         "flash_attention_bf16": _ARGS,
                         "flash_attention_bf16_wgmma": _ARGS})
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_WGMMA_ENTRY = "flash_attention_bf16_wgmma"
#: Head dims the CUDA-core kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 96, 128)
#: Head dims the bf16 tensor-core kernel takes.
WGMMA_HEAD_DIMS = (64, 128)
_INT_MAX = 2 ** 31 - 1

#: Kernel launches since the last reset, in all, by route and by shape:
#: (route, BH, group, Sq, Sk, D, causal, window) -> launches.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"wgmma": 0, "simt": 0}
LAUNCHES_BY_SHAPE: dict = {}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0
    LAUNCHES_BY_SHAPE.clear()


def route(dtype: torch.dtype, head_dim: int, device) -> str:
    """The route a call takes: ``"plain"`` for a CPU tensor, ``"wgmma"``
    for bf16 at a head dim in :data:`WGMMA_HEAD_DIMS`, ``"simt"`` for
    every other call on CUDA."""
    if torch.device(device).type == "cpu":
        return "plain"
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           group: int) -> None:
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or q.shape[2] != k.shape[2] or q.shape[0] != k.shape[0] * group:
        raise ValueError(f"flash attention takes q [BH, Sq, D] and k, v "
                         f"[BH / {group}, Sk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash attention inputs on several devices")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, group: int,
                           causal: bool = True,
                           window: Optional[int] = None,
                           sm_scale: Optional[float] = None,
                           return_lse: bool = False
                           ) -> Union[torch.Tensor,
                                      Tuple[torch.Tensor, torch.Tensor]]:
    """q: [BH, Sq, D]; k, v: [BH // group, Sk, D] -> [BH, Sq, D] in q's
    dtype (and with ``return_lse`` the rows' log-sum-exp, float32 [BH,
    Sq]); ``sm_scale`` defaults to ``1 / sqrt(D)``."""
    global LAUNCHES
    _check(q, k, v, group)
    if route(q.dtype, q.shape[2], q.device) == "plain":
        return flash_attention_plain(q, k, v, group, causal=causal,
                                     window=window, sm_scale=sm_scale,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, got "
                         f"{q.device}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype} "
                        f"and {v.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if max(bh, sq, sk) > _INT_MAX // 2:
        raise ValueError("flash attention kernel: sizes past int32")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention kernel takes contiguous tensors")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if bh == 0 or sq == 0:
        return (out, lse) if return_lse else out
    kind = route(q.dtype, d, q.device)
    if kind == "wgmma" and any(t.data_ptr() % 16
                               for t in (q, k, v, out)):
        raise ValueError("flash attention wgmma route: tensor maps take "
                         "16-byte aligned q, k, v")
    # a window past sq + sk masks nothing more: keep it in int32
    win = min(int(window or 0), sq + sk + 1)
    lib = LIBRARY.load()
    entry = _WGMMA_ENTRY if kind == "wgmma" else _ENTRY[q.dtype]
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, sq, sk, d, group,
            float(scale), int(causal), int(window is not None), win,
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[kind] += 1
    shape = (kind, bh, group, sq, sk, d, bool(causal), window)
    LAUNCHES_BY_SHAPE[shape] = LAUNCHES_BY_SHAPE.get(shape, 0) + 1
    return (out, lse) if return_lse else out
