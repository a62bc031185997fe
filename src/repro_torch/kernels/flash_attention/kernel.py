"""CUDA flash-attention kernel: bind and launch.

The kernel (``repro_torch/csrc/flash_attention.cu``) replaces the
reference's Pallas kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_kernel`` (body
``_flash_kernel``): online-softmax attention on the flattened layout
``q [B*Hq, Sq, D]``, ``k, v [B*Hkv, Sk, D]``, with GQA (query head ``bh``
reads kv head ``bh // group``), right-aligned queries, causal and window
masks, and 0 for a row that sees no key.  The source says what bounds it.

:func:`flash_attention_kernel` is the entry point.  A tensor on the CPU
takes the plain version (:func:`~repro_torch.kernels.flash_attention.ref.
flash_attention_plain`); a CUDA tensor launches the kernel or raises —
there is no fallback.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]
LIBRARY = KernelLibrary("flash_attention", "flash_attention.cu",
                        {"flash_attention_f32": _ARGS,
                         "flash_attention_bf16": _ARGS})
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
#: Head dims the CUDA kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 96, 128)
_INT_MAX = 2 ** 31 - 1

#: Kernel launches since the last reset.
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


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
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [BH, Sq, D]; k, v: [BH // group, Sk, D] -> [BH, Sq, D] in q's
    dtype; ``sm_scale`` defaults to ``1 / sqrt(D)``."""
    global LAUNCHES
    _check(q, k, v, group)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, group, causal=causal,
                                     window=window, sm_scale=sm_scale)
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
    if bh == 0 or sq == 0:
        return out
    # a window past sq + sk masks nothing more: keep it in int32
    win = min(int(window or 0), sq + sk + 1)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            sk, d, group, float(scale), int(causal), int(window is not None),
            win, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    LAUNCHES += 1
    return out
