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
recomputing P from ``lse`` on the CUDA cores in float32.

:func:`flash_attention_bwd_kernel` takes the plain version
(:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_bwd_plain`)
for a CPU tensor and launches the kernels for a CUDA one, or raises.
``LAUNCHES`` counts calls that launched (one a backward, the three
kernels together), ``LAUNCHES_BY_ROUTE`` splits them by route (one route,
``"simt"``) and ``LAUNCHES_BY_SHAPE`` by shape.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, _check
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_plain

_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
LIBRARY = KernelLibrary("flash_attention_bwd", "flash_attention_bwd.cu",
                        {"flash_attention_bwd_f32": _ARGS,
                         "flash_attention_bwd_bf16": _ARGS})
_ENTRY = {torch.float32: "flash_attention_bwd_f32",
          torch.bfloat16: "flash_attention_bwd_bf16"}
_INT_MAX = 2 ** 31 - 1

#: Backward calls that launched since the last reset, in all, by route
#: and by shape: (route, BH, group, Sq, Sk, D, causal, window) -> calls.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"simt": 0}
LAUNCHES_BY_SHAPE: dict = {}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0
    LAUNCHES_BY_SHAPE.clear()


def route(device) -> str:
    """``"plain"`` for a CPU tensor, ``"simt"`` on CUDA."""
    return "plain" if torch.device(device).type == "cpu" else "simt"


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
    global LAUNCHES
    _check(q, k, v, group)
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != tuple(q.shape[:2]):
        raise ValueError(f"flash attention backward takes o, do like q "
                         f"{tuple(q.shape)} and lse [BH, Sq], got "
                         f"{tuple(o.shape)}, {tuple(do.shape)} and "
                         f"{tuple(lse.shape)}")
    if route(q.device) == "plain":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, group,
                                         causal=causal, window=window,
                                         sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention backward runs on cpu or cuda, "
                         f"got {q.device}")
    if q.dtype not in _ENTRY or any(t.dtype != q.dtype
                                    for t in (k, v, o, do)) \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash attention backward takes float32 or "
                        f"bfloat16 q, k, v, o, do of one dtype and float32 "
                        f"lse, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{o.dtype}, {do.dtype} and {lse.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention backward takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if max(bh, sq, sk) > _INT_MAX // 2:
        raise ValueError("flash attention backward: sizes past int32")
    if not all(t.is_contiguous() for t in (q, k, v, o, do, lse)):
        raise ValueError("flash attention backward takes contiguous "
                         "tensors")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if bh == 0:
        return dq, dk, dv
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    win = min(int(window or 0), sq + sk + 1)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d, group, float(scale),
            int(causal), int(window is not None), win,
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention_bwd", err)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE["simt"] += 1
    shape = ("simt", bh, group, sq, sk, d, bool(causal), window)
    LAUNCHES_BY_SHAPE[shape] = LAUNCHES_BY_SHAPE.get(shape, 0) + 1
    return dq, dk, dv
