"""Public flash attention: the ``[B, H, S, D]`` <-> ``[B*H, S, D]``
flattening and the GQA group around the kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D]."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv}")
    out = flash_attention_kernel(
        q.reshape(b * hq, sq, d).contiguous(),
        k.reshape(b * hkv, sk, d).contiguous(),
        v.reshape(b * hkv, sk, d).contiguous(),
        group=hq // hkv, causal=causal, window=window, sm_scale=sm_scale)
    return out.reshape(b, hq, sq, d)


__all__ = ["flash_attention", "attention_ref"]
