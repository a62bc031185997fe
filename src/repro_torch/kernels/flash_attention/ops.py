"""Public flash attention: the ``[B, H, S, D]`` <-> ``[B*H, S, D]``
flattening and the GQA group around the kernel, and its gradient.

Where grad mode is on and an input requires grad, the call goes through
:class:`FlashAttention`, a ``torch.autograd.Function`` whose forward is
the kernel writing the rows' log-sum-exp too and whose backward is the
backward kernel (:mod:`~repro_torch.kernels.flash_attention.backward`);
otherwise (serving) the forward kernel runs alone and writes no
log-sum-exp.  On a CPU tensor both take their plain versions.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.backward import \
    flash_attention_bwd_kernel
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


class FlashAttention(torch.autograd.Function):
    """Flash attention on the flattened layout with a kernel backward:
    ``apply(q, k, v, group, causal, window, sm_scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, window, sm_scale):
        out, lse = flash_attention_kernel(q, k, v, group=group,
                                          causal=causal, window=window,
                                          sm_scale=sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, window, sm_scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, window, sm_scale = ctx.args
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, do.contiguous(), lse, group=group, causal=causal,
            window=window, sm_scale=sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D]."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv}")
    q3 = q.reshape(b * hq, sq, d).contiguous()
    k3 = k.reshape(b * hkv, sk, d).contiguous()
    v3 = v.reshape(b * hkv, sk, d).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttention.apply(q3, k3, v3, hq // hkv, causal, window,
                                   sm_scale)
    else:
        out = flash_attention_kernel(q3, k3, v3, group=hq // hkv,
                                     causal=causal, window=window,
                                     sm_scale=sm_scale)
    return out.reshape(b, hq, sq, d)


__all__ = ["FlashAttention", "flash_attention", "attention_ref"]
