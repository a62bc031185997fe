"""Public fused selective scan (the reference's ``ssm_scan/ops.py``) and
its gradient.

Where grad mode is on and an input requires grad, :func:`ssm_scan_fused`
goes through :class:`SSMScan`, a ``torch.autograd.Function`` whose forward
is the kernel on its chunked route keeping its projection rows and
chunk-entering states and whose backward is the backward kernel
(:mod:`~repro_torch.kernels.ssm_scan.backward`); otherwise (serving) the
forward kernel runs alone and saves nothing.  On a CPU tensor both take
their plain versions.  Under non-reentrant checkpointing the recompute
calls the forward again and saves afresh.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan.backward import ssm_scan_bwd_kernel
from repro_torch.kernels.ssm_scan.kernel import (ssm_scan_dt_kernel,
                                                 ssm_scan_kernel)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


class SSMScan(torch.autograd.Function):
    """The selective scan with a kernel backward: ``apply(xc, x_proj,
    dt_bias, a_log, h0) -> (y, h_final)``.  A gradient of None (an output
    not used) counts as zeros."""

    @staticmethod
    def forward(ctx, xc, x_proj, dt_bias, a_log, h0):
        y, h, saved = ssm_scan_kernel(xc, x_proj, dt_bias, a_log, h0,
                                      save=True)
        ctx.save_for_backward(xc, x_proj, dt_bias, a_log, h0, *saved)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        xc, x_proj, dt_bias, a_log, h0, *saved = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(xc.shape, dtype=torch.float32,
                             device=xc.device)
        if dh is None:
            dh = torch.zeros(h0.shape, dtype=torch.float32,
                             device=h0.device)
        return ssm_scan_bwd_kernel(xc, x_proj, dt_bias, a_log, h0,
                                   dy.contiguous(), dh.contiguous(), *saved)


def ssm_scan_fused(xc: torch.Tensor, x_proj: torch.Tensor,
                   dt_bias: torch.Tensor, a_log: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: [B, T, d] -> (y [B, T, d] f32, h_final [B, d, n] f32), without
    d_skip; ``h0`` defaults to zeros.  ``chunk`` is the reference's TPU
    block length; the CUDA kernel's chunked route cuts T by its own
    measured length (``kernel.CHUNK``), so it changes nothing here."""
    b, _, d = xc.shape
    n = a_log.shape[1]
    if h0 is None:
        h0 = torch.zeros((b, d, n), dtype=torch.float32, device=xc.device)
    if xc.dtype != x_proj.dtype:
        # the kernel computes the projection in f32 anyway: widen the
        # narrower operand (exact) so both share one type
        xc, x_proj = xc.float(), x_proj.float()
    args = (xc.contiguous(), x_proj.contiguous(),
            dt_bias.float().contiguous(), a_log.float().contiguous(),
            h0.float().contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SSMScan.apply(*args)
    return ssm_scan_kernel(*args)


def ssm_scan_dt(u: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor,
                bm: torch.Tensor, cm: torch.Tensor, a_log: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The published Mamba-1 scan with its coefficients given: u, dt [B,
    T, d] (dt before ``dt_bias`` and softplus), bm, cm [B, T, n] -> (y [B,
    T, d] f32, h_final [B, d, n] f32), without d_skip; ``h0`` defaults to
    zeros.  dt, B and C take u's dtype (exact where they are wider only
    if they hold u's values); the kernel's dt route on CUDA, its plain
    version on the CPU.  Serving only: no gradient flows through the
    kernel."""
    b, _, d = u.shape
    n = a_log.shape[1]
    if h0 is None:
        h0 = torch.zeros((b, d, n), dtype=torch.float32, device=u.device)
    return ssm_scan_dt_kernel(
        u.contiguous(), dt.to(u.dtype).contiguous(),
        dt_bias.float().contiguous(), bm.to(u.dtype).contiguous(),
        cm.to(u.dtype).contiguous(), a_log.float().contiguous(),
        h0.float().contiguous())


__all__ = ["SSMScan", "ssm_scan_dt", "ssm_scan_fused", "ssm_scan_ref"]
