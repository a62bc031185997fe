"""Public fused selective scan (the reference's ``ssm_scan/ops.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan.kernel import ssm_scan_kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


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
    return ssm_scan_kernel(xc.contiguous(), x_proj.contiguous(),
                           dt_bias.float().contiguous(),
                           a_log.float().contiguous(),
                           h0.float().contiguous())


__all__ = ["ssm_scan_fused", "ssm_scan_ref"]
