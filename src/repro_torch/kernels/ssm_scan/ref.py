"""Plain PyTorch selective scan: the oracle and the CUDA kernel's plain
version (the reference's ``kernels/ssm_scan/ref.py:ssm_scan_ref``)."""
from __future__ import annotations

from typing import Tuple

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, exact for large x
    (``torch.nn.functional.softplus`` switches to x above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def ssm_scan_ref(xc: torch.Tensor, x_proj: torch.Tensor,
                 dt_bias: torch.Tensor, a_log: torch.Tensor,
                 h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential reference.

    xc: [B, T, d] post-conv activations; x_proj: [d, 2n+1];
    dt_bias: [d]; a_log: [d, n]; h0: [B, d, n].
    Returns (y [B, T, d] f32, h_final [B, d, n] f32), without d_skip."""
    n = a_log.shape[1]
    xf = xc.float()
    proj = xf @ x_proj.float()
    bb, cc, dtr = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n]
    dt = softplus(dtr[..., None] + dt_bias.float())         # [B, T, d]
    a = torch.exp(-torch.exp(a_log.float()) * dt[..., None])  # [B,T,d,n]
    bx = (dt * xf)[..., None] * bb[..., None, :]
    h = h0.float()
    ys = []
    for t in range(xc.shape[1]):
        h = a[:, t] * h + bx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cc[:, t]))
    return torch.stack(ys, dim=1), h
