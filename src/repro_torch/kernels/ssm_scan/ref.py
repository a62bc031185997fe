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


def ssm_scan_chunked_ref(xc: torch.Tensor, x_proj: torch.Tensor,
                         dt_bias: torch.Tensor, a_log: torch.Tensor,
                         h0: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA chunked route's two-level algebra in tensor code (tests
    only; same arguments and results as :func:`ssm_scan_ref`):

    (a) each chunk of ``chunk`` steps is scanned from h = 0, giving its
        local y, its end state ``h_end`` and the running sum of dt;
    (b) the carries ``h_in[c+1] = exp(-A * sum dt[c]) * h_in[c] +
        h_end[c]``, from ``h0``;
    (c) the fix-up ``y_t += sum_n C_t * exp(-A * cumdt_t) * h_in[c]``,
        with ``cumdt_t`` the sum of dt over the chunk up to t.

    Only ``exp(-A * s)`` of a non-negative sum s is formed, never
    ``exp(+A * cumdt)``."""
    n = a_log.shape[1]
    steps = xc.shape[1]
    xf = xc.float()
    proj = xf @ x_proj.float()
    bb, cc, dtr = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n]
    dt = softplus(dtr[..., None] + dt_bias.float())         # [B, T, d]
    A = torch.exp(a_log.float())                            # [d, n]
    a = torch.exp(-A * dt[..., None])                       # [B, T, d, n]
    bx = (dt * xf)[..., None] * bb[..., None, :]
    h_in = h0.float()
    ys = []
    for t0 in range(0, steps, chunk):
        t1 = min(steps, t0 + chunk)
        h = torch.zeros_like(h_in)                          # (a)
        local = []
        for t in range(t0, t1):
            h = a[:, t] * h + bx[:, t]
            local.append(torch.einsum("bdn,bn->bd", h, cc[:, t]))
        cum = torch.cumsum(dt[:, t0:t1], dim=1)             # [B, L, d]
        decay = torch.exp(-A * cum[..., None])              # [B, L, d, n]
        ys.append(torch.stack(local, dim=1) + torch.einsum(  # (c)
            "bldn,bdn,bln->bld", decay, h_in, cc[:, t0:t1]))
        h_in = decay[:, -1] * h_in + h                      # (b)
    return torch.cat(ys, dim=1), h_in
