"""Plain PyTorch causal conv of the published Mamba-1 mixer: the CUDA
kernel's plain version (the reference has no Jamba)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def mamba_conv_ref(xi: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: Optional[torch.Tensor],
                   window: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depthwise causal conv over xi [B, S, d] with ``conv_w`` [K, d]
    and the bias ``conv_b`` [d] (None: none), then SiLU: (u [B, S, d] in
    xi's dtype, the new window [B, K-1, d]: the last K-1 rows of the
    carried ``window`` [B, K-1, d] (None: zeros) followed by xi).
    Products and sums in float32, one accumulator, the taps in order."""
    s, cw = xi.shape[1], conv_w.shape[0]
    if window is not None:
        xin = torch.cat([window.to(xi.dtype), xi], dim=1)
    else:
        xin = F.pad(xi, (0, 0, cw - 1, 0))
    w = conv_w.float()
    acc = xin[:, 0:s] * w[0]
    for i in range(1, cw):
        acc.addcmul_(xin[:, i:i + s], w[i])
    if conv_b is not None:
        acc.add_(conv_b.float())
    return (F.silu(acc, inplace=True).to(xi.dtype),
            xin[:, xin.shape[1] - (cw - 1):])
