"""Gradient compression (int8 + error feedback): the reference's
``optim/compression.py``.

Each leaf is quantized to int8 with a per-tensor scale; the quantization
residual is carried in an error-feedback buffer and added to the next
step's gradient (Seide et al. 2014 / Karimireddy et al. 2019).  It
serves ``grad_sync="mare_tree"``, which comes with the multi-card
backend (ROADMAP Queue 1, item 17).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.tree import flatten, unflatten
from repro_torch.optim.base import named_tree


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale f32 scalar)."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def error_feedback_compress(grads: Any, residual: Any
                            ) -> Tuple[Any, Any, Any]:
    """Apply EF int8 compression leaf-wise.

    Returns (quantized leaves (q, scale) tree, dequantized grads to reduce,
    new residual)."""
    g_leaves, treedef = flatten(grads)
    r_leaves, r_def = flatten(residual)
    if r_def != treedef:
        raise ValueError("grads and residual differ in structure")
    qs, deq, res = [], [], []
    for g, r in zip(g_leaves, r_leaves):
        gf = g.to(torch.float32) + r
        q, s = compress_int8(gf)
        d = decompress_int8(q, s)
        qs.append((q, s))
        deq.append(d)
        res.append(gf - d)
    return (unflatten(treedef, qs), unflatten(treedef, deq),
            unflatten(treedef, res))


def init_residual(params: Any) -> Any:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_tree(params).items()}
