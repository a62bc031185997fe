"""Gradient compression (int8 + error feedback): the reference's
``optim/compression.py``.

Each leaf is quantized to int8 with a per-tensor scale; the quantization
residual is carried in an error-feedback buffer and added to the next
step's gradient (Seide et al. 2014 / Karimireddy et al. 2019).  It
serves ``grad_sync="mare_tree"`` with ``compression`` (``train/step.py``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.tree import flatten, unflatten
from repro_torch.optim.base import named_tree


def _quantize(xf: torch.Tensor, amax: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale f32 scalar)."""
    xf = x.to(torch.float32)
    return _quantize(xf, torch.max(torch.abs(xf)))


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def stack_key(name: str) -> str:
    """The reference leaf a per-layer tensor belongs to: its dotted name
    without the stack indices (``blocks.3.attn.wq`` -> ``blocks.attn.wq``;
    the reference keeps the layers stacked ``[L, ...]`` in one leaf)."""
    return ".".join(p for p in name.split(".") if not p.isdigit())


def error_feedback_compress(grads: Any, residual: Any
                            ) -> Tuple[Any, Any, Any]:
    """Apply EF int8 compression leaf-wise.

    A dict by dotted parameter name is quantized per reference leaf: the
    layers of one stacked leaf share its scale (the largest |value| over
    all of them), as the reference's per-tensor scale over ``[L, ...]``.
    Returns (quantized leaves (q, scale) tree, dequantized grads to reduce,
    new residual)."""
    g_leaves, treedef = flatten(grads)
    r_leaves, r_def = flatten(residual)
    if r_def != treedef:
        raise ValueError("grads and residual differ in structure")
    by_name = isinstance(grads, dict) and all(
        isinstance(v, torch.Tensor) for v in grads.values())
    names = [stack_key(k) for k in sorted(grads)] if by_name \
        else list(range(len(g_leaves)))
    # the scales first, then each leaf again: no f32 copy of every leaf
    # is held at once
    amax = {}
    for name, g, r in zip(names, g_leaves, r_leaves):
        m = torch.max(torch.abs(g.to(torch.float32) + r))
        amax[name] = m if name not in amax else torch.maximum(amax[name], m)
    qs, deq, res = [], [], []
    for name, g, r in zip(names, g_leaves, r_leaves):
        x = g.to(torch.float32) + r
        q, scale = _quantize(x, amax[name])
        d = decompress_int8(q, scale)
        qs.append((q, scale))
        deq.append(d)
        res.append(x - d)
    return (unflatten(treedef, qs), unflatten(treedef, deq),
            unflatten(treedef, res))


def init_residual(params: Any) -> Any:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_tree(params).items()}
