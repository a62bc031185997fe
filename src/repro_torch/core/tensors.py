"""Tensor helpers that reproduce ``jax.numpy`` semantics the reference
relies on, where PyTorch's defaults differ:

* ``jnp.take(..., mode="clip")`` clamps out-of-range indices; torch
  indexing raises, so :func:`take_clip` clamps explicitly.
* ``jnp.argsort(~mask, stable=True)`` is a stable partition; torch's
  bool sort is not available on every backend, so
  :func:`stable_argsort_false_first` sorts a uint8 view stably.
* ``jnp.sum`` over int32 stays int32 (wrapping); ``torch.sum`` widens to
  int64, so :func:`masked_sum` casts back to JAX's result dtype.
"""
from __future__ import annotations

import torch


def take_clip(x: torch.Tensor, idx: torch.Tensor, dim: int = 0
              ) -> torch.Tensor:
    """``jnp.take(x, idx, axis=dim, mode="clip")``: out-of-range indices
    clamp to the nearest edge instead of raising."""
    n = x.shape[dim]
    if n == 0:
        return x.new_zeros(x.shape[:dim] + idx.shape + x.shape[dim + 1:])
    return torch.index_select(x, dim, idx.clamp(0, n - 1).reshape(-1)
                              ).reshape(x.shape[:dim] + idx.shape
                                        + x.shape[dim + 1:])


def stable_argsort_false_first(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(~mask, stable=True)``: indices with ``mask`` True
    first, each group in its original order.  Sorts a uint8 view, which
    every backend sorts stably (bool sorts are not supported everywhere)."""
    return torch.sort((~mask).to(torch.uint8), stable=True).indices


def jax_sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Result dtype of ``jnp.sum`` over ``dtype`` (32-bit JAX): small ints
    and bool widen to 32 bits, everything else keeps its dtype."""
    if dtype in (torch.bool, torch.int8, torch.int16, torch.int32):
        return torch.int32
    if dtype in (torch.uint8, torch.uint16, torch.uint32):
        return torch.uint32
    return dtype


def masked_sum(leaf: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(jnp.where(valid, leaf, 0), axis=0)`` with JAX's result
    dtype; 32-bit integer sums wrap like the reference's accumulators."""
    m = valid.reshape((-1,) + (1,) * (leaf.ndim - 1))
    kept = torch.where(m, leaf, torch.zeros((), dtype=leaf.dtype,
                                            device=leaf.device))
    out = jax_sum_dtype(leaf.dtype)
    if out.is_floating_point or out == torch.int64:
        return kept.sum(dim=0, dtype=out)
    low = kept.to(torch.int64).sum(dim=0) & 0xFFFFFFFF
    if out == torch.uint32:
        return low.to(torch.uint32)
    return ((low ^ 0x80000000) - 0x80000000).to(torch.int32)
