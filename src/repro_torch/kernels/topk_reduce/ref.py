"""Plain PyTorch top-k: the oracle and the CUDA kernel's plain version."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """float32 scores -> int32 keys in the total order of their bits that
    ``lax.top_k`` sorts by: -NaN < -inf < ... < -0 < +0 < ... < +inf <
    +NaN."""
    bits = scores.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_ref(scores: torch.Tensor, k: int,
             valid_count: Optional[Union[int, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over [n] scores -> (values [k] f32 descending, indices [k]
    int32).

    Entries at or past ``valid_count`` count as -inf.  A stable
    descending sort of the scores' order keys: ties go to the earlier
    index, so the result equals ``lax.top_k`` on the masked scores, also
    at signed zeros and NaNs and where ``k > valid_count`` (the
    lowest-indexed invalid entries follow the valid ones).
    """
    n = scores.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"top-k needs 0 <= k <= n, got k={k}, n={n}")
    s = scores.float()
    if valid_count is not None:
        idx = torch.arange(n, device=s.device)
        vc = torch.as_tensor(valid_count, device=s.device)
        s = torch.where(idx < vc, s,
                        torch.full((), float("-inf"), device=s.device))
    order = torch.sort(order_keys(s), descending=True,
                       stable=True).indices[:k]
    return s[order], order.to(torch.int32)


def topk_select_ref(scores: torch.Tensor, k: int,
                    valid_count: Optional[Union[int, torch.Tensor]] = None,
                    slices: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The select route's algebra in tensor code: the k best of each of
    ``slices`` contiguous slices (fewer where a slice is shorter), ranked
    by the composite key (order key descending, then index ascending),
    then the k best of their union by the same key.  Equals
    :func:`topk_ref` bit for bit; the tests hold it to the reference, the
    card's kernel is held to :func:`topk_ref`."""
    n = scores.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"top-k needs 0 <= k <= n, got k={k}, n={n}")
    if slices < 1:
        raise ValueError(f"slices must be >= 1, got {slices}")
    s = scores.float()
    if valid_count is not None:
        idx = torch.arange(n, device=s.device)
        vc = torch.as_tensor(valid_count, device=s.device)
        s = torch.where(idx < vc, s,
                        torch.full((), float("-inf"), device=s.device))
    size = max(-(-n // slices), 1)
    picked = [topk_ref(s[start:start + size],
                       min(k, s[start:start + size].shape[0]))[1].long()
              + start for start in range(0, n, size)]
    union = torch.sort(torch.cat(picked) if picked else
                       torch.zeros((0,), dtype=torch.long)).values
    order = torch.sort(order_keys(s[union]), descending=True,
                       stable=True).indices[:k]
    best = union[order]
    return s[best], best.to(torch.int32)
