"""Plain PyTorch attention: the reference's oracle, and the plain version
of the flash kernel.

The two differ on one input: a query row that sees no key.
:func:`attention_ref` follows the reference's oracle and gives NaN there
(a softmax over nothing); :func:`flash_attention_plain` follows the
kernel (its ``safe_l`` guard) and gives 0.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # the kernel's mask value


def _mask(sq: int, sk: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal or window is not None:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  sm_scale: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Reference attention.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D]; Hq % Hkv == 0 (GQA groups).
    ``window``: optional sliding-window size (attend to keys in
    (qpos - window, qpos]); implies causal.
    Returns [B, Hq, Sq, D] in q's dtype; softmax in f32.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv}")
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    kr = torch.repeat_interleave(k, group, dim=1)
    vr = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    mask = _mask(sq, sk, causal, window, q.device)
    s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.float()).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, group: int, causal: bool = True,
                          window: Optional[int] = None,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function without tiling, on its flattened layout.

    q: [BH, Sq, D]; k, v: [BH // group, Sk, D] -> [BH, Sq, D] in q's
    dtype.  Query head ``bh`` reads kv head ``bh // group``; masked
    scores are ``NEG_INF``; p is 0 off the mask; a row with no valid key
    gives 0.  All arithmetic in f32.
    """
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    qg = q.float().reshape(bkv, group, sq, d)
    kf = k.float()[:, None]
    vf = v.float()[:, None]
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale   # [BKV, G, Sq, Sk]
    mask = _mask(sq, sk, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True) if sk else s[..., :1]
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.matmul(p, vf) / torch.where(l == 0.0, 1.0, l)
    return o.reshape(bh, sq, d).to(q.dtype)
