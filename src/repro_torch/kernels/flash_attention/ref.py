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
                          sm_scale: Optional[float] = None,
                          return_lse: bool = False):
    """The kernel's function without tiling, on its flattened layout.

    q: [BH, Sq, D]; k, v: [BH // group, Sk, D] -> [BH, Sq, D] in q's
    dtype.  Query head ``bh`` reads kv head ``bh // group``; masked
    scores are ``NEG_INF``; p is 0 off the mask; a row with no valid key
    gives 0.  All arithmetic in f32.  With ``return_lse`` also the rows'
    log-sum-exp of the scaled scores, f32 [BH, Sq], +inf for a row with
    no valid key (the kernel's second output).
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
    o = o.reshape(bh, sq, d).to(q.dtype)
    if not return_lse:
        return o
    if sk == 0:
        return o, torch.full((bh, sq), float("inf"), device=q.device)
    lse = torch.where(l == 0.0, float("inf"),
                      m + torch.log(torch.where(l == 0.0, 1.0, l)))
    return o, lse.reshape(bh, sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor,
                              group: int, causal: bool = True,
                              window: Optional[int] = None,
                              sm_scale: Optional[float] = None):
    """The backward kernel's function without tiling, with its recompute
    algebra, on the flattened layout.

    q, o, do: [BH, Sq, D]; k, v: [BH // group, Sk, D]; lse: the forward's
    f32 [BH, Sq].  Returns (dq, dk, dv) in the inputs' dtypes:
    ``P = mask ? exp(scale * q.k - lse) : 0``, ``dV = P^T dO``, ``dP = dO
    V^T``, ``delta = rowsum(dO * O)``, ``dS = P * (dP - delta)``, ``dQ =
    scale * dS K``, ``dK = scale * dS^T Q``; dk and dv sum over the
    group's query heads.  A row with no valid key (lse = +inf) gets a zero
    gradient.  All arithmetic in f32.
    """
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    qg = q.float().reshape(bkv, group, sq, d)
    dog = do.float().reshape(bkv, group, sq, d)
    kf = k.float()[:, None]
    vf = v.float()[:, None]
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale   # [BKV, G, Sq, Sk]
    mask = _mask(sq, sk, causal, window, q.device)
    lse_g = lse.float().reshape(bkv, group, sq, 1)
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dv = torch.matmul(p.transpose(-1, -2), dog).sum(1)
    dp = torch.matmul(dog, vf.transpose(-1, -2))
    delta = (dog * o.float().reshape(bkv, group, sq, d)).sum(-1,
                                                            keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qg).sum(1) * scale
    return (dq.reshape(bh, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
