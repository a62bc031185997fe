"""Attention: GQA + RoPE with three interchangeable implementations.

impl = "ref"     — full score materialization (tiny smoke tests / oracles)
impl = "chunked" — a loop over KV blocks with online softmax: O(chunk)
                   memory, plain tensor code.
impl = "pallas"  — the hand-written flash-attention kernel.  The name is
                   the reference's, kept so that configs carry over
                   unchanged; in the port it launches the CUDA kernel
                   (``csrc/flash_attention.cu``) on a CUDA tensor and its
                   plain version on a CPU tensor.

Decode helpers maintain a KV cache [B, KV, S_max, hd] with a write cursor;
sliding-window caches keep only the last `window` positions (ring
buffer).  Unlike the reference's functional updates, the port writes the
new token's K/V into the cache tensors in place (one slot per step), so a
decode step never copies the cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.common import ModelConfig, Params, trunc_normal
from repro_torch.models.layers import ParamsLike, apply_rope

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   d_in: Optional[int] = None) -> Params:
    d = d_in or cfg.d_model
    hd, H, KV = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    dt = cfg.param_dtype
    return Params(wq=trunc_normal(gen, (d, H, hd), dt),
                  wk=trunc_normal(gen, (d, KV, hd), dt),
                  wv=trunc_normal(gen, (d, KV, hd), dt),
                  wo=trunc_normal(gen, (H, hd, d), dt))


def attention_logical_axes(cfg: ModelConfig) -> dict:
    return {"wq": ("embed", "heads", "hd"),
            "wk": ("embed", "kv", "hd"),
            "wv": ("embed", "kv", "hd"),
            "wo": ("heads", "hd", "embed")}


def _project_qkv(p: ParamsLike, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, rope: bool = True):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, window: Optional[int],
                      chunk: int = 512, q_offset: int = 0,
                      kv_len: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over KV in blocks (plain tensor code).

    q: [B, Hq, Sq, hd]; k/v: [B, KV, Sk, hd].  ``q_offset``: absolute
    position of q[0] minus kv[0].  ``kv_len``: valid KV length (decode
    with a partially-filled cache).  Big tensors (q, k, v, p) stay in the
    input dtype; softmax statistics and the accumulator are f32; GQA in
    grouped form, as in the reference.
    """
    b, hq, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = 1.0 / (hd ** 0.5)
    nchunks = (sk + chunk - 1) // chunk
    qg = q.reshape(b, hkv, group, sq, hd)
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hkv, group, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, group, sq), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((b, hkv, group, sq, hd), dtype=torch.float32,
                      device=q.device)
    for ci in range(nchunks):
        kc = k[:, :, ci * chunk:(ci + 1) * chunk]
        vc = v[:, :, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg.float(),
                         kc.float()) * scale
        kpos = ci * chunk + torch.arange(kc.shape[2], device=q.device)
        mask = torch.ones((sq, kc.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal or window is not None:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        if kv_len is not None:
            mask &= (kpos < kv_len)[None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p.to(q.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, hq, sq, hd).to(q.dtype)


def full_attention(q, k, v, causal, window, impl: str = "ref",
                   chunk: int = 512, q_offset: int = 0):
    """Dispatch over implementations; q/k/v: [B, H(/KV), S, hd]."""
    if impl == "pallas":
        return flash_attention(q, k, v, causal=causal, window=window)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal, window, chunk=chunk,
                                 q_offset=q_offset)
    return attention_ref(q, k, v, causal=causal, window=window)


def resolve_impl(cfg: ModelConfig, seq: int, device) -> str:
    """``cfg.attn_impl`` unless it is "auto": then the kernel on a CUDA
    device (and on meta, where its work is counted), and the reference's
    non-TPU rule on the CPU."""
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    if torch.device(device).type in ("cuda", "meta"):
        return "pallas"
    return "chunked" if seq > 2048 else "ref"


def self_attention(p: ParamsLike, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, window: Optional[int] = None,
                   impl: Optional[str] = None, return_kv: bool = False):
    """Causal self-attention over x: [B, S, d]; RoPE unless
    ``cfg.use_rope`` is False."""
    b, s, d = x.shape
    impl = impl or resolve_impl(cfg, s, x.device)
    q, k, v = _project_qkv(p, x, positions, cfg, rope=cfg.use_rope)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    out = full_attention(qt, kt, vt, causal=True, window=window, impl=impl,
                         chunk=cfg.attn_chunk)
    y = torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), p["wo"])
    if return_kv:
        return y, (kt, vt)
    return y


# -- KV cache & decode --------------------------------------------------------

class KVCache:
    """KV cache; ``window`` 0 = full cache, > 0 = ring buffer of the last
    `window` positions.  ``pos`` is the next position to write."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos: int,
                 window: int = 0):
        self.k, self.v, self.pos, self.window = k, v, int(pos), int(window)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int] = None, dtype=None,
                  device=None) -> KVCache:
    size = min(window, max_len) if window else max_len
    dt = dtype or cfg.param_dtype
    shape = (batch, cfg.num_kv_heads, size, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device), pos=0,
                   window=window or 0)


def decode_attn_raw(p: ParamsLike, x: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: int, cfg: ModelConfig,
                    window: int = 0, rope: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against raw cache arrays.

    x: [B, 1, d]; k/v_cache: [B, KV, S_cache, hd], written in place at
    the new token's slot; pos: absolute position of the new token.
    Returns (y [B, 1, d], k_cache, v_cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, cfg, rope=rope)
    size = k_cache.shape[2]
    slot = (pos % size) if window else pos
    k_cache[:, :, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, :, slot] = v_new[:, 0].to(v_cache.dtype)
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    group = hq // hkv
    scale = 1.0 / (cfg.hd ** 0.5)
    # operands in their dtype, products and sums in f32 (the reference's
    # preferred_element_type=f32)
    qg = q.reshape(b, hkv, group, cfg.hd)
    s = torch.einsum("bkgd,bkcd->bkgc", qg.float(), k_cache.float()) * scale
    cpos = torch.arange(size, device=x.device)
    if window and pos + 1 >= size:
        # ring buffer full: every slot holds one of (pos - size, pos]
        valid = torch.ones_like(cpos, dtype=torch.bool)
    else:
        valid = cpos <= pos
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bkcd->bkgd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out.reshape(b, 1, hq, cfg.hd).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, k_cache, v_cache


def decode_attention(p: ParamsLike, x: torch.Tensor, cache: KVCache,
                     cfg: ModelConfig, rope: bool = True
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: x [B, 1, d] against the cache."""
    y, k, v = decode_attn_raw(p, x, cache.k, cache.v, cache.pos, cfg,
                              window=cache.window, rope=rope)
    return y, KVCache(k=k, v=v, pos=cache.pos + 1, window=cache.window)
