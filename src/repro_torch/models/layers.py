"""Shared layers: norms, RoPE, SwiGLU MLP, embeddings.

The reference's ``models/layers.py`` on PyTorch.  Its ``constrain``
sharding annotations change no value and are dropped
(``sharding.constrain`` is a checked no-op).  Every
``apply_*`` reads its parameters as ``p["name"]``, so it takes a
:class:`~repro_torch.models.common.Params` module or a plain dict.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models.common import ModelConfig, Params, trunc_normal

ParamsLike = Any   # Params module or dict of tensors


# -- norms -------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device=None) -> Params:
    return Params(scale=torch.ones((d,), dtype=dtype, device=device))


def apply_rmsnorm(p: ParamsLike, x: torch.Tensor, eps: float = 1e-6,
                  use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        return rmsnorm_kernel(x, p["scale"], eps=eps)
    return rmsnorm_ref(x, p["scale"], eps=eps)


def init_layernorm(d: int, dtype, device=None) -> Params:
    return Params(scale=torch.ones((d,), dtype=dtype, device=device),
                  bias=torch.zeros((d,), dtype=dtype, device=device))


def apply_layernorm(p: ParamsLike, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def init_norm(cfg: ModelConfig, d: Optional[int] = None,
              device=None) -> Params:
    d = d or cfg.d_model
    return (init_layernorm(d, cfg.param_dtype, device) if cfg.use_layernorm
            else init_rmsnorm(d, cfg.param_dtype, device))


def apply_norm(cfg: ModelConfig, p: ParamsLike,
               x: torch.Tensor) -> torch.Tensor:
    if cfg.use_layernorm:
        return apply_layernorm(p, x, eps=cfg.norm_eps)
    return apply_rmsnorm(p, x, eps=cfg.norm_eps)


# -- rotary position embeddings ----------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (absolute)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    angles = positions[..., None].float() * freqs              # [B,S,hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- MLP ----------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    if cfg.use_gelu:
        return Params(w1=trunc_normal(gen, (d, f), dt),
                      b1=torch.zeros((f,), dtype=dt, device=gen.device),
                      w2=trunc_normal(gen, (f, d), dt),
                      b2=torch.zeros((d,), dtype=dt, device=gen.device))
    return Params(w1=trunc_normal(gen, (d, f), dt),    # gate
                  w3=trunc_normal(gen, (d, f), dt),    # up
                  w2=trunc_normal(gen, (f, d), dt))    # down


def mlp_logical_axes(cfg: ModelConfig) -> dict:
    if cfg.use_gelu:
        return {"w1": ("embed", "ff"), "b1": ("ff",),
                "w2": ("ff", "embed"), "b2": ("embed",)}
    return {"w1": ("embed", "ff"), "w3": ("embed", "ff"),
            "w2": ("ff", "embed")}


def apply_mlp(p: ParamsLike, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    if cfg.use_gelu:
        h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
        return h @ p["w2"] + p["b2"]
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


# -- embeddings ---------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = cfg.param_dtype
    p: Dict[str, torch.Tensor] = {
        "table": trunc_normal(gen, (cfg.vocab_size, cfg.d_model), dt,
                              scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = trunc_normal(gen, (cfg.d_model, cfg.vocab_size), dt)
    return Params(**p)


def embedding_logical_axes(cfg: ModelConfig) -> dict:
    p = {"table": ("vocab", "embed_pod")}
    if not cfg.tie_embeddings:
        p["unembed"] = ("embed_pod", "vocab")
    return p


def embed_tokens(p: ParamsLike, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: ParamsLike, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Returns logits [..., vocab]."""
    if cfg.tie_embeddings:
        return x @ p["table"].T.to(x.dtype)
    return x @ p["unembed"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
