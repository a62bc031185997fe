"""Decoder LM assembly, dense and MoE families.

The reference's ``models/transformer.py`` for ``family`` ``"dense"`` and
``"moe"`` (whose blocks hold ``moe`` in place of ``mlp``).  Its
``lax.scan`` over stacked layer parameters becomes a Python loop over one
:class:`Block` module per layer (PyTorch runs eagerly: there is no graph
whose size depth could grow), and ``remat``/``scan_layers`` have nothing
to select.  The other families raise :class:`NotImplementedError` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import ModelConfig, Params
from repro_torch.models.layers import (ParamsLike, apply_mlp, apply_norm,
                                       cross_entropy, embed_tokens,
                                       init_embedding, init_mlp, init_norm,
                                       unembed)

#: The families the port runs.
PORTED_FAMILIES = ("dense", "moe")

#: Where each family the port does not run yet is ported (ROADMAP.md).
PENDING_FAMILIES = {
    "hybrid": "ROADMAP Queue 1, item 2 (hybrid/ssm with the ssm_scan "
              "kernel)",
    "ssm": "ROADMAP Queue 1, item 3 (xlstm)",
    "audio": "ROADMAP Queue 1, item 4 (encdec)",
    "vlm": "ROADMAP Queue 1, item 5 (vlm)",
}


def require_ported_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {' and '.join(PORTED_FAMILIES)}"
            f" families; {cfg.family!r} comes with "
            f"{PENDING_FAMILIES.get(cfg.family, 'a later ROADMAP item')}")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

class Block(Params):
    """One decoder layer: ``norm1``, ``attn``, ``norm2``, and ``mlp``
    (dense) or ``moe`` (MoE)."""


def init_block(gen: torch.Generator, cfg: ModelConfig) -> Block:
    require_ported_family(cfg)
    ffn = ({"moe": moe_lib.init_moe(gen, cfg)} if cfg.family == "moe"
           else {"mlp": init_mlp(gen, cfg)})
    return Block(norm1=init_norm(cfg, device=gen.device),
                 norm2=init_norm(cfg, device=gen.device),
                 attn=attn_lib.init_attention(gen, cfg), **ffn)


def apply_ffn(p: ParamsLike, h: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's feed-forward half: (y, MoE aux loss or None)."""
    if cfg.family == "moe":
        y, stats = moe_lib.moe_ffn(p["moe"], h, cfg)
        return y, stats.aux_loss
    return apply_mlp(p["mlp"], h, cfg), None


def apply_block(p: ParamsLike, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, window: Optional[int] = None,
                return_kv: bool = False):
    """Returns (x', aux_loss[, (kt, vt)]); aux is 0 for dense blocks."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg, p["norm1"], x)
    a = attn_lib.self_attention(p["attn"], h, positions, cfg,
                                window=window, return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    x = x + a
    h = apply_norm(cfg, p["norm2"], x)
    y, moe_aux = apply_ffn(p, h, cfg)
    if moe_aux is not None:
        aux = aux + moe_aux
    x = x + y
    if return_kv:
        return x, aux, kv
    return x, aux


# ---------------------------------------------------------------------------
# LM init / forward
# ---------------------------------------------------------------------------

class LM(Params):
    """The model's parameters: ``embed``, ``blocks`` (one :class:`Block`
    per layer), ``final_norm``.  Names follow the reference's pytree
    paths: ``blocks.3.attn.wq``, ``embed.table``, ``final_norm.scale``."""


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> LM:
    require_ported_family(cfg)
    return LM(embed=init_embedding(gen, cfg),
              final_norm=init_norm(cfg, device=gen.device),
              blocks=nn.ModuleList(init_block(gen, cfg)
                                   for _ in range(cfg.num_layers)))


def forward(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig,
            return_kv: bool = False):
    """tokens: [B, S] -> (logits [B, S, V], aux_loss[, (K, V)]).

    With ``return_kv`` the per-layer KV stacks [L, B, KV, S, hd] come
    back too (the prefill path).
    """
    require_ported_family(cfg)
    x = embed_tokens(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for bp in params["blocks"]:
        out = apply_block(bp, x, positions, cfg, return_kv=return_kv)
        if return_kv:
            x, a, (kt, vt) = out
            ks.append(kt)
            vs.append(vt)
        else:
            x, a = out
        aux_total = aux_total + a
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], x, cfg)
    if return_kv:
        return logits, aux_total, (torch.stack(ks), torch.stack(vs))
    return logits, aux_total


def lm_loss(params: ParamsLike, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict]:
    """Forward-only loss (the port does not train yet)."""
    logits, aux = forward(params, batch["tokens"], cfg)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

class StackedKV:
    """Uniform full-attention cache: k/v [L, B, KV, S_cache, hd]; ``pos``
    is the next position to write.  Decode writes each layer's new K/V
    into its slot in place."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos: int):
        self.k, self.v, self.pos = k, v, int(pos)


def init_stacked_cache(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=None, device=None) -> StackedKV:
    dt = dtype or cfg.param_dtype
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.hd)
    return StackedKV(k=torch.zeros(shape, dtype=dt, device=device),
                     v=torch.zeros(shape, dtype=dt, device=device), pos=0)


def prefill_scanned(params: ParamsLike, tokens: torch.Tensor,
                    cfg: ModelConfig, max_len: int):
    """Prefill for uniform stacks: logits [B, S, V] and a StackedKV of
    ``max_len`` positions holding the prompt's K/V."""
    logits, _, (kt, vt) = forward(params, tokens, cfg, return_kv=True)
    L, b, _, s, _ = kt.shape
    cache = init_stacked_cache(cfg, b, max_len, dtype=kt.dtype,
                               device=kt.device)
    cache.k[:, :, :, :s] = kt
    cache.v[:, :, :, :s] = vt
    cache.pos = s
    return logits, cache


def decode_step_scanned(params: ParamsLike, cache: StackedKV,
                        tokens: torch.Tensor, cfg: ModelConfig):
    """tokens [B] -> (logits [B, V], cache') with a loop over layers."""
    x = embed_tokens(params["embed"], tokens[:, None], cfg)
    pos = cache.pos
    for i, bp in enumerate(params["blocks"]):
        h = apply_norm(cfg, bp["norm1"], x)
        a, _, _ = attn_lib.decode_attn_raw(bp["attn"], h, cache.k[i],
                                           cache.v[i], pos, cfg)
        x = x + a
        h = apply_norm(cfg, bp["norm2"], x)
        x = x + apply_ffn(bp, h, cfg)[0]
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], x, cfg)
    return logits[:, 0], StackedKV(k=cache.k, v=cache.v, pos=pos + 1)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> StackedKV:
    require_ported_family(cfg)
    return init_stacked_cache(cfg, batch, max_len, device=device)


def decode_step(params: ParamsLike, caches: StackedKV,
                tokens: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, StackedKV]:
    """tokens: [B] -> (logits [B, V], caches')."""
    require_ported_family(cfg)
    return decode_step_scanned(params, caches, tokens, cfg)


def prefill(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, StackedKV]:
    """Run the full prompt, returning (logits [B, S, V], filled cache)."""
    require_ported_family(cfg)
    return prefill_scanned(params, tokens, cfg, max_len or tokens.shape[1])
