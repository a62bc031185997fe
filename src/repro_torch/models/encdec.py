"""Whisper-style encoder-decoder (the audio family): the reference's
``models/encdec.py`` on PyTorch.

The audio frontend (log-mel + conv downsampling) is a stub, as in the
reference: a batch's ``frames`` are precomputed frame embeddings [B,
encoder_seq, d].  Both stacks use pre-LN + GELU MLP (whisper style);
positions are sinusoidal on both sides.  The reference's ``lax.scan``
over stacked layers becomes a loop over one module per layer.

Attention keeps the reference's choices call by call: the encoder's
self-attention and the teacher-forced decoder's self and cross attention
(:func:`_mha`) resolve their implementation from the config (on a CUDA
tensor ``"pallas"``, the flash kernel; not causal for the encoder and the
cross attention); :func:`prefill`'s decoder self and cross attention take
the chunked plain version, :func:`decode_step`'s cross attention the
plain reference.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (ModelConfig, Params, lift_axes,
                                       remat, trunc_normal)
from repro_torch.models.layers import (ParamsLike, apply_layernorm,
                                       apply_mlp, cross_entropy,
                                       init_layernorm, init_mlp,
                                       mlp_logical_axes)


class EncDec(Params):
    """The model's parameters: ``embed.table`` (tied to the output
    projection), ``enc_layers`` (``ln1``, ``attn``, ``ln2``, ``mlp``),
    ``enc_ln``, ``dec_layers`` (``ln1``, ``self_attn``, ``ln_x``,
    ``cross_attn``, ``ln2``, ``mlp``) and ``dec_ln``, named as the
    reference's pytree paths."""


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """[..., d] float32: sin then cos of ``positions`` at ``d // 2``
    geometric frequencies from 1 down to 1e-4."""
    half = d // 2
    # every step in float32, as the reference's jnp arithmetic (the two
    # libraries' float32 exp still differ by an ulp on some frequencies)
    log_base = torch.log(torch.tensor(10000.0, device=positions.device))
    freqs = torch.exp(-log_base * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> EncDec:
    dt, dev = cfg.param_dtype, gen.device

    def ln():
        return init_layernorm(cfg.d_model, dt, dev)

    def enc_layer():
        return Params(ln1=ln(), attn=attn_lib.init_attention(gen, cfg),
                      ln2=ln(), mlp=init_mlp(gen, cfg))

    def dec_layer():
        return Params(ln1=ln(), self_attn=attn_lib.init_attention(gen, cfg),
                      ln_x=ln(), cross_attn=attn_lib.init_attention(gen, cfg),
                      ln2=ln(), mlp=init_mlp(gen, cfg))

    return EncDec(
        embed=Params(table=trunc_normal(gen, (cfg.vocab_size, cfg.d_model),
                                        dt)),
        enc_layers=nn.ModuleList(enc_layer()
                                 for _ in range(cfg.encoder_layers)),
        enc_ln=ln(),
        dec_layers=nn.ModuleList(dec_layer()
                                 for _ in range(cfg.num_layers)),
        dec_ln=ln())


def encdec_logical_axes(cfg: ModelConfig) -> dict:
    """The reference's axes tree: ``enc_layers`` / ``dec_layers`` are its
    stacked ``[L, ...]`` leaves (the port's per-layer tensors drop the
    leading ``"layers"``)."""
    ln = {"scale": ("embed",), "bias": ("embed",)}
    attn_ax = attn_lib.attention_logical_axes(cfg)
    enc = {"ln1": dict(ln), "attn": attn_ax, "ln2": dict(ln),
           "mlp": mlp_logical_axes(cfg)}
    dec = {"ln1": dict(ln), "self_attn": attn_ax, "ln_x": dict(ln),
           "cross_attn": attn_ax, "ln2": dict(ln),
           "mlp": mlp_logical_axes(cfg)}
    return {"embed": {"table": ("vocab", "embed_pod")},
            "enc_layers": lift_axes(enc, ("layers",)), "enc_ln": dict(ln),
            "dec_layers": lift_axes(dec, ("layers",)), "dec_ln": dict(ln)}


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dhk->bhsk", x, w)


def _mha(p: ParamsLike, xq: torch.Tensor, xkv: torch.Tensor,
         cfg: ModelConfig, causal: bool) -> torch.Tensor:
    q, k, v = _heads(xq, p["wq"]), _heads(xkv, p["wk"]), _heads(xkv, p["wv"])
    impl = attn_lib.resolve_impl(cfg, xq.shape[1], xq.device)
    o = attn_lib.full_attention(q, k, v, causal=causal, window=None,
                                impl=impl, chunk=cfg.attn_chunk)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"])


def _add_positions(x: torch.Tensor, start: int = 0) -> torch.Tensor:
    pos = torch.arange(start, start + x.shape[1], device=x.device)
    return x + sinusoid(pos, x.shape[-1])[None].to(x.dtype)


def _embed(params: ParamsLike, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"][tokens]


def _logits(params: ParamsLike, x: torch.Tensor) -> torch.Tensor:
    x = apply_layernorm(params["dec_ln"], x)
    return x @ params["embed"]["table"].T.to(x.dtype)


def encode(params: ParamsLike, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames: [B, S_enc, d] (stub frontend output) -> memory [B, S_enc,
    d]."""
    x = _add_positions(frames)
    for lp in params["enc_layers"]:
        x = remat(cfg, functools.partial(_enc_layer, lp, cfg), x)
    return apply_layernorm(params["enc_ln"], x)


def _enc_layer(lp: ParamsLike, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    h = apply_layernorm(lp["ln1"], x)
    x = x + _mha(lp["attn"], h, h, cfg, causal=False)
    h = apply_layernorm(lp["ln2"], x)
    return x + apply_mlp(lp["mlp"], h, cfg)


def _dec_layer(lp: ParamsLike, cfg: ModelConfig, x: torch.Tensor,
               memory: torch.Tensor) -> torch.Tensor:
    h = apply_layernorm(lp["ln1"], x)
    x = x + _mha(lp["self_attn"], h, h, cfg, causal=True)
    h = apply_layernorm(lp["ln_x"], x)
    x = x + _mha(lp["cross_attn"], h, memory, cfg, causal=False)
    h = apply_layernorm(lp["ln2"], x)
    return x + apply_mlp(lp["mlp"], h, cfg)


def decode_train(params: ParamsLike, tokens: torch.Tensor,
                 memory: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder over tokens [B, S] -> logits [B, S, V]."""
    x = _add_positions(_embed(params, tokens))
    for lp in params["dec_layers"]:
        x = remat(cfg, functools.partial(_dec_layer, lp, cfg), x, memory)
    return _logits(params, x)


def forward(params: ParamsLike, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    memory = encode(params, batch["frames"], cfg)
    return decode_train(params, batch["tokens"], memory, cfg)


def encdec_loss(params: ParamsLike, batch: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """The training loss: mean token NLL of the teacher-forced decoder,
    and {"loss"}."""
    logits = forward(params, batch, cfg)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


# -- serving ------------------------------------------------------------------

def prefill(params: ParamsLike, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig, max_len: int) -> Tuple[torch.Tensor, List]:
    """Encode + run the prompt tokens; returns (logits [B, S, V], caches):
    one dict per decoder layer, ``{"self": KVCache of max_len positions,
    "cross_k", "cross_v": the memory's K/V [B, KV, S_enc, hd]}``."""
    memory = encode(params, frames, cfg)
    b, s = tokens.shape
    x = _add_positions(_embed(params, tokens))
    caches: List[Any] = []
    for lp in params["dec_layers"]:
        sa, ca = lp["self_attn"], lp["cross_attn"]
        h = apply_layernorm(lp["ln1"], x)
        q, k, v = _heads(h, sa["wq"]), _heads(h, sa["wk"]), _heads(h, sa["wv"])
        o = attn_lib.full_attention(q, k, v, causal=True, window=None,
                                    impl="chunked", chunk=cfg.attn_chunk)
        x = x + torch.einsum("bhsk,hkd->bsd", o, sa["wo"])
        kc = torch.zeros((b, cfg.num_kv_heads, max_len, cfg.hd),
                         dtype=k.dtype, device=k.device)
        vc = torch.zeros_like(kc)
        kc[:, :, :s] = k
        vc[:, :, :s] = v
        h = apply_layernorm(lp["ln_x"], x)
        ck, cv = _heads(memory, ca["wk"]), _heads(memory, ca["wv"])
        ox = attn_lib.full_attention(_heads(h, ca["wq"]), ck, cv,
                                     causal=False, window=None,
                                     impl="chunked", chunk=cfg.attn_chunk)
        x = x + torch.einsum("bhsk,hkd->bsd", ox, ca["wo"])
        h = apply_layernorm(lp["ln2"], x)
        x = x + apply_mlp(lp["mlp"], h, cfg)
        caches.append({"self": KVCache(kc, vc, s), "cross_k": ck,
                       "cross_v": cv})
    return _logits(params, x), caches


def decode_step(params: ParamsLike, caches: List[Any], tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, List]:
    """tokens: [B] -> (logits [B, V], caches'): one step with the self
    KV cache (written in place) and the fixed cross K/V."""
    pos = caches[0]["self"].pos
    x = _add_positions(_embed(params, tokens[:, None]), start=pos)
    new_caches: List[Any] = []
    for lp, c in zip(params["dec_layers"], caches):
        h = apply_layernorm(lp["ln1"], x)
        a, kv = attn_lib.decode_attention(lp["self_attn"], h, c["self"], cfg,
                                          rope=False)
        x = x + a
        h = apply_layernorm(lp["ln_x"], x)
        q = _heads(h, lp["cross_attn"]["wq"])
        o = attn_lib.full_attention(q, c["cross_k"], c["cross_v"],
                                    causal=False, window=None, impl="ref")
        x = x + torch.einsum("bhsk,hkd->bsd", o, lp["cross_attn"]["wo"])
        h = apply_layernorm(lp["ln2"], x)
        x = x + apply_mlp(lp["mlp"], h, cfg)
        new_caches.append({"self": kv, "cross_k": c["cross_k"],
                           "cross_v": c["cross_v"]})
    return _logits(params, x)[:, 0], new_caches
