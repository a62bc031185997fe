"""Decoder LM assembly: the dense, MoE, hybrid, vlm, ssm and jamba families.

The reference's ``models/transformer.py`` for ``family`` ``"dense"``,
``"moe"`` (whose blocks hold ``moe`` in place of ``mlp``), ``"hybrid"``
(hymba: attention and an SSM side by side in every block, sliding-window
attention on all but the global layers), ``"vlm"`` (internvl2: the dense
stack with ``patch_embeds`` projected by ``patch_proj`` and prepended to
the text, positions running over both) and ``"ssm"`` (xlstm: units of
``slstm_every - 1`` mLSTM blocks and one sLSTM block,
``models/xlstm.py``), and ``"jamba"`` (layers of two kinds: GQA
attention without positions, or the published Mamba-1 mixer,
``ssm.mamba_mixer``; and a dense MLP or an MoE feed-forward; each
layer's kinds from the period and offset keys,
:meth:`JambaConfig.layer_kind`). Its ``lax.scan`` over stacked layer
parameters becomes a Python loop over one module per layer (PyTorch runs
eagerly: there is no graph whose size depth could grow), so
``scan_layers`` selects nothing. ``remat`` recomputes each layer (each
xlstm unit) in the backward pass through ``torch.utils.checkpoint``
where gradients are taken, as the reference's ``jax.checkpoint``. Under
an active mesh (``sharding.use_rules``) a hybrid prefill with
``cfg.ssm_cp`` runs each layer's SSM block context-parallel
(``models/ssm_cp.py``) and, as the reference's, returns zero SSM states.
The ``"audio"`` family is ``models/encdec.py``. A prefill and a decode
step run under the spans ``lm.prefill`` and ``lm.decode_step`` and add
their tokens to the ``lm.tokens_prefilled`` and ``lm.tokens_decoded``
counters; a jamba layer's mixer runs under ``lm.attention`` or
``lm.mamba`` (the MoE under ``lm.moe``, ``models/moe.py``).
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.attention import KVCache, init_kv_cache
from repro_torch.models.common import (ModelConfig, Params, lift_axes,
                                       remat, trunc_normal)
from repro_torch.models.layers import (ParamsLike, apply_mlp, apply_norm,
                                       cross_entropy, embed_tokens,
                                       embedding_logical_axes,
                                       init_embedding, init_mlp, init_norm,
                                       mlp_logical_axes, unembed)
from repro_torch.models.ssm_cp import ssm_block_context_parallel
from repro_torch.obs import METRICS, span
from repro_torch.sharding import active

#: The families the port runs.
PORTED_FAMILIES = ("dense", "moe", "hybrid", "vlm", "audio", "ssm",
                   "jamba")
BIG_WINDOW = 1 << 30   # "global attention" encoded as a huge window

#: Where each family the port does not run yet is ported (ROADMAP.md):
#: none is left.
PENDING_FAMILIES: Dict[str, str] = {}


def require_ported_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {', '.join(PORTED_FAMILIES)}"
            f" families; {cfg.family!r} comes with "
            f"{PENDING_FAMILIES.get(cfg.family, 'a later ROADMAP item')}")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

class Block(Params):
    """One decoder layer: ``norm1``, ``attn``, ``norm2``, and ``mlp``
    (dense) or ``moe`` (MoE); a hybrid layer adds ``ssm``, ``norm_a`` and
    ``norm_s``; a jamba layer holds ``attn`` or ``mamba``, and ``mlp`` or
    ``moe``, as :meth:`JambaConfig.layer_kind` says."""


def init_block(gen: torch.Generator, cfg: ModelConfig, i: int = 0
               ) -> Block:
    """Layer ``i``'s parameters (``i`` picks a jamba layer's kinds)."""
    require_ported_family(cfg)
    dev = gen.device
    if cfg.family == "jamba":
        mixer, ffn = cfg.layer_kind(i)
        p = dict(norm1=init_norm(cfg, device=dev),
                 norm2=init_norm(cfg, device=dev))
        if mixer == "attention":
            p["attn"] = attn_lib.init_attention(gen, cfg)
        else:
            p["mamba"] = ssm_lib.init_mamba(gen, cfg)
        p[ffn] = (moe_lib.init_moe(gen, cfg) if ffn == "moe"
                  else init_mlp(gen, cfg))
        return Block(**p)
    p = dict(norm1=init_norm(cfg, device=dev),
             norm2=init_norm(cfg, device=dev),
             attn=attn_lib.init_attention(gen, cfg))
    if cfg.family == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg)
    elif cfg.family == "hybrid":
        p["ssm"] = ssm_lib.init_ssm(gen, cfg)
        p["mlp"] = init_mlp(gen, cfg)
        p["norm_a"] = init_norm(cfg, device=dev)
        p["norm_s"] = init_norm(cfg, device=dev)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return Block(**p)


def block_logical_axes(cfg: ModelConfig, i: int = 0) -> dict:
    norm = {"scale": ("embed",)} if not cfg.use_layernorm else \
        {"scale": ("embed",), "bias": ("embed",)}
    p: dict = {"norm1": dict(norm), "norm2": dict(norm)}
    if cfg.family == "jamba":
        mixer, ffn = cfg.layer_kind(i)
        if mixer == "attention":
            p["attn"] = attn_lib.attention_logical_axes(cfg)
        else:
            p["mamba"] = ssm_lib.mamba_logical_axes(cfg)
        p[ffn] = (moe_lib.moe_logical_axes(cfg) if ffn == "moe"
                  else mlp_logical_axes(cfg))
    elif cfg.family in ("dense", "vlm", "audio"):
        p["attn"] = attn_lib.attention_logical_axes(cfg)
        p["mlp"] = mlp_logical_axes(cfg)
    elif cfg.family == "moe":
        p["attn"] = attn_lib.attention_logical_axes(cfg)
        p["moe"] = moe_lib.moe_logical_axes(cfg)
    elif cfg.family == "hybrid":
        p["attn"] = attn_lib.attention_logical_axes(cfg)
        p["ssm"] = ssm_lib.ssm_logical_axes(cfg)
        p["mlp"] = mlp_logical_axes(cfg)
        p["norm_a"] = dict(norm)
        p["norm_s"] = dict(norm)
    return p


def apply_ffn(p: ParamsLike, h: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's feed-forward half: (y, MoE aux loss or None)."""
    if cfg.family == "moe":
        y, stats = moe_lib.moe_ffn(p["moe"], h, cfg)
        return y, stats.aux_loss
    return apply_mlp(p["mlp"], h, cfg), None


def jamba_ffn(p: ParamsLike, h: torch.Tensor, cfg: ModelConfig, i: int
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A jamba layer's feed-forward half: (y, MoE aux loss or None)."""
    if cfg.layer_kind(i)[1] == "moe":
        y, stats = moe_lib.moe_ffn(p["moe"], h, cfg)
        return y, stats.aux_loss
    return apply_mlp(p["mlp"], h, cfg), None


def apply_jamba_block(p: ParamsLike, x: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig, i: int,
                      max_len: Optional[int] = None):
    """Jamba layer ``i`` over a whole sequence, from zero states: ``x +
    mixer(norm1(x))``, then ``+ ffn(norm2(x))``.  Returns (x', aux); with
    ``max_len`` (a prefill), (x', aux, the layer's LayerCache): an
    attention layer's K/V in a cache of ``max_len`` positions, a Mamba
    layer's final (conv window, h).  A prefill takes no gradient and
    drops its x for x', so there both residual adds write into ``x``:
    the layer holds one residual stream, not two."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg, p["norm1"], x)
    cache = None
    if cfg.layer_kind(i)[0] == "attention":
        with span("lm.attention", layer=i):
            if max_len is None:
                a = attn_lib.self_attention(p["attn"], h, positions, cfg)
            else:
                a, (kt, vt) = attn_lib.self_attention(
                    p["attn"], h, positions, cfg, return_kv=True)
                cache = LayerCache("attention", kv=_fill_kv_cache(
                    cfg, kt, vt, None, max_len, x.shape[1]))
                del kt, vt
    else:
        state = None if max_len is None else ssm_lib.init_ssm_state(
            cfg, x.shape[0], device=x.device)
        with span("lm.mamba", layer=i):
            a, st = ssm_lib.mamba_mixer(p["mamba"], h, cfg, state=state)
        if max_len is not None:
            cache = LayerCache("mamba", ssm=st)
    del h
    x = x + a if max_len is None else x.add_(a)
    del a
    y, moe_aux = jamba_ffn(p, apply_norm(cfg, p["norm2"], x), cfg, i)
    if moe_aux is not None:
        aux = aux + moe_aux
    if max_len is None:
        return x + y, aux
    return x.add_(y), aux, cache


def join_heads(cfg: ModelConfig, p: ParamsLike, x: torch.Tensor,
               a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """A hybrid block's residual: ``x + 0.5 * (norm_a(a) + norm_s(s))``
    over its attention output ``a`` and SSM output ``s``."""
    a = apply_norm(cfg, p["norm_a"], a)
    s = apply_norm(cfg, p["norm_s"], s)
    return x + 0.5 * (a + s)


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
    if cfg.family == "hybrid":
        s, _ = ssm_lib.ssm_block(p["ssm"], h, cfg)
        x = join_heads(cfg, p, x, a, s)
    else:
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
# xLSTM stack (units of (k-1) mLSTM + 1 sLSTM)
# ---------------------------------------------------------------------------

def _xlstm_unit_shape(cfg: ModelConfig) -> Tuple[int, int]:
    """(mLSTM blocks a unit, units); units 0 = an all-mLSTM stack."""
    k = cfg.slstm_every or cfg.num_layers + 1
    if k > cfg.num_layers:
        return cfg.num_layers, 0     # all-mLSTM
    if cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                         f"split into units of {k}")
    return k - 1, cfg.num_layers // k


def _xlstm_block(gen: torch.Generator, cfg: ModelConfig,
                 init_core) -> Params:
    return Params(norm=init_norm(cfg, device=gen.device),
                  core=init_core(gen, cfg))


def init_xlstm_stack(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """``m_blocks``: a ModuleList of units, each a ModuleList of
    ``m_per`` mLSTM blocks (a flat list of ``num_layers`` when there is no
    sLSTM); ``s_blocks``: one sLSTM block a unit.  Each block holds
    ``norm`` and ``core``: the reference's stacked ``[units, m_per,
    ...]`` and ``[units, ...]`` leaves, one module a block."""
    m_per, units = _xlstm_unit_shape(cfg)
    if units == 0:
        return Params(m_blocks=nn.ModuleList(
            _xlstm_block(gen, cfg, xlstm_lib.init_mlstm)
            for _ in range(cfg.num_layers)))
    m = nn.ModuleList(
        nn.ModuleList(_xlstm_block(gen, cfg, xlstm_lib.init_mlstm)
                      for _ in range(m_per)) for _ in range(units))
    s = nn.ModuleList(_xlstm_block(gen, cfg, xlstm_lib.init_slstm)
                      for _ in range(units))
    return Params(m_blocks=m, s_blocks=s)


def xlstm_stack_logical_axes(cfg: ModelConfig) -> dict:
    m_per, units = _xlstm_unit_shape(cfg)
    norm = {"scale": ("embed",)}
    m = {"norm": dict(norm), "core": xlstm_lib.mlstm_logical_axes(cfg)}
    out = {"m_blocks": lift_axes(m, ("layers", "layers") if units
                                 else ("layers",))}
    if units:
        s = {"norm": dict(norm), "core": xlstm_lib.slstm_logical_axes(cfg)}
        out["s_blocks"] = lift_axes(s, ("layers",))
    return out


def _m_block(cfg: ModelConfig, bp: ParamsLike,
             x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, bp["norm"], x)
    return x + xlstm_lib.mlstm_block(bp["core"], h, cfg)[0]


def _s_block(cfg: ModelConfig, bp: ParamsLike,
             x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, bp["norm"], x)
    return x + xlstm_lib.slstm_block(bp["core"], h, cfg)[0]


def _xlstm_unit(cfg: ModelConfig, m_blocks, s_block: ParamsLike,
                x: torch.Tensor) -> torch.Tensor:
    for bp in m_blocks:
        x = _m_block(cfg, bp, x)
    return _s_block(cfg, s_block, x)


def apply_xlstm_stack(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig
                      ) -> torch.Tensor:
    """The stack over x [B, S, d]; ``remat`` recomputes each unit (each
    block of an all-mLSTM stack), as the reference checkpoints its scan
    bodies."""
    m_per, units = _xlstm_unit_shape(cfg)
    if units == 0:
        for bp in p["m_blocks"]:
            x = remat(cfg, functools.partial(_m_block, cfg, bp), x)
        return x
    for mu, su in zip(p["m_blocks"], p["s_blocks"]):
        x = remat(cfg, functools.partial(_xlstm_unit, cfg, mu, su), x)
    return x


def _xlstm_kinds(cfg: ModelConfig) -> List[str]:
    m_per, units = _xlstm_unit_shape(cfg)
    if units == 0:
        return ["mlstm"] * cfg.num_layers
    return (["mlstm"] * m_per + ["slstm"]) * units


def _xlstm_layers(p: ParamsLike, cfg: ModelConfig):
    """The stack's blocks in layer order: (kind, block params)."""
    m_per, units = _xlstm_unit_shape(cfg)
    if units == 0:
        for bp in p["m_blocks"]:
            yield "mlstm", bp
        return
    for mu, su in zip(p["m_blocks"], p["s_blocks"]):
        for bp in mu:
            yield "mlstm", bp
        yield "slstm", su


def _xlstm_decode(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig,
                  caches: List["LayerCache"],
                  new_caches: List["LayerCache"]) -> torch.Tensor:
    """One token x [B, 1, d] through every block, each stepping its
    state once."""
    for (kind, bp), c in zip(_xlstm_layers(p, cfg), caches):
        h = apply_norm(cfg, bp["norm"], x)
        if kind == "mlstm":
            y, st = xlstm_lib.mlstm_block(bp["core"], h, cfg, state=c.mls)
            new_caches.append(LayerCache("mlstm", mls=st))
        else:
            y, st = xlstm_lib.slstm_block(bp["core"], h, cfg, state=c.sls)
            new_caches.append(LayerCache("slstm", sls=st))
        x = x + y
    return x


def prefill_ssm(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, List["LayerCache"]]:
    """xLSTM prefill: run the blocks statefully from zero states,
    collecting each one's final state."""
    b = tokens.shape[0]
    x = embed_tokens(params["embed"], tokens, cfg)
    caches: List[LayerCache] = []
    for kind, bp in _xlstm_layers(params["xlstm"], cfg):
        h = apply_norm(cfg, bp["norm"], x)
        if kind == "mlstm":
            y, st = xlstm_lib.mlstm_block(
                bp["core"], h, cfg,
                state=xlstm_lib.init_mlstm_state(cfg, b, x.device))
            caches.append(LayerCache("mlstm", mls=st))
        else:
            y, st = xlstm_lib.slstm_block(
                bp["core"], h, cfg,
                state=xlstm_lib.init_slstm_state(cfg, b, x.device))
            caches.append(LayerCache("slstm", sls=st))
        x = x + y
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x, cfg), caches


# ---------------------------------------------------------------------------
# LM init / forward
# ---------------------------------------------------------------------------

class LM(Params):
    """The model's parameters: ``embed``, ``blocks`` (one :class:`Block`
    per layer; ``xlstm`` in their place for the ssm family),
    ``final_norm``, and for vlm ``patch_proj`` [d, d].  Names follow the
    reference's pytree paths: ``blocks.3.attn.wq``, ``embed.table``,
    ``final_norm.scale``, ``xlstm.m_blocks.2.5.core.wq``."""


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> LM:
    require_ported_family(cfg)
    p = dict(embed=init_embedding(gen, cfg),
             final_norm=init_norm(cfg, device=gen.device))
    if cfg.family == "ssm":
        p["xlstm"] = init_xlstm_stack(gen, cfg)
    else:
        p["blocks"] = nn.ModuleList(init_block(gen, cfg, i)
                                    for i in range(cfg.num_layers))
    if cfg.family == "vlm" and cfg.num_patches:
        p["patch_proj"] = trunc_normal(gen, (cfg.d_model, cfg.d_model),
                                       cfg.param_dtype)
    return LM(**p)


def lm_logical_axes(cfg: ModelConfig) -> dict:
    """The reference's logical axes of the model's parameters, a nested
    dict by its pytree paths: a stacked ``[L, ...]`` leaf leads with
    ``"layers"`` (two for xlstm's ``[units, m_per, ...]`` mLSTM blocks),
    which the port's per-layer tensors drop
    (``checkpoint/elastic.shardings_for_params``)."""
    p: dict = {"embed": embedding_logical_axes(cfg),
               "final_norm": {"scale": ("embed",)}
               if not cfg.use_layernorm
               else {"scale": ("embed",), "bias": ("embed",)}}
    if cfg.family == "ssm":
        p["xlstm"] = xlstm_stack_logical_axes(cfg)
    elif cfg.family == "jamba":
        # layers of several kinds: one tree a layer, not a stacked leaf
        p["blocks"] = {str(i): block_logical_axes(cfg, i)
                       for i in range(cfg.num_layers)}
    else:
        p["blocks"] = lift_axes(block_logical_axes(cfg), ("layers",))
    if cfg.family == "vlm" and cfg.num_patches:
        p["patch_proj"] = ("embed", None)
    return p


def layer_windows(cfg: ModelConfig) -> Optional[List[int]]:
    """Per-layer attention window; ``BIG_WINDOW`` marks a global layer.
    None = uniform full attention."""
    if cfg.window is None:
        return None
    w = [cfg.window] * cfg.num_layers
    for g in cfg.global_layers:
        w[g] = BIG_WINDOW
    return w


def layer_window(cfg: ModelConfig, i: int) -> Optional[int]:
    """Layer ``i``'s window for the attention call: None for full
    (global) attention."""
    windows = layer_windows(cfg)
    if windows is None or windows[i] >= BIG_WINDOW:
        return None
    return windows[i]


def embed_inputs(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig,
                 patch_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The token embeddings [B, S_text, d]; with ``patch_embeds`` [B, P,
    d] (vlm's stub vision tower output) projected by ``patch_proj`` and
    prepended: [B, P + S_text, d]."""
    x = embed_tokens(params["embed"], tokens, cfg)
    if patch_embeds is None:
        return x
    pe = patch_embeds.to(x.dtype) @ params["patch_proj"]
    return torch.cat([pe, x], dim=1)


def forward(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig,
            patch_embeds: Optional[torch.Tensor] = None,
            return_kv: bool = False):
    """tokens: [B, S_text] -> (logits [B, S, V], aux_loss[, (K, V)]).

    For vlm, ``patch_embeds`` [B, P, d] are projected and prepended; S =
    P + S_text.  With ``return_kv`` (uniform full-attention stacks only)
    the per-layer KV stacks [L, B, KV, S, hd] come back too (the prefill
    path).
    """
    require_ported_family(cfg)
    if return_kv and cfg.family in ("hybrid", "ssm", "jamba"):
        raise ValueError("return_kv takes a uniform full-attention stack")
    x = embed_inputs(params, tokens, cfg, patch_embeds)
    b, s, _ = x.shape
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x = apply_xlstm_stack(params["xlstm"], x, cfg)
        x = apply_norm(cfg, params["final_norm"], x)
        return unembed(params["embed"], x, cfg), aux_total
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    if cfg.family == "jamba":
        for i, bp in enumerate(params["blocks"]):
            x, a = remat(cfg, functools.partial(
                apply_jamba_block, bp, cfg=cfg, i=i), x, positions)
            aux_total = aux_total + a
        x = apply_norm(cfg, params["final_norm"], x)
        return unembed(params["embed"], x, cfg), aux_total
    for i, bp in enumerate(params["blocks"]):
        out = remat(cfg, functools.partial(
            apply_block, bp, cfg=cfg, window=layer_window(cfg, i),
            return_kv=return_kv), x, positions)
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
    """The training loss: mean token NLL plus ``aux_weight`` times the
    MoE aux loss, and {"loss", "aux_loss"}; vlm's patch positions carry
    no label and are skipped.  Gradients flow to every parameter that
    requires grad (through the flash kernel's backward on the card)."""
    logits, aux = forward(params, batch["tokens"], cfg,
                          patch_embeds=batch.get("patch_embeds"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    loss = cross_entropy(logits, labels, batch.get("mask"))
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
                    cfg: ModelConfig, max_len: int,
                    patch_embeds: Optional[torch.Tensor] = None):
    """Prefill for uniform stacks (dense, MoE, vlm): logits [B, S, V] and
    a StackedKV of ``max_len`` positions holding the prompt's K/V (S = P
    + S_text with ``patch_embeds``; decode goes on from S)."""
    logits, _, (kt, vt) = forward(params, tokens, cfg,
                                  patch_embeds=patch_embeds, return_kv=True)
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


class LayerCache(NamedTuple):
    """One layer's decode state in a heterogeneous stack: a hybrid layer
    holds its attention cache (a ring buffer of ``window`` slots on a
    sliding-window layer) and its SSM state; an xlstm block its mLSTM or
    sLSTM state; a jamba layer its KV cache (``attention``) or its (conv
    window, h) state (``mamba``)."""
    kind: str          # hybrid | mlstm | slstm | attention | mamba
    kv: Optional[KVCache] = None
    ssm: Optional[ssm_lib.SSMState] = None
    mls: Optional[xlstm_lib.MLSTMState] = None
    sls: Optional[xlstm_lib.SLSTMState] = None


Caches = Union[StackedKV, List[LayerCache]]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Caches:
    """A StackedKV for uniform stacks; for hybrid, one LayerCache per
    layer: sliding-window layers get ring buffers (O(window)), the SSM
    O(1) recurrent state; for ssm, one LayerCache per xlstm block with
    its O(1) state; for jamba, one a layer: a full KV cache on an
    attention layer, the Mamba state on the others."""
    require_ported_family(cfg)
    if cfg.family == "jamba":
        return [LayerCache("attention", kv=init_kv_cache(
                    cfg, batch, max_len, device=device))
                if cfg.layer_kind(i)[0] == "attention" else
                LayerCache("mamba", ssm=ssm_lib.init_ssm_state(
                    cfg, batch, device=device))
                for i in range(cfg.num_layers)]
    if cfg.family == "ssm":
        return [LayerCache("mlstm",
                           mls=xlstm_lib.init_mlstm_state(cfg, batch, device))
                if kind == "mlstm" else
                LayerCache("slstm",
                           sls=xlstm_lib.init_slstm_state(cfg, batch, device))
                for kind in _xlstm_kinds(cfg)]
    if cfg.family != "hybrid":
        return init_stacked_cache(cfg, batch, max_len, device=device)
    return [LayerCache("hybrid",
                       kv=init_kv_cache(cfg, batch, max_len,
                                        window=layer_window(cfg, i),
                                        device=device),
                       ssm=ssm_lib.init_ssm_state(cfg, batch, device=device))
            for i in range(cfg.num_layers)]


def decode_step(params: ParamsLike, caches: Caches, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Caches]:
    """tokens: [B] -> (logits [B, V], caches').

    A StackedKV takes the uniform path; a list of LayerCache loops over
    layers: a hybrid layer attends to its cache and steps its SSM state
    once, an xlstm block steps its state once, a jamba layer does
    either."""
    require_ported_family(cfg)
    METRICS.counter("lm.tokens_decoded").inc(tokens.shape[0])
    with span("lm.decode_step", batch=tokens.shape[0]):
        return _decode_step(params, caches, tokens, cfg)


def _decode_step(params: ParamsLike, caches: Caches, tokens: torch.Tensor,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Caches]:
    if cfg.family == "jamba":
        return decode_step_jamba(params, caches, tokens, cfg)
    if isinstance(caches, StackedKV):
        return decode_step_scanned(params, caches, tokens, cfg)
    x = embed_tokens(params["embed"], tokens[:, None], cfg)
    new_caches: List[LayerCache] = []
    if cfg.family == "ssm":
        x = _xlstm_decode(params["xlstm"], x, cfg, caches, new_caches)
        x = apply_norm(cfg, params["final_norm"], x)
        return unembed(params["embed"], x, cfg)[:, 0], new_caches
    for bp, c in zip(params["blocks"], caches):
        h = apply_norm(cfg, bp["norm1"], x)
        a, kv = attn_lib.decode_attention(bp["attn"], h, c.kv, cfg)
        s, st = ssm_lib.ssm_block(bp["ssm"], h, cfg, state=c.ssm)
        x = join_heads(cfg, bp, x, a, s)
        new_caches.append(LayerCache("hybrid", kv=kv, ssm=st))
        h = apply_norm(cfg, bp["norm2"], x)
        x = x + apply_ffn(bp, h, cfg)[0]
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], x, cfg)
    return logits[:, 0], new_caches


def prefill(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: Optional[int] = None,
            patch_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Caches]:
    """Run the full prompt, returning (logits [B, S, V], filled caches);
    with ``patch_embeds`` ``max_len`` must count the patch positions too.
    Where ``cfg.logits_to_keep`` is k > 0 (the jamba family), the logits
    of the last k positions alone, [B, k, V]."""
    require_ported_family(cfg)
    METRICS.counter("lm.tokens_prefilled").inc(tokens.numel())
    with span("lm.prefill", batch=tokens.shape[0], tokens=tokens.shape[1]):
        return _prefill(params, tokens, cfg, max_len, patch_embeds)


def _prefill(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig,
             max_len: Optional[int],
             patch_embeds: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, Caches]:
    b, s = tokens.shape
    max_len = max_len or s
    if cfg.family == "jamba":
        return prefill_jamba(params, tokens, cfg, max_len)
    if cfg.family == "ssm":
        return prefill_ssm(params, tokens, cfg)
    if cfg.family != "hybrid":
        return prefill_scanned(params, tokens, cfg, max_len,
                               patch_embeds=patch_embeds)
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cp_mesh = _context_parallel_mesh(cfg, s)
    caches: List[LayerCache] = []
    for i, bp in enumerate(params["blocks"]):
        w = layer_window(cfg, i)
        h = apply_norm(cfg, bp["norm1"], x)
        a, (kt, vt) = attn_lib.self_attention(bp["attn"], h, positions, cfg,
                                              window=w, return_kv=True)
        if cp_mesh is not None:
            s_out = ssm_block_context_parallel(
                bp["ssm"], h, cfg, cp_mesh,
                batch_axes=tuple(a for a in ("pod", "data")
                                 if a in cp_mesh.shape))
            st = ssm_lib.init_ssm_state(cfg, b, device=x.device)  # stateless
        else:
            s_out, st = ssm_lib.ssm_block(
                bp["ssm"], h, cfg,
                state=ssm_lib.init_ssm_state(cfg, b, device=x.device))
        x = join_heads(cfg, bp, x, a, s_out)
        caches.append(LayerCache("hybrid", kv=_fill_kv_cache(
            cfg, kt, vt, w, max_len, s), ssm=st))
        h = apply_norm(cfg, bp["norm2"], x)
        x = x + apply_ffn(bp, h, cfg)[0]
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x, cfg), caches


def _context_parallel_mesh(cfg: ModelConfig, s: int):
    """The active mesh when a hybrid prefill of ``s`` positions takes the
    context-parallel SSM block (``cfg.ssm_cp`` and a ``model`` axis of
    more than one shard that divides ``s``), else None."""
    _, mesh = active()
    if cfg.ssm_cp and mesh is not None and \
            mesh.shape.get("model", 1) > 1 and s % mesh.shape["model"] == 0:
        return mesh
    return None


def _fill_kv_cache(cfg: ModelConfig, kt: torch.Tensor, vt: torch.Tensor,
                   window: Optional[int], max_len: int, s: int) -> KVCache:
    """A layer's cache holding the prompt's K/V [B, KV, S, hd]: a window
    keeps the last ``window`` positions in the ring layout (position p at
    slot p % size), a global layer all ``max_len`` slots."""
    cache = init_kv_cache(cfg, kt.shape[0], max_len, window=window,
                          dtype=kt.dtype, device=kt.device)
    if window:
        size = cache.k.shape[2]
        take = min(window, s)
        slots = torch.arange(s - take, s, device=kt.device) % size
        cache.k[:, :, slots] = kt[:, :, s - take:s]
        cache.v[:, :, slots] = vt[:, :, s - take:s]
    else:
        cache.k[:, :, :s] = kt
        cache.v[:, :, :s] = vt
    cache.pos = s
    return cache


def prefill_jamba(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig,
                  max_len: int) -> Tuple[torch.Tensor, List[LayerCache]]:
    """The jamba prefill: each layer over the prompt from zero states
    (:func:`apply_jamba_block` keeping its cache); the logits of the last
    ``cfg.logits_to_keep`` positions (all where it is 0)."""
    b, s = tokens.shape
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    caches: List[LayerCache] = []
    for i, bp in enumerate(params["blocks"]):
        x, _, cache = apply_jamba_block(bp, x, positions, cfg, i,
                                        max_len=max_len)
        caches.append(cache)
    if cfg.logits_to_keep:
        x = x[:, -cfg.logits_to_keep:]
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x, cfg), caches


def decode_step_jamba(params: ParamsLike, caches: List[LayerCache],
                      tokens: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, List[LayerCache]]:
    """One token through every jamba layer: an attention layer attends to
    its cache (no positions) and writes the token's K/V into it, a Mamba
    layer steps its state once."""
    x = embed_tokens(params["embed"], tokens[:, None], cfg)
    new_caches: List[LayerCache] = []
    for i, (bp, c) in enumerate(zip(params["blocks"], caches)):
        h = apply_norm(cfg, bp["norm1"], x)
        if c.kind == "attention":
            with span("lm.attention", layer=i):
                a, kv = attn_lib.decode_attention(bp["attn"], h, c.kv, cfg,
                                                  rope=cfg.use_rope)
            new_caches.append(LayerCache("attention", kv=kv))
        else:
            with span("lm.mamba", layer=i):
                a, st = ssm_lib.mamba_mixer(bp["mamba"], h, cfg, state=c.ssm)
            new_caches.append(LayerCache("mamba", ssm=st))
        x = x + a
        x = x + jamba_ffn(bp, apply_norm(cfg, bp["norm2"], x), cfg, i)[0]
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x, cfg)[:, 0], new_caches
