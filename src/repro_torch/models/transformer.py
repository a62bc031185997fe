"""Decoder LM assembly: the dense, MoE, hybrid, vlm, ssm and jamba families.

The reference's ``models/transformer.py``, built from layers, not
families: :meth:`ModelConfig.layer_kind` names layer ``i``'s mixer
(``"attention"``; ``"hybrid"``, hymba's attention and SSM side by side;
``"mamba"``, the published Mamba-1 mixer) and feed-forward (``"mlp"`` or
``"moe"``), and :data:`MIXERS` and :data:`FFNS` say how each kind is
built, given logical axes and run: over a whole sequence, over a prompt
keeping its decode state, or one decode step.  The family decides only
the stack: the ssm family's xlstm units (``slstm_every - 1`` mLSTM blocks
and one sLSTM block, ``models/xlstm.py``), and the cache container.  With
``num_patches`` (vlm) ``patch_embeds`` are projected by ``patch_proj`` and
prepended to the text, positions running over both.  The ``"audio"``
family is ``models/encdec.py``.  The reference's ``lax.scan`` over
stacked layer parameters becomes a Python loop over one module per layer
(PyTorch runs eagerly: there is no graph whose size depth could grow), so
``scan_layers`` selects nothing. ``remat`` recomputes each layer (each
xlstm unit) in the backward pass through ``torch.utils.checkpoint`` where
gradients are taken, as the reference's ``jax.checkpoint``. Under an
active mesh (``sharding.use_rules``) a hybrid prefill with ``cfg.ssm_cp``
runs each layer's SSM block context-parallel (``models/ssm_cp.py``) and,
as the reference's, returns zero SSM states.  A prefill and a decode step
run under the spans ``lm.prefill`` and ``lm.decode_step`` and add their
tokens to the ``lm.tokens_prefilled`` and ``lm.tokens_decoded``
counters; a layer's attention runs under ``lm.attention``, a Mamba mixer
under ``lm.mamba`` (the MoE under ``lm.moe``, ``models/moe.py``).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

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


def require_ported_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {', '.join(PORTED_FAMILIES)}"
            f" families, not {cfg.family!r}")


def _stacked_kv(cfg: ModelConfig) -> bool:
    """Whether the stack's decode state is one :class:`StackedKV` (the
    reference's layout): every layer full attention with no other state,
    the dense, moe and vlm families."""
    return cfg.family in ("dense", "moe", "vlm")


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


class LayerCache(NamedTuple):
    """One layer's decode state in a stack of per-layer caches: an
    attention layer's KV cache (a ring buffer of ``window`` slots on a
    sliding-window layer), a hybrid layer's KV cache and SSM state, a
    Mamba layer's (conv window, h), an xlstm block's mLSTM or sLSTM
    state."""
    kind: str          # hybrid | mlstm | slstm | attention | mamba
    kv: Optional[KVCache] = None
    ssm: Optional[ssm_lib.SSMState] = None
    mls: Optional[xlstm_lib.MLSTMState] = None
    sls: Optional[xlstm_lib.SLSTMState] = None


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


def _context_parallel_mesh(cfg: ModelConfig, s: int):
    """The active mesh when a hybrid prefill of ``s`` positions takes the
    context-parallel SSM block (``cfg.ssm_cp`` and a ``model`` axis of
    more than one shard that divides ``s``), else None."""
    _, mesh = active()
    if cfg.ssm_cp and mesh is not None and \
            mesh.shape.get("model", 1) > 1 and s % mesh.shape["model"] == 0:
        return mesh
    return None


# ---------------------------------------------------------------------------
# Layer kinds: what a layer holds and how it runs
# ---------------------------------------------------------------------------

def _norm_axes(cfg: ModelConfig) -> dict:
    return {"scale": ("embed",)} if not cfg.use_layernorm else \
        {"scale": ("embed",), "bias": ("embed",)}


def _attention(p: ParamsLike, h: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, i: int, return_kv: bool = False):
    with span("lm.attention", layer=i):
        return attn_lib.self_attention(p["attn"], h, positions, cfg,
                                       window=layer_window(cfg, i),
                                       return_kv=return_kv)


def _attention_prefill(p: ParamsLike, h: torch.Tensor,
                       positions: torch.Tensor, cfg: ModelConfig, i: int,
                       max_len: int) -> Tuple[torch.Tensor, LayerCache]:
    w = layer_window(cfg, i)
    with span("lm.attention", layer=i):
        a, (kt, vt) = attn_lib.self_attention(p["attn"], h, positions, cfg,
                                              window=w, return_kv=True)
        cache = LayerCache("attention", kv=_fill_kv_cache(
            cfg, kt, vt, w, max_len, h.shape[1]))
        del kt, vt
    return a, cache


def _attention_decode(p: ParamsLike, h: torch.Tensor, c: LayerCache,
                      cfg: ModelConfig, i: int
                      ) -> Tuple[torch.Tensor, LayerCache]:
    with span("lm.attention", layer=i):
        a, kv = attn_lib.decode_attention(p["attn"], h, c.kv, cfg,
                                          rope=cfg.use_rope)
    return a, LayerCache("attention", kv=kv)


def _attention_state(cfg: ModelConfig, i: int, batch: int, max_len: int,
                     device) -> LayerCache:
    return LayerCache("attention", kv=init_kv_cache(
        cfg, batch, max_len, window=layer_window(cfg, i), device=device))


def _hybrid_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return dict(attn=attn_lib.init_attention(gen, cfg),
                ssm=ssm_lib.init_ssm(gen, cfg),
                norm_a=init_norm(cfg, device=gen.device),
                norm_s=init_norm(cfg, device=gen.device))


def _join(cfg: ModelConfig, p: ParamsLike, a: torch.Tensor,
          s: torch.Tensor) -> torch.Tensor:
    """A hybrid layer's residual update ``0.5 * (norm_a(a) + norm_s(s))``
    over its attention output ``a`` and SSM output ``s``."""
    return 0.5 * (apply_norm(cfg, p["norm_a"], a)
                  + apply_norm(cfg, p["norm_s"], s))


def _hybrid(p: ParamsLike, h: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig, i: int) -> torch.Tensor:
    a = _attention(p, h, positions, cfg, i)
    return _join(cfg, p, a, ssm_lib.ssm_block(p["ssm"], h, cfg)[0])


def _hybrid_prefill(p: ParamsLike, h: torch.Tensor,
                    positions: torch.Tensor, cfg: ModelConfig, i: int,
                    max_len: int) -> Tuple[torch.Tensor, LayerCache]:
    a, att = _attention_prefill(p, h, positions, cfg, i, max_len)
    b = h.shape[0]
    cp_mesh = _context_parallel_mesh(cfg, h.shape[1])
    if cp_mesh is not None:
        s = ssm_block_context_parallel(
            p["ssm"], h, cfg, cp_mesh,
            batch_axes=tuple(ax for ax in ("pod", "data")
                             if ax in cp_mesh.shape))
        st = ssm_lib.init_ssm_state(cfg, b, device=h.device)  # stateless
    else:
        s, st = ssm_lib.ssm_block(
            p["ssm"], h, cfg,
            state=ssm_lib.init_ssm_state(cfg, b, device=h.device))
    return _join(cfg, p, a, s), LayerCache("hybrid", kv=att.kv, ssm=st)


def _hybrid_decode(p: ParamsLike, h: torch.Tensor, c: LayerCache,
                   cfg: ModelConfig, i: int
                   ) -> Tuple[torch.Tensor, LayerCache]:
    a, att = _attention_decode(p, h, c, cfg, i)
    s, st = ssm_lib.ssm_block(p["ssm"], h, cfg, state=c.ssm)
    return _join(cfg, p, a, s), LayerCache("hybrid", kv=att.kv, ssm=st)


def _mamba(p: ParamsLike, h: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, i: int) -> torch.Tensor:
    with span("lm.mamba", layer=i):
        return ssm_lib.mamba_mixer(p["mamba"], h, cfg)[0]


def _mamba_prefill(p: ParamsLike, h: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, i: int, max_len: int
                   ) -> Tuple[torch.Tensor, LayerCache]:
    c = LayerCache("mamba", ssm=ssm_lib.init_ssm_state(cfg, h.shape[0],
                                                       device=h.device))
    return _mamba_decode(p, h, c, cfg, i)


def _mamba_decode(p: ParamsLike, h: torch.Tensor, c: LayerCache,
                  cfg: ModelConfig, i: int
                  ) -> Tuple[torch.Tensor, LayerCache]:
    with span("lm.mamba", layer=i):
        a, st = ssm_lib.mamba_mixer(p["mamba"], h, cfg, state=c.ssm)
    return a, LayerCache("mamba", ssm=st)


class Mixer(NamedTuple):
    """How a mixer kind is built and run, for block ``p`` of layer ``i``
    and its normed input ``h``:

    - ``init(gen, cfg)``: the kind's parameter groups, by name;
    - ``axes(cfg)``: their logical axes;
    - ``run(p, h, positions, cfg, i)``: what the mixer adds to the
      residual stream over a whole sequence, from zero states;
    - ``prefill(p, h, positions, cfg, i, max_len)``: that, and the
      layer's LayerCache of ``max_len`` positions;
    - ``decode(p, h, c, cfg, i)``: that for one token against the
      LayerCache ``c``, and ``c`` stepped once;
    - ``state(cfg, i, batch, max_len, device)``: an empty LayerCache."""
    init: Callable[..., dict]
    axes: Callable[..., dict]
    run: Callable[..., torch.Tensor]
    prefill: Callable[..., Tuple[torch.Tensor, LayerCache]]
    decode: Callable[..., Tuple[torch.Tensor, LayerCache]]
    state: Callable[..., LayerCache]


MIXERS: Dict[str, Mixer] = {
    "attention": Mixer(
        init=lambda gen, cfg: {"attn": attn_lib.init_attention(gen, cfg)},
        axes=lambda cfg: {"attn": attn_lib.attention_logical_axes(cfg)},
        run=_attention, prefill=_attention_prefill,
        decode=_attention_decode, state=_attention_state),
    "hybrid": Mixer(
        init=_hybrid_init,
        axes=lambda cfg: {"attn": attn_lib.attention_logical_axes(cfg),
                          "ssm": ssm_lib.ssm_logical_axes(cfg),
                          "norm_a": _norm_axes(cfg),
                          "norm_s": _norm_axes(cfg)},
        run=_hybrid, prefill=_hybrid_prefill, decode=_hybrid_decode,
        state=lambda cfg, i, b, n, dev: LayerCache(
            "hybrid", kv=_attention_state(cfg, i, b, n, dev).kv,
            ssm=ssm_lib.init_ssm_state(cfg, b, device=dev))),
    "mamba": Mixer(
        init=lambda gen, cfg: {"mamba": ssm_lib.init_mamba(gen, cfg)},
        axes=lambda cfg: {"mamba": ssm_lib.mamba_logical_axes(cfg)},
        run=_mamba, prefill=_mamba_prefill, decode=_mamba_decode,
        state=lambda cfg, i, b, n, dev: LayerCache(
            "mamba", ssm=ssm_lib.init_ssm_state(cfg, b, device=dev))),
}


def _moe(p: ParamsLike, h: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    y, stats = moe_lib.moe_ffn(p["moe"], h, cfg)
    return y, stats.aux_loss


class Ffn(NamedTuple):
    """How a feed-forward kind is built and run; its group in the block
    is named by the kind: ``init(gen, cfg)``, ``axes(cfg)``, and ``apply(p,
    h, cfg)``, (y, the MoE's aux loss or None)."""
    init: Callable[..., Params]
    axes: Callable[..., dict]
    apply: Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]


FFNS: Dict[str, Ffn] = {
    "mlp": Ffn(init=init_mlp, axes=mlp_logical_axes,
               apply=lambda p, h, cfg: (apply_mlp(p["mlp"], h, cfg), None)),
    "moe": Ffn(init=moe_lib.init_moe, axes=moe_lib.moe_logical_axes,
               apply=_moe),
}


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

class Block(Params):
    """One decoder layer: ``norm1``, its mixer's groups (``attn``; ``attn``,
    ``ssm``, ``norm_a`` and ``norm_s``; or ``mamba``), ``norm2``, and its
    feed-forward, ``mlp`` or ``moe``, as :meth:`ModelConfig.layer_kind`
    says."""


def init_block(gen: torch.Generator, cfg: ModelConfig, i: int) -> Block:
    """Layer ``i``'s parameters."""
    mixer, ffn = cfg.layer_kind(i)
    return Block(norm1=init_norm(cfg, device=gen.device),
                 norm2=init_norm(cfg, device=gen.device),
                 **MIXERS[mixer].init(gen, cfg),
                 **{ffn: FFNS[ffn].init(gen, cfg)})


def block_logical_axes(cfg: ModelConfig, i: int = 0) -> dict:
    mixer, ffn = cfg.layer_kind(i)
    return {"norm1": _norm_axes(cfg), "norm2": _norm_axes(cfg),
            **MIXERS[mixer].axes(cfg), ffn: FFNS[ffn].axes(cfg)}


def apply_block(p: ParamsLike, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, i: int, return_kv: bool = False):
    """Layer ``i`` over a whole sequence, from zero states: ``x +
    mixer(norm1(x))``, then ``+ ffn(norm2(x))``.  Returns (x', aux[, (kt,
    vt)]); aux is 0 without an MoE.  ``return_kv`` takes an attention
    layer."""
    mixer, ffn = cfg.layer_kind(i)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg, p["norm1"], x)
    if return_kv:
        a, kv = _attention(p, h, positions, cfg, i, return_kv=True)
    else:
        a = MIXERS[mixer].run(p, h, positions, cfg, i)
    del h
    x = x + a
    del a
    y, moe_aux = FFNS[ffn].apply(p, apply_norm(cfg, p["norm2"], x), cfg)
    if moe_aux is not None:
        aux = aux + moe_aux
    x = x + y
    if return_kv:
        return x, aux, kv
    return x, aux


def prefill_block(p: ParamsLike, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, i: int, max_len: int
                  ) -> Tuple[torch.Tensor, LayerCache]:
    """Layer ``i`` over the prompt from zero states, keeping its decode
    state: (x', its LayerCache of ``max_len`` positions).  A prefill takes
    no gradient and drops its x for x', so both residual adds write into
    ``x``: the layer holds one residual stream, not two."""
    mixer, ffn = cfg.layer_kind(i)
    h = apply_norm(cfg, p["norm1"], x)
    a, cache = MIXERS[mixer].prefill(p, h, positions, cfg, i, max_len)
    del h
    x.add_(a)
    del a
    y, _ = FFNS[ffn].apply(p, apply_norm(cfg, p["norm2"], x), cfg)
    return x.add_(y), cache


def decode_block(p: ParamsLike, x: torch.Tensor, c: LayerCache,
                 cfg: ModelConfig, i: int
                 ) -> Tuple[torch.Tensor, LayerCache]:
    """One token x [B, 1, d] through layer ``i``, stepping its state
    ``c`` once: (x', the layer's LayerCache')."""
    mixer, ffn = cfg.layer_kind(i)
    h = apply_norm(cfg, p["norm1"], x)
    a, c = MIXERS[mixer].decode(p, h, c, cfg, i)
    x = x + a
    h = apply_norm(cfg, p["norm2"], x)
    return x + FFNS[ffn].apply(p, h, cfg)[0], c


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
    p = dict(embed=init_embedding(gen, cfg),
             final_norm=init_norm(cfg, device=gen.device))
    if cfg.family == "ssm":
        p["xlstm"] = init_xlstm_stack(gen, cfg)
    else:
        p["blocks"] = nn.ModuleList(init_block(gen, cfg, i)
                                    for i in range(cfg.num_layers))
    if cfg.num_patches:
        p["patch_proj"] = trunc_normal(gen, (cfg.d_model, cfg.d_model),
                                       cfg.param_dtype)
    return LM(**p)


def lm_logical_axes(cfg: ModelConfig) -> dict:
    """The reference's logical axes of the model's parameters, a nested
    dict by its pytree paths: a stacked ``[L, ...]`` leaf leads with
    ``"layers"`` (two for xlstm's ``[units, m_per, ...]`` mLSTM blocks),
    which the port's per-layer tensors drop
    (``checkpoint/elastic.shardings_for_params``).  Layers of several
    kinds have one tree a layer, not a stacked leaf."""
    p: dict = {"embed": embedding_logical_axes(cfg),
               "final_norm": _norm_axes(cfg)}
    if cfg.family == "ssm":
        p["xlstm"] = xlstm_stack_logical_axes(cfg)
    elif len({cfg.layer_kind(i) for i in range(cfg.num_layers)}) > 1:
        p["blocks"] = {str(i): block_logical_axes(cfg, i)
                       for i in range(cfg.num_layers)}
    else:
        p["blocks"] = lift_axes(block_logical_axes(cfg), ("layers",))
    if cfg.num_patches:
        p["patch_proj"] = ("embed", None)
    return p


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
    if return_kv and not _stacked_kv(cfg):
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
    for i, bp in enumerate(params["blocks"]):
        out = remat(cfg, functools.partial(
            apply_block, bp, cfg=cfg, i=i, return_kv=return_kv),
            x, positions)
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

    def layers(self) -> List[LayerCache]:
        """Each layer's cache: a view of its slice, ``k[i]`` and
        ``v[i]``."""
        return [LayerCache("attention",
                           kv=KVCache(k=self.k[i], v=self.v[i], pos=self.pos))
                for i in range(self.k.shape[0])]


def init_stacked_cache(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=None, device=None) -> StackedKV:
    dt = dtype or cfg.param_dtype
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.hd)
    return StackedKV(k=torch.zeros(shape, dtype=dt, device=device),
                     v=torch.zeros(shape, dtype=dt, device=device), pos=0)


def prefill_scanned(params: ParamsLike, tokens: torch.Tensor,
                    cfg: ModelConfig, max_len: int,
                    patch_embeds: Optional[torch.Tensor] = None):
    """Prefill for uniform stacks (dense, MoE, vlm), the reference's: the
    forward pass, logits [B, S, V], and a StackedKV of ``max_len``
    positions holding the prompt's K/V (S = P + S_text with
    ``patch_embeds``; decode goes on from S)."""
    logits, _, (kt, vt) = forward(params, tokens, cfg,
                                  patch_embeds=patch_embeds, return_kv=True)
    L, b, _, s, _ = kt.shape
    cache = init_stacked_cache(cfg, b, max_len, dtype=kt.dtype,
                               device=kt.device)
    cache.k[:, :, :, :s] = kt
    cache.v[:, :, :, :s] = vt
    cache.pos = s
    return logits, cache


Caches = Union[StackedKV, List[LayerCache]]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Caches:
    """A StackedKV for uniform stacks; else one LayerCache a layer, its
    mixer's state (a sliding-window layer's KV cache is a ring buffer,
    O(window); an SSM's state O(1)); for ssm, one LayerCache per xlstm
    block with its O(1) state."""
    if cfg.family == "ssm":
        return [LayerCache("mlstm",
                           mls=xlstm_lib.init_mlstm_state(cfg, batch, device))
                if kind == "mlstm" else
                LayerCache("slstm",
                           sls=xlstm_lib.init_slstm_state(cfg, batch, device))
                for kind in _xlstm_kinds(cfg)]
    if _stacked_kv(cfg):
        return init_stacked_cache(cfg, batch, max_len, device=device)
    return [MIXERS[cfg.layer_kind(i)[0]].state(cfg, i, batch, max_len,
                                                device)
            for i in range(cfg.num_layers)]


def decode_step(params: ParamsLike, caches: Caches, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Caches]:
    """tokens: [B] -> (logits [B, V], caches').

    Each layer steps its state once (:func:`decode_block`); a StackedKV's
    layers write into their slices of it."""
    METRICS.counter("lm.tokens_decoded").inc(tokens.shape[0])
    with span("lm.decode_step", batch=tokens.shape[0]):
        return _decode_step(params, caches, tokens, cfg)


def _decode_step(params: ParamsLike, caches: Caches, tokens: torch.Tensor,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Caches]:
    x = embed_tokens(params["embed"], tokens[:, None], cfg)
    new_caches: List[LayerCache] = []
    if cfg.family == "ssm":
        x = _xlstm_decode(params["xlstm"], x, cfg, caches, new_caches)
    else:
        layers = caches.layers() if isinstance(caches, StackedKV) else caches
        for i, (bp, c) in enumerate(zip(params["blocks"], layers)):
            x, c = decode_block(bp, x, c, cfg, i)
            new_caches.append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], x, cfg)[:, 0]
    if isinstance(caches, StackedKV):
        return logits, StackedKV(k=caches.k, v=caches.v, pos=caches.pos + 1)
    return logits, new_caches


def prefill(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: Optional[int] = None,
            patch_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Caches]:
    """Run the full prompt, returning (logits [B, S, V], filled caches);
    with ``patch_embeds`` ``max_len`` must count the patch positions too.
    Where ``cfg.logits_to_keep`` is k > 0 (the jamba family), the logits
    of the last k positions alone, [B, k, V]."""
    METRICS.counter("lm.tokens_prefilled").inc(tokens.numel())
    with span("lm.prefill", batch=tokens.shape[0], tokens=tokens.shape[1]):
        return _prefill(params, tokens, cfg, max_len, patch_embeds)


def _prefill(params: ParamsLike, tokens: torch.Tensor, cfg: ModelConfig,
             max_len: Optional[int],
             patch_embeds: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, Caches]:
    max_len = max_len or tokens.shape[1]
    if cfg.family == "ssm":
        return prefill_ssm(params, tokens, cfg)
    if _stacked_kv(cfg):
        return prefill_scanned(params, tokens, cfg, max_len,
                               patch_embeds=patch_embeds)
    x = embed_inputs(params, tokens, cfg, patch_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    caches: List[LayerCache] = []
    for i, bp in enumerate(params["blocks"]):
        x, cache = prefill_block(bp, x, positions, cfg, i, max_len)
        caches.append(cache)
    if cfg.logits_to_keep:
        x = x[:, -cfg.logits_to_keep:]
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x, cfg), caches
