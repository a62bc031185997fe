"""Unified model API: the reference's ``models/__init__.py`` on PyTorch.

``build_model(cfg, device=)`` returns a :class:`Model` namespace with
init / loss / forward / prefill / decode_step / init_cache /
logical_axes, the surface the trainer, the server and the tests use
(``logical_axes()`` is the reference's tree of logical axis names, for
``checkpoint.rescale``); a family the port does not run raises here.
The dense, MoE, hybrid, vlm, jamba and ssm (xlstm) families are
``models/transformer.py``, the audio family ``models/encdec.py``.  A
batch holds ``tokens``
(and ``labels`` for the loss), and
``patch_embeds`` (vlm) or ``frames`` (audio) beside them.  Parameters
live on ``device`` (``cuda`` unless the caller passes another; without a
GPU, ``cuda`` raises).  On ``meta`` every family builds its parameters
without drawing or allocating anything (``common.MetaDraws``), and its
kernels take their meta routes: the dry run counts a step's work there
(``launch/dryrun_lib.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.core.dataset import DeviceLike, resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.common import (MetaDraws, ModelConfig, Params,
                                       active_param_count, param_count,
                                       param_count_analytic)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]              # init(seed or Generator) -> LM
    #                                       (EncDec for audio)
    loss: Callable[..., Any]              # loss(params, batch) -> (l, m)
    forward: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Optional[Callable[..., Any]]   # None for audio
    logical_axes: Callable[[], Any]       # the reference's axes tree


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    transformer.require_ported_family(cfg)
    dev = resolve_device(device)

    def generator(seed: Union[int, torch.Generator]
                  ) -> Union[torch.Generator, MetaDraws]:
        if isinstance(seed, torch.Generator):
            return seed
        if dev.type == "meta":
            return MetaDraws()
        return torch.Generator(device=dev).manual_seed(int(seed))

    if cfg.family == "audio":
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed=0: encdec.init_encdec(generator(seed), cfg),
            loss=lambda p, b: encdec.encdec_loss(p, b, cfg),
            forward=lambda p, b: encdec.forward(p, b, cfg),
            prefill=lambda p, b, max_len: encdec.prefill(
                p, b["frames"], b["tokens"], cfg, max_len),
            decode_step=lambda p, caches, tok: encdec.decode_step(
                p, caches, tok, cfg),
            init_cache=None,
            logical_axes=lambda: encdec.encdec_logical_axes(cfg))

    def fwd(p, b):
        logits, _ = transformer.forward(
            p, b["tokens"], cfg, patch_embeds=b.get("patch_embeds"))
        return logits

    return Model(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: transformer.init_lm(generator(seed), cfg),
        loss=lambda p, b: transformer.lm_loss(p, b, cfg),
        forward=fwd,
        prefill=lambda p, b, max_len: transformer.prefill(
            p, b["tokens"], cfg, max_len=max_len,
            patch_embeds=b.get("patch_embeds")),
        decode_step=lambda p, caches, tok: transformer.decode_step(
            p, caches, tok, cfg),
        init_cache=lambda batch, max_len: transformer.init_cache(
            cfg, batch, max_len, device=dev),
        logical_axes=lambda: transformer.lm_logical_axes(cfg))


__all__ = ["Model", "ModelConfig", "Params", "build_model", "param_count",
           "param_count_analytic", "active_param_count"]
