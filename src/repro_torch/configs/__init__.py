"""Config registry: the 10 assigned architectures x 4 shape cells."""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.shapes import (DECODE_32K, LONG_500K,
                                        PREFILL_32K, SHAPES, TRAIN_4K,
                                        ShapeConfig, get_shape)
from repro_torch.models.common import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "deepseek-67b": "deepseek_67b",
    "smollm-135m": "smollm_135m",
    "llama3.2-1b": "llama3_2_1b",
    "whisper-base": "whisper_base",
    "hymba-1.5b": "hymba_1_5b",
    "internvl2-1b": "internvl2_1b",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)

#: Configurations the port serves beside the ten assigned ones: not in
#: ``ARCH_IDS`` (the assigned cells, each held to the reference), but
#: found by :func:`get_config` and :func:`get_smoke_config`.
_EXTRA_MODULES: Dict[str, str] = {
    "jamba2-mini": "jamba2_mini",
}
EXTRA_ARCH_IDS: Tuple[str, ...] = tuple(_EXTRA_MODULES)


def _module(arch: str):
    mods = {**_ARCH_MODULES, **_EXTRA_MODULES}
    if arch not in mods:
        raise KeyError(f"unknown arch {arch!r}; have "
                       f"{list(ARCH_IDS) + list(EXTRA_ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mods[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Optional[str]:
    """Assignment skip rules; None = the cell runs."""
    if shape.kind == "long_decode" and not cfg.is_subquadratic:
        return ("pure full-attention stack: 524k dense-KV decode is "
                "outside the assigned regime (DESIGN.md §5)")
    return None


def cells(include_skipped: bool = False
          ) -> List[Tuple[str, str, Optional[str]]]:
    """All (arch, shape, skip_reason) cells."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            reason = shape_skip_reason(cfg, shape)
            if reason is None or include_skipped:
                out.append((arch, shape.name, reason))
    return out


__all__ = ["ARCH_IDS", "EXTRA_ARCH_IDS", "get_config", "get_smoke_config",
           "get_shape", "cells", "shape_skip_reason", "SHAPES", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K", "ShapeConfig"]
