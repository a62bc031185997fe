"""Weights carried across from the reference.

:func:`params_from_numpy` takes the reference's parameter pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``, layer parameters stacked
``[L, ...]`` under ``"blocks"``) and returns the port's model holding the
same weights, one :class:`~repro_torch.models.transformer.Block` per
layer.  Both packages then compute with identical weights, which is how
the tests hold the port to the reference.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.dataset import DeviceLike, resolve_device
from repro_torch.models.common import ModelConfig, Params
from repro_torch.models.transformer import (LM, Block,
                                            require_ported_family)


#: Leaves the reference keeps in float32 whatever the model's dtype
#: (``init_moe``'s router; ``init_ssm``'s dt_bias, a_log and d_skip).
FLOAT32_LEAVES = ("router", "dt_bias", "a_log", "d_skip")


def _tree(node: Mapping[str, Any], device: torch.device, dtype,
          cls=Params) -> Params:
    kids = {}
    for name, val in node.items():
        if isinstance(val, Mapping):
            kids[name] = _tree(val, device, dtype)
        else:
            # via float32: exact for f32 and bf16 leaves, and numpy has
            # no bf16 of its own
            kids[name] = torch.from_numpy(
                np.array(val, dtype=np.float32)).to(
                    device=device,
                    dtype=torch.float32 if name in FLOAT32_LEAVES else dtype)
    return cls(**kids)


def _layer(node: Mapping[str, Any], i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in node.items()}


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> LM:
    """The reference's params (numpy leaves) -> the port's :class:`LM`
    on ``device``, in ``cfg.param_dtype`` (:data:`FLOAT32_LEAVES` in
    float32)."""
    require_ported_family(cfg)
    dev = resolve_device(device)
    dt = cfg.param_dtype
    blocks = tree["blocks"]
    n = {np.asarray(leaf).shape[0] for leaf in _leaves(blocks)}
    if n != {cfg.num_layers}:
        raise ValueError(f"stacked block params have leading dims {n}, "
                         f"config has {cfg.num_layers} layers")
    return LM(embed=_tree(tree["embed"], dev, dt),
              final_norm=_tree(tree["final_norm"], dev, dt),
              blocks=nn.ModuleList(
                  _tree(_layer(blocks, i), dev, dt, cls=Block)
                  for i in range(cfg.num_layers)))


def _leaves(node):
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
