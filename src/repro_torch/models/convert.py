"""Weights carried across from the reference.

:func:`params_from_numpy` takes the reference's parameter pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``, layer parameters stacked
``[L, ...]`` under ``"blocks"``, under ``"enc_layers"`` and
``"dec_layers"`` for the audio family, or under ``"xlstm"`` as
``m_blocks`` ``[units, m_per, ...]`` and ``s_blocks`` ``[units, ...]`` for
the ssm family) and returns the port's model holding the same weights,
one module per layer.  Both packages then
compute with identical weights, which is how the tests hold the port to
the reference.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.dataset import DeviceLike, resolve_device
from repro_torch.models.common import ModelConfig, Params
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import (LM, Block, _xlstm_unit_shape,
                                            require_ported_family)


#: Leaves the reference keeps in float32 whatever the model's dtype
#: (``init_moe``'s router; ``init_ssm``'s dt_bias, a_log and d_skip; the
#: xlstm blocks' f_bias).
FLOAT32_LEAVES = ("router", "dt_bias", "a_log", "d_skip", "f_bias")
#: ... and an mLSTM core's input and forget gate projections (an sLSTM
#: core's leaves of the same names follow the model's dtype).
MLSTM_FLOAT32_LEAVES = ("wi", "wf", "f_bias")


def _leaf(name: str, val: Any, device: torch.device, dtype,
          f32=FLOAT32_LEAVES) -> torch.Tensor:
    # via float32: exact for f32 and bf16 leaves, and numpy has no bf16 of
    # its own
    return torch.from_numpy(np.array(val, dtype=np.float32)).to(
        device=device, dtype=torch.float32 if name in f32 else dtype)


def _tree(node: Mapping[str, Any], device: torch.device, dtype,
          cls=Params, f32=FLOAT32_LEAVES) -> Params:
    return cls(**{name: (_tree(val, device, dtype, f32=f32)
                         if isinstance(val, Mapping)
                         else _leaf(name, val, device, dtype, f32))
                  for name, val in node.items()})


def _layer(node: Mapping[str, Any], i) -> dict:
    return {k: (_layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in node.items()}


def _xlstm_block(node: Mapping[str, Any], i, device, dtype,
                 mlstm: bool) -> Params:
    blk = _layer(node, i)
    return Params(norm=_tree(blk["norm"], device, dtype),
                  core=_tree(blk["core"], device, dtype,
                             f32=MLSTM_FLOAT32_LEAVES if mlstm
                             else FLOAT32_LEAVES))


def _xlstm(tree: Mapping[str, Any], cfg: ModelConfig, device,
           dtype) -> Params:
    """The reference's ``xlstm`` subtree -> the port's stack: a unit's
    mLSTM blocks ``[units, m_per, ...]`` and its sLSTM block ``[units,
    ...]``, or ``num_layers`` mLSTM blocks ``[L, ...]`` without sLSTM."""
    m_per, units = _xlstm_unit_shape(cfg)
    m = tree["m_blocks"]
    if units == 0:
        return Params(m_blocks=nn.ModuleList(
            _xlstm_block(m, i, device, dtype, True)
            for i in range(cfg.num_layers)))
    return Params(
        m_blocks=nn.ModuleList(
            nn.ModuleList(_xlstm_block(m, (u, i), device, dtype, True)
                          for i in range(m_per)) for u in range(units)),
        s_blocks=nn.ModuleList(
            _xlstm_block(tree["s_blocks"], u, device, dtype, False)
            for u in range(units)))


def _stack(layers: Mapping[str, Any], n_layers: int, device, dtype,
           cls=Params) -> nn.ModuleList:
    """Layer parameters stacked [L, ...] -> one module per layer."""
    n = {np.asarray(leaf).shape[0] for leaf in _leaves(layers)}
    if n != {n_layers}:
        raise ValueError(f"stacked layer params have leading dims {n}, "
                         f"config has {n_layers} layers")
    return nn.ModuleList(_tree(_layer(layers, i), device, dtype, cls=cls)
                         for i in range(n_layers))


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Params:
    """The reference's params (numpy leaves) -> the port's :class:`LM`
    (:class:`~repro_torch.models.encdec.EncDec` for audio) on ``device``,
    in ``cfg.param_dtype`` (:data:`FLOAT32_LEAVES` in float32)."""
    require_ported_family(cfg)
    dev = resolve_device(device)
    dt = cfg.param_dtype
    if cfg.family == "audio":
        return EncDec(
            embed=_tree(tree["embed"], dev, dt),
            enc_layers=_stack(tree["enc_layers"], cfg.encoder_layers, dev,
                              dt),
            enc_ln=_tree(tree["enc_ln"], dev, dt),
            dec_layers=_stack(tree["dec_layers"], cfg.num_layers, dev, dt),
            dec_ln=_tree(tree["dec_ln"], dev, dt))
    p = dict(embed=_tree(tree["embed"], dev, dt),
             final_norm=_tree(tree["final_norm"], dev, dt))
    if cfg.family == "ssm":
        p["xlstm"] = _xlstm(tree["xlstm"], cfg, dev, dt)
    else:
        p["blocks"] = _stack(tree["blocks"], cfg.num_layers, dev, dt,
                             cls=Block)
    if "patch_proj" in tree:
        p["patch_proj"] = _leaf("patch_proj", tree["patch_proj"], dev, dt)
    return LM(**p)


def _leaves(node):
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
