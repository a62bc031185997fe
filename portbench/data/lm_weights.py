"""Seeded weights of a Jamba stack, one layer at a time, made where they
are used.

Every tensor of layer ``i`` comes from a ``torch.Generator`` on the
device seeded from (``seed``, ``i``), drawn in a fixed order, so the
benchmark can load the port from it and the reference can make the same
layer again after the window, one layer at a time.  Names and shapes are
the port's (``norm1.scale``, ``attn.wq`` [d, heads, head_dim],
``mamba.in_proj`` [d, 2 di], ``moe.w1`` [experts, d, width], ...: every
matrix ``[in, out]``); the embedding, head and final norm are
``outer_weights``.

Every weight is drawn so that each part of the model moves the logits,
which the comparison then checks: each matrix ``[in, out]`` from
N(0, 1 / in) truncated at two standard deviations (so a projection keeps
its input's scale; the depthwise conv's ``in`` is its 4 taps, an
expert's its own rows), the embedding from N(0, 1), the conv bias
uniform in +-0.5 (``nn.Conv1d``'s own initialisation, which the published
Mamba code keeps) and every norm's weight uniform in [0.9, 1.1];
``A_log`` = log(1 .. d_state) and ``D`` = 1 as Mamba's; ``dt_proj``'s
bias softplus's inverse of a dt drawn log-uniform in [0.001, 0.1]
(Mamba's initialisation).  The router and the three vectors ``dt_bias``,
``a_log``, ``d_skip`` are float32, as the port holds them; everything
else the configuration's type (bfloat16).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

#: Elements drawn at once in float32 before the cast (bounds the
#: draw's scratch to 256 MB).
SLAB = 1 << 26


def layer_kinds(cfg: dict) -> List[Tuple[str, str]]:
    """Each layer's (``"attention"`` or ``"mamba"``, ``"mlp"`` or
    ``"moe"``), from the period and offset keys."""
    return [("attention" if i % cfg["attn_layer_period"]
             == cfg["attn_layer_offset"] else "mamba",
             "moe" if i % cfg["expert_layer_period"]
             == cfg["expert_layer_offset"] else "mlp")
            for i in range(cfg["num_hidden_layers"])]


def generator(seed: int, part: int, device) -> torch.Generator:
    """The generator of ``part`` (a layer's index; -1 the outer weights,
    -2 the prompts) under ``seed``."""
    state = np.random.SeedSequence([int(seed), part + 2]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def _normal(g, shape, fan_in: float, dtype, device) -> torch.Tensor:
    """N(0, 1 / fan_in) truncated at two standard deviations, drawn in
    float32 slabs along the first dimension, cast to ``dtype``."""
    std = fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(shape[0], -1)
    rows = max(1, SLAB // max(1, flat.shape[1]))
    for r0 in range(0, flat.shape[0], rows):
        part = torch.empty(flat[r0:r0 + rows].shape, dtype=torch.float32,
                           device=device)
        torch.nn.init.trunc_normal_(part, 0.0, std, -2 * std, 2 * std,
                                    generator=g)
        flat[r0:r0 + rows] = part
    return out


def _uniform(g, size: int, lo: float, hi: float, dtype, device
             ) -> torch.Tensor:
    u = torch.rand((size,), generator=g, device=device)
    return (lo + (hi - lo) * u).to(dtype)


def layer_weights(cfg: dict, seed: int, i: int, device,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s tensors by the port's names."""
    g = generator(seed, i, device)
    d, heads, kv = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"])
    hd = d // heads
    mixer, ffn = layer_kinds(cfg)[i]
    w = {"norm1.scale": _uniform(g, d, 0.9, 1.1, dtype, device),
         "norm2.scale": _uniform(g, d, 0.9, 1.1, dtype, device)}
    if mixer == "attention":
        w["attn.wq"] = _normal(g, (d, heads, hd), d, dtype, device)
        w["attn.wk"] = _normal(g, (d, kv, hd), d, dtype, device)
        w["attn.wv"] = _normal(g, (d, kv, hd), d, dtype, device)
        w["attn.wo"] = _normal(g, (heads, hd, d), heads * hd, dtype, device)
    else:
        n, r, k = cfg["mamba_d_state"], cfg["mamba_dt_rank"], \
            cfg["mamba_d_conv"]
        di = d * cfg["mamba_expand"]
        w["mamba.in_proj"] = _normal(g, (d, 2 * di), d, dtype, device)
        w["mamba.conv_w"] = _normal(g, (k, di), k, dtype, device)
        if cfg["mamba_conv_bias"]:
            w["mamba.conv_b"] = _uniform(g, di, -k ** -0.5, k ** -0.5,
                                         dtype, device)
        w["mamba.x_proj"] = _normal(g, (di, r + 2 * n), di, dtype, device)
        for name, size in (("dt_norm", r), ("b_norm", n), ("c_norm", n)):
            w[f"mamba.{name}.scale"] = _uniform(g, size, 0.9, 1.1, dtype,
                                                device)
        w["mamba.dt_proj"] = _normal(g, (r, di), r, dtype, device)
        step = torch.exp(_uniform(g, di, math.log(0.001), math.log(0.1),
                                  torch.float32, device)).clamp(min=1e-4)
        w["mamba.dt_bias"] = step + torch.log(-torch.expm1(-step))
        w["mamba.a_log"] = torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=device)).repeat(di, 1)
        w["mamba.d_skip"] = torch.ones((di,), dtype=torch.float32,
                                       device=device)
        w["mamba.out_proj"] = _normal(g, (di, d), di, dtype, device)
    f = cfg["intermediate_size"]
    if ffn == "moe":
        e = cfg["num_experts"]
        w["moe.router"] = _normal(g, (d, e), d, torch.float32, device)
        w["moe.w1"] = _normal(g, (e, d, f), d, dtype, device)
        w["moe.w3"] = _normal(g, (e, d, f), d, dtype, device)
        w["moe.w2"] = _normal(g, (e, f, d), f, dtype, device)
    else:
        w["mlp.w1"] = _normal(g, (d, f), d, dtype, device)
        w["mlp.w3"] = _normal(g, (d, f), d, dtype, device)
        w["mlp.w2"] = _normal(g, (f, d), f, dtype, device)
    return w


def outer_weights(cfg: dict, seed: int, device,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The embedding [V, d], the untied head [d, V] and the final norm."""
    g = generator(seed, -1, device)
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return {"embed.table": _normal(g, (v, d), 1, dtype, device),
            "embed.unembed": _normal(g, (d, v), d, dtype, device),
            "final_norm.scale": _uniform(g, d, 0.9, 1.1, dtype, device)}
