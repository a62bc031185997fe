"""AdamW with f32 moments (the reference's ``optim/adamw.py``)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.base import Optimizer, named_tree


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        named = named_tree(params)
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in named.items()}
        return AdamWState(m=zeros,
                          v={k: torch.zeros_like(z) for k, z in zeros.items()},
                          count=torch.zeros((), dtype=torch.int32))

    def update(grads, state, params, lr):
        named = named_tree(params)
        c = state.count + 1
        cf = c.to(torch.float32)
        c1 = 1 - b1 ** cf
        c2 = 1 - b2 ** cf
        ups, ms, vs = {}, {}, {}
        with torch.no_grad():
            for k, g in grads.items():
                gf = g.to(torch.float32)
                m2 = b1 * state.m[k] + (1 - b1) * gf
                v2 = b2 * state.v[k] + (1 - b2) * gf * gf
                step = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
                step = step + weight_decay * named[k].to(torch.float32)
                ups[k], ms[k], vs[k] = -lr * step, m2, v2
        return ups, AdamWState(m=ms, v=vs, count=c)

    return Optimizer(init=init, update=update)
