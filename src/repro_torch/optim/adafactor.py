"""Adafactor (Shazeer & Stern, 2018) — factored second moments (the
reference's ``optim/adafactor.py``): second-moment state is O(rows +
cols) instead of O(rows * cols), and the first moment is optional."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.optim.base import Optimizer, named_tree


class AdafactorState(NamedTuple):
    v_row: Any          # factored stats ([..., r] rows) or full v for 1-D
    v_col: Any
    m: Any              # momentum ((1,) zeros if disabled)
    count: torch.Tensor


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(decay: float = 0.8, eps1: float = 1e-30, eps2: float = 1e-3,
              clip_threshold: float = 1.0, momentum: Optional[float] = None,
              weight_decay: float = 0.0) -> Optimizer:
    f32 = torch.float32

    def init(params):
        named = named_tree(params)

        def zeros(shape, p):
            return torch.zeros(shape, dtype=f32, device=p.device)

        v_row = {k: zeros(p.shape[:-1] if _factored(p.shape) else p.shape, p)
                 for k, p in named.items()}
        v_col = {k: zeros(p.shape[:-2] + p.shape[-1:]
                          if _factored(p.shape) else (1,), p)
                 for k, p in named.items()}
        m = {k: zeros(p.shape if momentum else (1,), p)
             for k, p in named.items()}
        return AdafactorState(v_row=v_row, v_col=v_col, m=m,
                              count=torch.zeros((), dtype=torch.int32))

    def update(grads, state, params, lr):
        named = named_tree(params)
        c = state.count + 1
        beta2 = 1.0 - c.to(f32) ** (-decay)
        ups, vrs, vcs, ms = {}, {}, {}, {}
        with torch.no_grad():
            for k, g in grads.items():
                vr, vc, m = state.v_row[k], state.v_col[k], state.m[k]
                gf = g.to(f32)
                g2 = gf * gf + eps1
                if _factored(g.shape):
                    vr2 = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
                    vc2 = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
                    r = vr2 / torch.clamp(
                        torch.mean(vr2, dim=-1, keepdim=True), min=eps1)
                    u = gf / (torch.sqrt(r)[..., None]
                              * torch.sqrt(vc2)[..., None, :] + eps1)
                else:
                    vr2 = beta2 * vr + (1 - beta2) * g2
                    vc2 = vc
                    u = gf / (torch.sqrt(vr2) + eps1)
                rms_u = torch.sqrt(torch.mean(u * u) + eps1)
                u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
                if momentum:
                    m = momentum * m + (1 - momentum) * u
                    u = m
                u = u + weight_decay * named[k].to(f32)
                ups[k], vrs[k], vcs[k], ms[k] = -lr * u, vr2, vc2, m
        return ups, AdafactorState(v_row=vrs, v_col=vcs, m=ms, count=c)

    return Optimizer(init=init, update=update)
