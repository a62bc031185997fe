"""Mixture-of-Experts FFN, one card (the reference's ``models/moe.py``).

The reference's dense path, ``moe_ffn_dense``, sorts the token copies by
expert with ``argsort(stable=True)`` and sizes the groups with
``bincount``.  The port gets both from the dispatch kernel
(``kernels/moe_dispatch``): each copy's stable slot within its expert
plus the experts' sizes.  The slot offset by the exclusive prefix of the
sizes is the sort's inverse permutation, so ``xs[slot] = flat_x`` lays
the copies out exactly as ``take(flat_x, order)`` does.

The reference's expert-parallel path (``moe_ffn_sharded``: a
repartitionBy of the copies over the ``model`` mesh axis, with
``grouped_all_to_all``) needs several cards; it waits for the port's
multi-card backend (ROADMAP Queue 1 item 17).  On one card the reference
takes the dense path too, whatever ``mode`` says.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch.ops import moe_dispatch
from repro_torch.models.common import ModelConfig, Params, trunc_normal
from repro_torch.models.layers import ParamsLike


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = cfg.param_dtype
    return Params(router=trunc_normal(gen, (d, E), torch.float32),
                  w1=trunc_normal(gen, (E, d, f), dt),
                  w3=trunc_normal(gen, (E, d, f), dt),
                  w2=trunc_normal(gen, (E, f, d), dt))


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor       # load-balancing loss (f32 scalar)
    dropped: torch.Tensor        # tokens dropped to capacity (f32 scalar)


def _route(p: ParamsLike, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d: [T, d] -> (top-k idx [T, k], gates [T, k], aux_loss).

    The top k come from a stable descending sort of each row, so ties go
    to the lower expert as in ``lax.top_k`` (``torch.topk`` does not
    promise that on CUDA)."""
    logits = x2d.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[:, :k], top.indices[:, :k]
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    E = cfg.num_experts
    f_e = torch.mean(F.one_hot(idx[:, 0], E).float(), dim=0)
    p_e = torch.mean(probs, dim=0)
    aux = E * torch.sum(f_e * p_e)
    return idx, gates.to(x2d.dtype), aux


def _expert_mlp(w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                xs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over rows sorted by expert (the reference's
    ``ragged_dot``): one matmul per non-empty expert on its contiguous
    rows; rows past the groups' total are 0.

    The slice bounds come to the host: one device-to-host copy of
    ``group_sizes`` (a stream sync) per call, i.e. per layer."""
    ys = torch.empty_like(xs)
    off = 0
    for e, c in enumerate(group_sizes.tolist()):
        if c:
            x = xs[off:off + c]
            h = F.silu(x @ w1[e]) * (x @ w3[e])
            ys[off:off + c] = h @ w2[e]
        off += c
    ys[off:] = 0
    return ys


def moe_ffn_dense(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, MoEStats]:
    """x: [B, S, d] -> (y [B, S, d], stats); no token is dropped."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    t = x2.shape[0]
    idx, gates, aux = _route(p, x2, cfg)
    k, E = cfg.experts_per_token, cfg.num_experts
    flat_e = idx.reshape(-1)                                 # [T*k]
    positions, counts = moe_dispatch(flat_e, E)              # the kernel
    offsets = torch.cumsum(counts, dim=0) - counts           # exclusive
    slot = (offsets[flat_e] + positions).long()              # [T*k]
    flat_x = torch.repeat_interleave(x2, k, dim=0)           # [T*k, d]
    xs = torch.empty_like(flat_x)
    xs[slot] = flat_x                        # the reference's take(order)
    ys = _expert_mlp(p["w1"], p["w3"], p["w2"], xs, counts)
    y_flat = ys[slot]
    y = torch.sum(y_flat.reshape(t, k, d) * gates[..., None], dim=1)
    return y.reshape(b, s, d), MoEStats(
        aux_loss=aux, dropped=torch.zeros((), dtype=torch.float32,
                                          device=x.device))


def moe_ffn(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig,
            mode: Optional[str] = None) -> Tuple[torch.Tensor, MoEStats]:
    """The MoE FFN.  ``mode`` picks the reference's expert-parallel
    layout, which only a mesh of several cards has; on one card every
    mode is the dense path, as in the reference."""
    return moe_ffn_dense(p, x, cfg)
