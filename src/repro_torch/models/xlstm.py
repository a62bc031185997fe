"""xLSTM blocks: mLSTM (matrix memory, parallelizable) + sLSTM (scalar
memory, sequential) — arXiv:2405.04517; the reference's
``models/xlstm.py`` on PyTorch.

mLSTM recurrence per head (state C [hd, hd], n [hd], stabilizer m):
    f_t = sigmoid(f~_t)   i_t = exp(i~_t)        (exponential input gate)
    m_t = max(log f_t + m_{t-1}, log i_t)
    C_t = f'_t C_{t-1} + i'_t v_t k_t^T         (gates rescaled by m_t)
    n_t = f'_t n_{t-1} + i'_t k_t
    y_t = (C_t q_t) / max(|n_t . q_t|, 1)
A prefill evaluates it chunkwise: the stabilized parallel form within a
chunk and the small (C, n, m) carry across chunks, where the reference's
``lax.scan`` becomes a Python loop over chunks.  sLSTM heads keep the
true sequential recurrence over S (recurrent weights R_*), one step a
position.  Under a work counter that counts loops once, each loop runs
three of its bodies, counted for all (``launch/hlo_cost.like_bodies``).
Neither runs a kernel: the reference has none for them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import hlo_cost
from repro_torch.models.common import ModelConfig, Params, trunc_normal
from repro_torch.models.layers import ParamsLike


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    dt = cfg.param_dtype
    return Params(wq=trunc_normal(gen, (d, H, hd), dt),
                  wk=trunc_normal(gen, (d, H, hd), dt),
                  wv=trunc_normal(gen, (d, H, hd), dt),
                  wi=trunc_normal(gen, (d, H), torch.float32),
                  wf=trunc_normal(gen, (d, H), torch.float32),
                  f_bias=torch.full((H,), 3.0, dtype=torch.float32,
                                    device=gen.device),
                  wo=trunc_normal(gen, (H, hd, d), dt))


def mlstm_logical_axes(cfg: ModelConfig) -> dict:
    return {"wq": ("embed", "heads", "hd"), "wk": ("embed", "heads", "hd"),
            "wv": ("embed", "heads", "hd"), "wi": ("embed", "heads"),
            "wf": ("embed", "heads"), "f_bias": ("heads",),
            "wo": ("heads", "hd", "embed")}


class MLSTMState(NamedTuple):
    c: torch.Tensor    # [B, H, hd, hd] f32
    n: torch.Tensor    # [B, H, hd] f32
    m: torch.Tensor    # [B, H] f32 log-stabilizer


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device=None) -> MLSTMState:
    H = cfg.num_heads
    hd = cfg.d_model // H
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, H, hd), dtype=f32, device=device),
        m=torch.full((batch, H), -1e30, dtype=f32, device=device))


def _mlstm_chunk(q, k, v, logf, logi, state: MLSTMState):
    """Stabilized chunk-parallel mLSTM.

    q, k, v: [B, H, T, hd] f32; logf, logi: [B, H, T]; returns (y,
    state')."""
    t, hd = q.shape[2], q.shape[3]
    F_ = torch.cumsum(logf, dim=-1)                     # log prod f_(1..t)
    logas = F_                                          # state-in decay
    # pairwise decay D[t, s] = log prod f_(s+1..t) + log i_s,  s <= t
    D = F_[..., :, None] - F_[..., None, :] + logi[..., None, :]
    tri = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    D = torch.where(tri, D, float("-inf"))
    m_in = state.m[..., None] + logas                   # [B,H,T] carried
    m_local = torch.amax(D, dim=-1)                     # [B,H,T]
    m_t = torch.maximum(m_in, m_local)
    # intra-chunk contribution
    w = torch.exp(D - m_t[..., None])                   # [B,H,T,T]
    s_qk = torch.einsum("bhtd,bhsd->bhts", q, k) / (hd ** 0.5)
    y_intra = torch.einsum("bhts,bhsd->bhtd", w * s_qk, v)
    n_intra = torch.einsum("bhts,bhsd->bhtd", w, k)
    # inter-chunk (carried state, stored stabilized at state.m) rescale
    scale_in = torch.exp(state.m[..., None] + logas - m_t)  # [B,H,T]
    y_inter = torch.einsum("bhde,bhte->bhtd", state.c, q) / (hd ** 0.5)
    y_inter = y_inter * scale_in[..., None]
    n_inter = state.n[:, :, None, :] * scale_in[..., None]
    y_num = y_intra + y_inter
    n_tot = n_intra + n_inter
    denom = torch.maximum(
        torch.abs(torch.einsum("bhtd,bhtd->bht", n_tot, q) / (hd ** 0.5)),
        torch.exp(-m_t))
    y = y_num / denom[..., None]
    # state update to end of chunk
    loga_T = F_[..., -1:]                               # total chunk decay
    m_new = torch.maximum(state.m + loga_T[..., 0],
                          torch.amax(D[..., -1, :], dim=-1))
    up_w = torch.exp(F_[..., -1:] - F_ + logi - m_new[..., None])  # [B,H,T]
    decay = torch.exp(state.m + loga_T[..., 0] - m_new)
    c_new = (state.c * decay[..., None, None]
             + torch.einsum("bht,bhtd,bhte->bhde", up_w, v, k))
    n_new = (state.n * decay[..., None]
             + torch.einsum("bht,bhtd->bhd", up_w, k))
    return y, MLSTMState(c=c_new, n=n_new, m=m_new)


def mlstm_block(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MLSTMState] = None
                ) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    """x: [B, S, d] -> (y [B, S, d], state' or None when no state was
    passed)."""
    b, s, d = x.shape
    H = cfg.num_heads
    hd = d // H
    f32 = torch.float32
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"]).to(f32)
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"]).to(f32)
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"]).to(f32)
    xf = x.to(f32)
    logi = (xf @ p["wi"]).transpose(1, 2)                 # [B,H,S]
    logf = F.logsigmoid((xf @ p["wf"]).transpose(1, 2)
                        + p["f_bias"][:, None])
    st = state if state is not None else init_mlstm_state(cfg, b, x.device)
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        logi = F.pad(logi, (0, pad), value=-1e30)
        logf = F.pad(logf, (0, pad))
    ys = [None] * ((s + pad) // chunk)
    carry = st
    chunks = hlo_cost.like_bodies(len(ys))  # all, or three (hlo_cost)
    for i in chunks:
        sl = slice(i * chunk, (i + 1) * chunk)
        ys[i], carry = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                    logf[..., sl], logi[..., sl], carry)
    chunks.fill(ys)
    y = torch.cat(ys, dim=2)[:, :, :s]
    y = y.transpose(1, 2).to(x.dtype)                     # [B,S,H,hd]
    out = torch.einsum("bshk,hkd->bsd", y, p["wo"])
    return out, (carry if state is not None else None)


# ---------------------------------------------------------------------------
# sLSTM (sequential scalar memory)
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    dt = cfg.param_dtype
    return Params(wz=trunc_normal(gen, (d, H, hd), dt),
                  wi=trunc_normal(gen, (d, H, hd), dt),
                  wf=trunc_normal(gen, (d, H, hd), dt),
                  wo_g=trunc_normal(gen, (d, H, hd), dt),
                  rz=trunc_normal(gen, (H, hd, hd), dt),
                  ri=trunc_normal(gen, (H, hd, hd), dt),
                  rf=trunc_normal(gen, (H, hd, hd), dt),
                  ro=trunc_normal(gen, (H, hd, hd), dt),
                  f_bias=torch.full((H, hd), 3.0, dtype=torch.float32,
                                    device=gen.device),
                  wout=trunc_normal(gen, (H, hd, d), dt))


def slstm_logical_axes(cfg: ModelConfig) -> dict:
    ax3 = ("embed", "heads", "hd")
    axr = ("heads", "hd", None)
    return {"wz": ax3, "wi": ax3, "wf": ax3, "wo_g": ax3,
            "rz": axr, "ri": axr, "rf": axr, "ro": axr,
            "f_bias": ("heads", "hd"), "wout": ("heads", "hd", "embed")}


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, hd]
    n: torch.Tensor   # [B, H, hd]
    h: torch.Tensor   # [B, H, hd]
    m: torch.Tensor   # [B, H, hd]


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device=None) -> SLSTMState:
    H = cfg.num_heads
    hd = cfg.d_model // H
    z = torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z, m=torch.full_like(z, -1e30))


def slstm_block(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SLSTMState] = None
                ) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    """Sequential sLSTM: x [B, S, d] -> y [B, S, d] (one step a position,
    the reference's ``lax.scan`` over S)."""
    b, s, d = x.shape
    f32 = torch.float32
    zx = torch.einsum("bsd,dhk->sbhk", x, p["wz"]).to(f32)
    ix = torch.einsum("bsd,dhk->sbhk", x, p["wi"]).to(f32)
    fx = torch.einsum("bsd,dhk->sbhk", x, p["wf"]).to(f32)
    ox = torch.einsum("bsd,dhk->sbhk", x, p["wo_g"]).to(f32)
    st = state if state is not None else init_slstm_state(cfg, b, x.device)
    rz, ri, rf, ro = (p[n].to(f32) for n in ("rz", "ri", "rf", "ro"))
    f_bias = p["f_bias"]
    c, n, h, m = st
    hs = [None] * s
    steps = hlo_cost.like_bodies(s)     # all s, or three (hlo_cost)
    for t in steps:
        z = torch.tanh(zx[t] + torch.einsum("bhk,hkl->bhl", h, rz))
        logi = ix[t] + torch.einsum("bhk,hkl->bhl", h, ri)
        logf = F.logsigmoid(fx[t] + torch.einsum("bhk,hkl->bhl", h, rf)
                            + f_bias)
        o = torch.sigmoid(ox[t] + torch.einsum("bhk,hkl->bhl", h, ro))
        m_new = torch.maximum(logf + m, logi)
        i_p = torch.exp(logi - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs[t] = h
    steps.fill(hs)
    y = torch.stack(hs, dim=1).to(x.dtype)                # [B,S,H,hd]
    out = torch.einsum("bshk,hkd->bsd", y, p["wout"])
    final = SLSTMState(c=c, n=n, h=h, m=m)
    return out, (final if state is not None else None)
