"""Selective SSM (Mamba-style) block with a chunked scan and O(1) decode
state (the reference's ``models/ssm.py``).

The scan has two routes, picked by :func:`resolve_scan_impl` from the
activations' device unless a caller names one:

* ``"kernel"`` (on a CUDA tensor) — the hand-written CUDA selective scan,
  :func:`~repro_torch.kernels.ssm_scan.ops.ssm_scan_fused`, which computes
  the projection, the coefficients and the recurrence in one call; the
  ``d_skip`` term is added after it.  Where gradients are taken the call
  goes through ``SSMScan``, whose backward is the hand-written backward
  kernel (remat's recompute calls it again).  On a CPU tensor, the same
  call takes the plain versions of both.
* ``"chunked"`` (on a CPU tensor) — the reference's own scan: coefficients
  per chunk of ``cfg.ssm_chunk`` steps, a log-step scan within the chunk,
  the state carried from chunk to chunk.

Decode keeps (conv window, h state) per layer: constant per step.

:func:`mamba_mixer` is the published Mamba-1 mixer (Jamba's
``JambaMambaMixer``) beside hymba's block: a conv bias, dt from a
low-rank projection, RMSNorms on dt, B and C, and a scan whose
coefficients come from outside it: the kernel's dt route
(:func:`~repro_torch.kernels.ssm_scan.ops.ssm_scan_dt`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import ssm_scan_dt, ssm_scan_fused
from repro_torch.kernels.ssm_scan.ref import softplus
from repro_torch.models.common import ModelConfig, Params, trunc_normal
from repro_torch.models.layers import (ParamsLike, apply_rmsnorm,
                                       init_rmsnorm)


def init_ssm(gen: torch.Generator, cfg: ModelConfig,
             d_in: Optional[int] = None) -> Params:
    d = d_in or cfg.d_model
    di = d * max(cfg.ssm_expand, 1)
    n = cfg.ssm_state
    dt = cfg.param_dtype
    dev = gen.device
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return Params(
        in_proj=trunc_normal(gen, (d, 2 * di), dt),
        conv_w=trunc_normal(gen, (cfg.ssm_conv, di), dt),
        x_proj=trunc_normal(gen, (di, 2 * n + 1), dt),       # B, C, dt
        dt_bias=torch.zeros((di,), dtype=torch.float32, device=dev),
        a_log=torch.log(a).repeat(di, 1),                    # [di, n]
        d_skip=torch.ones((di,), dtype=torch.float32, device=dev),
        out_proj=trunc_normal(gen, (di, d), dt))


def ssm_logical_axes(cfg: ModelConfig) -> dict:
    return {"in_proj": ("embed", "ff"), "conv_w": ("conv", "ff"),
            "x_proj": ("ff", None), "dt_bias": ("ff",),
            "a_log": ("ff", "state"), "d_skip": ("ff",),
            "out_proj": ("ff", "embed")}


class SSMState(NamedTuple):
    conv: torch.Tensor    # [B, conv_width-1, di] trailing inputs
    h: torch.Tensor       # [B, di, n] recurrent state (f32)


def init_ssm_state(cfg: ModelConfig, batch: int,
                   d_in: Optional[int] = None, device=None) -> SSMState:
    d = d_in or cfg.d_model
    di = d * max(cfg.ssm_expand, 1)
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di),
                         dtype=cfg.param_dtype, device=device),
        h=torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                      device=device))


def _ssm_coeffs(p: ParamsLike, xc: torch.Tensor):
    """xc: [..., di] post-conv activations -> (a, bx, c) scan coefficients.

    a = exp(dt * A)  [.., di, n];  bx = dt * B * x  [.., di, n];  c [.., n].
    The projection is taken in xc's dtype, as the reference's.
    """
    proj = xc @ p["x_proj"].to(xc.dtype)                 # [.., 2n+1]
    n = p["a_log"].shape[1]
    bb, cc, dtr = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n]
    dt_ = softplus(dtr.float()[..., None] + p["dt_bias"])   # [.., di]
    a = torch.exp(-torch.exp(p["a_log"]) * dt_[..., None])  # [.., di, n]
    bx = (dt_ * xc.float())[..., None] * bb.float()[..., None, :]
    return a, bx, cc.float()


def _chunk_scan(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """Scan of h_t = a_t h_{t-1} + bx_t within a chunk, in log2(T) steps:
    after the step of offset k each position holds the composition of the
    last 2k updates (the reference's ``associative_scan`` combine).

    a, bx: [T, B, di, n]; h0: [B, di, n] -> (h_all [T, B, di, n], h_T)."""
    off = 1
    while off < a.shape[0]:
        a_prev, b_prev = a[:-off], bx[:-off]
        bx = torch.cat([bx[:off], a[off:] * b_prev + bx[off:]])
        a = torch.cat([a[:off], a[off:] * a_prev])
        off *= 2
    h_all = a * h0[None] + bx
    return h_all, h_all[-1]


def _chunked_scan(p: ParamsLike, xc: torch.Tensor, cfg: ModelConfig,
                  h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's scan without d_skip: y [B, S, di] f32 and h_final.
    Padded steps of the last chunk are the identity on the state."""
    b, s, di = xc.shape
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    xp = F.pad(xc, (0, 0, 0, pad))
    nc = xp.shape[1] // chunk
    xp = xp.reshape(b, nc, chunk, di).permute(1, 2, 0, 3)   # [nc,T,B,di]
    valid = (torch.arange(nc * chunk, device=xc.device) < s).reshape(
        nc, chunk)
    h = h0
    ys = []
    for ci in range(nc):
        a, bx, c = _ssm_coeffs(p, xp[ci])               # [T,B,di,n],[T,B,n]
        v = valid[ci][:, None, None, None]
        a = torch.where(v, a, 1.0)
        bx = torch.where(v, bx, 0.0)
        h_all, h = _chunk_scan(a, bx, h)
        ys.append(torch.einsum("tbdn,tbn->tbd", h_all, c))
    y = torch.stack(ys).permute(2, 0, 1, 3).reshape(b, nc * chunk, di)
    return y[:, :s], h


def resolve_scan_impl(device) -> str:
    """The scan's route on ``device``: the kernel on CUDA (and on meta,
    where its work is counted), the reference's chunked scan on the
    CPU."""
    return "kernel" if torch.device(device).type in ("cuda", "meta") \
        else "chunked"


def ssm_scan(p: ParamsLike, xc: torch.Tensor, cfg: ModelConfig,
             h0: Optional[torch.Tensor] = None, impl: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: [B, S, di] -> (y [B, S, di] in xc's dtype, h_final [B, di, n]).

    ``impl`` is ``"kernel"`` or ``"chunked"``; None picks by device
    (:func:`resolve_scan_impl`)."""
    b, _, di = xc.shape
    if h0 is None:
        h0 = torch.zeros((b, di, cfg.ssm_state), dtype=torch.float32,
                         device=xc.device)
    impl = impl or resolve_scan_impl(xc.device)
    if impl == "kernel":
        y, h_final = ssm_scan_fused(xc, p["x_proj"], p["dt_bias"],
                                    p["a_log"], h0, chunk=cfg.ssm_chunk)
    elif impl == "chunked":
        y, h_final = _chunked_scan(p, xc, cfg, h0)
    else:
        raise ValueError(f"ssm scan impl {impl!r}: 'kernel' or 'chunked'")
    y = y + xc.float() * p["d_skip"]
    return y.to(xc.dtype), h_final


def ssm_block(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[SSMState] = None, impl: Optional[str] = None
              ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full Mamba-ish block: in_proj -> conv -> SiLU -> SSM -> gate -> out.

    x: [B, S, d].  With ``state`` given, runs statefully (S may be 1 for
    decode) and returns the updated state.
    """
    s = x.shape[1]
    xz = x @ p["in_proj"]                                 # [B, S, 2*di]
    xi, z = torch.chunk(xz, 2, dim=-1)
    # depthwise causal conv along seq
    cw = cfg.ssm_conv
    if state is not None:
        xin = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
    else:
        xin = F.pad(xi, (0, 0, cw - 1, 0))
    conv = sum(xin[:, i:i + s] * p["conv_w"][i] for i in range(cw))
    xc = F.silu(conv)
    y, h_final = ssm_scan(p, xc, cfg, h0=state.h if state is not None
                          else None, impl=impl)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    new_state = None
    if state is not None:
        tail = xin[:, xin.shape[1] - (cw - 1):]
        new_state = SSMState(conv=tail.to(cfg.param_dtype), h=h_final)
    return out, new_state


# ---------------------------------------------------------------------------
# The published Mamba-1 mixer (Jamba)
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The published mixer's parameters: ``in_proj`` [d, 2 di] and
    ``out_proj`` [di, d] without bias; the depthwise conv ``conv_w``
    [conv, di] and its bias ``conv_b``; ``x_proj`` [di, r + 2n] to (dt, B,
    C); the norms ``dt_norm`` [r], ``b_norm``, ``c_norm`` [n]; ``dt_proj``
    [r, di] and its bias ``dt_bias`` [di] (added inside the scan, before
    softplus); ``a_log`` [di, n] = log(1 .. n) and ``d_skip`` ones, as
    Mamba initialises them.  ``dt_bias`` is softplus's inverse of dt drawn
    log-uniform in [0.001, 0.1], Mamba's initialisation."""
    d, n, r = cfg.d_model, cfg.ssm_state, cfg.ssm_dt_rank
    di = d * max(cfg.ssm_expand, 1)
    dt = cfg.param_dtype
    dev = gen.device
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    if dev.type == "meta":
        dt_bias = torch.empty((di,), dtype=torch.float32, device=dev)
    else:
        u = torch.rand((di,), generator=gen, device=dev)
        step = torch.exp(u * (math.log(0.1) - math.log(0.001))
                         + math.log(0.001)).clamp(min=1e-4)
        dt_bias = step + torch.log(-torch.expm1(-step))
    p = dict(in_proj=trunc_normal(gen, (d, 2 * di), dt),
             conv_w=trunc_normal(gen, (cfg.ssm_conv, di), dt))
    if cfg.ssm_conv_bias:
        p["conv_b"] = torch.zeros((di,), dtype=dt, device=dev)
    p.update(x_proj=trunc_normal(gen, (di, r + 2 * n), dt),
             dt_norm=init_rmsnorm(r, dt, dev),
             b_norm=init_rmsnorm(n, dt, dev),
             c_norm=init_rmsnorm(n, dt, dev),
             dt_proj=trunc_normal(gen, (r, di), dt),
             dt_bias=dt_bias,
             a_log=torch.log(a).repeat(di, 1),
             d_skip=torch.ones((di,), dtype=torch.float32, device=dev),
             out_proj=trunc_normal(gen, (di, d), dt))
    return Params(**p)


def mamba_logical_axes(cfg: ModelConfig) -> dict:
    axes = {"in_proj": ("embed", "ff"), "conv_w": ("conv", "ff"),
            "x_proj": ("ff", None), "dt_norm": {"scale": (None,)},
            "b_norm": {"scale": ("state",)},
            "c_norm": {"scale": ("state",)}, "dt_proj": (None, "ff"),
            "dt_bias": ("ff",), "a_log": ("ff", "state"),
            "d_skip": ("ff",), "out_proj": ("ff", "embed")}
    if cfg.ssm_conv_bias:
        axes["conv_b"] = ("ff",)
    return axes


def _causal_conv(p: ParamsLike, xi: torch.Tensor, cfg: ModelConfig,
                 state: Optional[SSMState]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depthwise causal conv of the published mixer, with its bias,
    then SiLU: (u [B, S, di] in xi's dtype, the window ``xin`` whose last
    ``conv - 1`` rows the state keeps).  Products and sums in float32,
    one accumulator."""
    s, cw = xi.shape[1], cfg.ssm_conv
    if state is not None:
        xin = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
    else:
        xin = F.pad(xi, (0, 0, cw - 1, 0))
    w = p["conv_w"].float()
    acc = xin[:, 0:s] * w[0]
    for i in range(1, cw):
        acc.addcmul_(xin[:, i:i + s], w[i])
    if cfg.ssm_conv_bias:
        acc.add_(p["conv_b"].float())
    return F.silu(acc, inplace=True).to(xi.dtype), xin


def mamba_mixer(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SSMState] = None
                ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """The published Mamba-1 mixer over x [B, S, d] (the block's normed
    input): ``[u, z] = in_proj(x)``; ``u = silu(conv(u) + conv_b)``; ``[dt,
    B, C] = x_proj(u)`` each RMS-normed; ``dt = dt_proj(dt)``; the scan
    with ``softplus(dt + dt_bias)`` a channel (the kernel's dt route on
    CUDA, its plain version on the CPU), plus ``d_skip * u``; ``out =
    out_proj(y * silu(z))``.  With ``state``, runs statefully (S may be 1)
    and returns the updated (conv window, h)."""
    n, r = cfg.ssm_state, cfg.ssm_dt_rank
    xz = x @ p["in_proj"]                                 # [B, S, 2*di]
    xi, z = torch.chunk(xz, 2, dim=-1)
    u, xin = _causal_conv(p, xi, cfg, state)
    del xz, xi
    dtr, bm, cm = torch.split(u @ p["x_proj"], [r, n, n], dim=-1)
    dtr = apply_rmsnorm(p["dt_norm"], dtr, eps=cfg.norm_eps)
    bm = apply_rmsnorm(p["b_norm"], bm, eps=cfg.norm_eps)
    cm = apply_rmsnorm(p["c_norm"], cm, eps=cfg.norm_eps)
    dt = dtr @ p["dt_proj"]                               # [B, S, di]
    y, h_final = ssm_scan_dt(u, dt, p["dt_bias"], bm, cm, p["a_log"],
                             state.h if state is not None else None)
    del dt
    y.addcmul_(u, p["d_skip"])
    out = (y.to(u.dtype) * F.silu(z)) @ p["out_proj"]
    new_state = None
    if state is not None:
        tail = xin[:, xin.shape[1] - (cfg.ssm_conv - 1):]
        new_state = SSMState(conv=tail.to(cfg.param_dtype), h=h_final)
    return out, new_state
