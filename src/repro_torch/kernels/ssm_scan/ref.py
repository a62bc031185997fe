"""Plain PyTorch selective scan: the oracle and the CUDA kernel's plain
version (the reference's ``kernels/ssm_scan/ref.py:ssm_scan_ref``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, exact for large x
    (``torch.nn.functional.softplus`` switches to x above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def ssm_scan_ref(xc: torch.Tensor, x_proj: torch.Tensor,
                 dt_bias: torch.Tensor, a_log: torch.Tensor,
                 h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential reference.

    xc: [B, T, d] post-conv activations; x_proj: [d, 2n+1];
    dt_bias: [d]; a_log: [d, n]; h0: [B, d, n].
    Returns (y [B, T, d] f32, h_final [B, d, n] f32), without d_skip."""
    n = a_log.shape[1]
    xf = xc.float()
    proj = xf @ x_proj.float()
    bb, cc, dtr = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n]
    dt = softplus(dtr[..., None] + dt_bias.float())         # [B, T, d]
    a = torch.exp(-torch.exp(a_log.float()) * dt[..., None])  # [B,T,d,n]
    bx = (dt * xf)[..., None] * bb[..., None, :]
    h = h0.float()
    ys = []
    for t in range(xc.shape[1]):
        h = a[:, t] * h + bx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cc[:, t]))
    return torch.stack(ys, dim=1), h


def dt_gate_ref(y: torch.Tensor, u: torch.Tensor, z: torch.Tensor,
                d_skip: torch.Tensor) -> torch.Tensor:
    """The mixer's gate after the dt scan, in u's dtype T: ``T(y + d_skip
    u)`` (an addcmul on y float32), ``T(silu(z))`` and their product in T;
    the three roundings the dt route's kernel makes."""
    return torch.addcmul(y, u, d_skip).to(u.dtype) * F.silu(z.to(u.dtype))


def ssm_scan_dt_ref(u: torch.Tensor, dt: torch.Tensor,
                    dt_bias: torch.Tensor, bm: torch.Tensor,
                    cm: torch.Tensor, a_log: torch.Tensor,
                    h0: torch.Tensor, z: torch.Tensor,
                    d_skip: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential reference of the dt route: the CUDA kernel's plain
    version.

    u: [B, T, d] post-conv activations; dt: [B, T, d] before ``dt_bias``
    and softplus; bm, cm: [B, T, n]; dt_bias: [d]; a_log: [d, n]; h0:
    [B, d, n]; the gate z: [B, T, d]; d_skip: [d].  Returns (out =
    :func:`dt_gate_ref` of the scan's y [B, T, d] in u's dtype, h_final
    [B, d, n] f32)."""
    dtp = softplus(dt.float() + dt_bias.float())            # [B, T, d]
    a = torch.exp(-torch.exp(a_log.float()) * dtp[..., None])
    bx = (dtp * u.float())[..., None] * bm.float()[:, :, None, :]
    cc = cm.float()
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        h = a[:, t] * h + bx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cc[:, t]))
    return dt_gate_ref(torch.stack(ys, dim=1), u, z, d_skip), h


def ssm_scan_bwd_ref(xc: torch.Tensor, x_proj: torch.Tensor,
                     dt_bias: torch.Tensor, a_log: torch.Tensor,
                     h0: torch.Tensor, dy: torch.Tensor, dh: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssm_scan_ref`: the CUDA backward kernel's
    plain version, the reverse recurrence in tensor code.

    Given ``dy [B, T, d]`` and ``dh [B, d, n]`` (the cotangents of y and
    h_final), with ``h_t`` recomputed from ``h0``:

    * ``lam_t = dy_t * C_t + a_{t+1} * lam_{t+1}``, from ``dh`` at T: the
      gradient reaching ``h_t``; ``dh0 = a_1 * lam_1``;
    * ``d(bx_t) = lam_t`` gives ``dB`` (summed over d), ``ddt`` and ``dx``;
      ``dC_t = sum_d dy * h_t``;
    * ``d(a_t) = lam_t * h_{t-1}`` gives ``ddt`` through ``-A * a`` and
      ``dA`` through ``-dt * a``; ``da_log = dA * A``;
    * softplus' is ``sigmoid(dtr + dt_bias)``; ``dproj = [dB | dC |
      ddtr]``, so ``dxc += dproj @ x_proj^T`` and ``dx_proj = xc^T @
      dproj``.

    Returns (dxc in xc's dtype, dx_proj in x_proj's, ddt_bias, da_log,
    dh0 in float32)."""
    n = a_log.shape[1]
    b, steps, d = xc.shape
    xf, w = xc.float(), x_proj.float()
    proj = xf @ w
    bb, cc, dtr = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n]
    z = dtr[..., None] + dt_bias.float()                    # [B, T, d]
    dt = softplus(z)
    A = torch.exp(a_log.float())                            # [d, n]
    a = torch.exp(-A * dt[..., None])                       # [B, T, d, n]
    dx = dt * xf
    h = h0.float()
    hs = []
    for t in range(steps):
        h = a[:, t] * h + dx[:, t, :, None] * bb[:, t, None, :]
        hs.append(h)
    hs = torch.stack(hs, dim=1)                             # h_t
    h_prev = torch.cat([h0.float()[:, None], hs[:, :-1]], dim=1)
    carry = dh.float()
    lams = []
    for t in range(steps - 1, -1, -1):
        lam = dy[:, t, :, None].float() * cc[:, t, None, :] + carry
        lams.append(lam)
        carry = a[:, t] * lam
    lam = torch.stack(lams[::-1], dim=1)                    # [B, T, d, n]
    q = lam * a * h_prev                                    # d(a) * a
    lam_b = torch.einsum("btdn,btn->btd", lam, bb)
    ddt = xf * lam_b - torch.einsum("btdn,dn->btd", q, A)
    dz = ddt * torch.sigmoid(z)
    dproj = torch.cat([torch.einsum("btdn,btd->btn", lam, dx),
                       torch.einsum("btdn,btd->btn", hs, dy.float()),
                       dz.sum(-1, keepdim=True)], dim=-1)   # [B, T, 2n+1]
    dxc = dt * lam_b + dproj @ w.T
    dx_proj = xf.reshape(b * steps, d).T @ dproj.reshape(b * steps, -1)
    da_log = -(q * dt[..., None]).sum((0, 1)) * A
    return (dxc.to(xc.dtype), dx_proj.to(x_proj.dtype), dz.sum((0, 1)),
            da_log, carry)


def _lane_scan(p: torch.Tensor, v: torch.Tensor, reverse: bool
               ) -> torch.Tensor:
    """Inclusive scan over dim 1 (the lanes) of the affine maps ``h ->
    p * h + v`` (Hillis-Steele, as the kernel's warp shuffles): lane i
    ends with the maps of lanes 0..i composed (``reverse``: i..last)."""
    p, v = p.clone(), v.clone()
    lanes, off = p.shape[1], 1
    while off < lanes:
        if reverse:
            v[:, :-off] = p[:, :-off] * v[:, off:] + v[:, :-off]
            p[:, :-off] = p[:, :-off] * p[:, off:]
        else:
            v[:, off:] = p[:, off:] * v[:, :-off] + v[:, off:]
            p[:, off:] = p[:, off:] * p[:, :-off]
        off *= 2
    return v


def ssm_scan_bwd_spans_ref(xc: torch.Tensor, x_proj: torch.Tensor,
                           dt_bias: torch.Tensor, a_log: torch.Tensor,
                           h0: torch.Tensor, dy: torch.Tensor,
                           dh: torch.Tensor, span: int = 128,
                           lanes: int = 16, group: int = 28
                           ) -> Tuple[torch.Tensor, ...]:
    """The CUDA backward's decomposition in tensor code (tests only; same
    arguments and results as :func:`ssm_scan_bwd_ref`).

    T is cut into spans of ``span`` steps, each ``lanes`` lanes of
    ``span / lanes`` consecutive steps; the last span is padded with steps
    that change nothing (dt = 0, so a = 1, and x = dy = B = C = 0).  The
    spans are walked from the last to the first.  In each, for every
    (channel, state):

    (a) forward: each lane folds its steps into one map ``h -> P h + H``
        (P the product of its a's), the state entering the span (the
        forward's saved state; here the sequential forward's) is folded
        into lane 0's map, the lanes' maps are scanned, and each lane
        walks its steps from the state the scan gives it: h_t and
        h_{t-1};
    (b) reverse: the same for ``g -> a_t (dy_t C_t + g)`` from the right,
        with the gradient leaving the next span's first step folded into
        the last lane's map: lam_t and that gradient for this span, the
        carry into the span before it (dh enters the last span; what
        leaves the first is dh0).

    One a per state-step serves both.  The sums over states (dx, ddt)
    stay per (channel, step); the sums over channels (dB, dC, ddtr) are
    taken per group of ``group`` channels (the last group may be short)
    and the group partials added in group order; da_log's and ddt_bias's
    sums over steps are per batch row, added in row order.  Only products
    of a's are formed, never a division by one."""
    n = a_log.shape[1]
    b, steps, d = xc.shape
    if span % lanes:
        raise ValueError(f"span {span} is not a whole number of "
                         f"{lanes} lanes")
    items = span // lanes
    nsp = -(-steps // span)
    pad = nsp * span - steps
    xf, w = xc.float(), x_proj.float()
    proj = xf @ w
    bb, cc, dtr = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n]
    z = dtr[..., None] + dt_bias.float()                    # [B, T, d]
    dt = softplus(z)
    A = torch.exp(a_log.float())                            # [d, n]
    a = torch.exp(-A * dt[..., None])
    # the states entering each span, as the forward saves them
    h, enter = h0.float(), [h0.float()]
    for t in range(steps - 1):
        h = a[:, t] * h + (dt[:, t] * xf[:, t])[..., None] * bb[:, t, None]
        if (t + 1) % span == 0:
            enter.append(h)

    def padded(v):
        return torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)

    dtp, xp, dyp = padded(dt), padded(xf), padded(dy.float())
    bp, cp = padded(bb), padded(cc)
    dtx = dtp * xp
    carry = dh.float()
    lam_all, q_all, h_all = [], [], []
    for j in range(nsp - 1, -1, -1):
        sl = slice(j * span, (j + 1) * span)

        def lanewise(v):
            return v[:, sl].reshape((b, lanes, items) + v.shape[2:])

        aj = torch.exp(-A * lanewise(dtp)[..., None])       # [B,l,i,d,n]
        bx = lanewise(dtx)[..., None] * lanewise(bp)[:, :, :, None]
        dyc = lanewise(dyp)[..., None] * lanewise(cp)[:, :, :, None]
        p_loc = aj.prod(dim=2)                              # [B,l,d,n]
        hh = bx[:, :, 0].clone()
        for k in range(1, items):
            hh = aj[:, :, k] * hh + bx[:, :, k]             # (a)
        hh[:, 0] = p_loc[:, 0] * enter[j] + hh[:, 0]
        hh = _lane_scan(p_loc, hh, reverse=False)
        hp = torch.cat([enter[j][:, None], hh[:, :-1]], dim=1)
        hs = []
        for k in range(items):
            hs.append(hp)
            hp = aj[:, :, k] * hp + bx[:, :, k]
        hs.append(hp)                   # h_{t-1} for each item, then h_T
        gg = aj[:, :, -1] * dyc[:, :, -1]
        for k in range(items - 2, -1, -1):
            gg = aj[:, :, k] * (dyc[:, :, k] + gg)          # (b)
        gg[:, -1] = p_loc[:, -1] * carry + gg[:, -1]
        gg = _lane_scan(p_loc, gg, reverse=True)
        g = torch.cat([gg[:, 1:], carry[:, None]], dim=1)
        lams = [None] * items
        for k in range(items - 1, -1, -1):
            lams[k] = dyc[:, :, k] + g
            g = aj[:, :, k] * lams[k]
        carry = g[:, 0]

        def steps_of(vs):
            return torch.stack(vs, dim=2).reshape((b, span, d, n))

        lam = steps_of(lams)
        h_prev = steps_of(hs[:items])
        h_all.append(steps_of(hs[1:]))
        lam_all.append(lam)
        q_all.append(lam * aj.reshape(lam.shape) * h_prev)
    lam = torch.cat(lam_all[::-1], dim=1)[:, :steps]        # [B, T, d, n]
    q = torch.cat(q_all[::-1], dim=1)[:, :steps]            # d(a) * a
    hs = torch.cat(h_all[::-1], dim=1)[:, :steps]
    lam_b = torch.einsum("btdn,btn->btd", lam, bb)
    ddt = xf * lam_b - torch.einsum("btdn,dn->btd", q, A)
    dz = ddt * torch.sigmoid(z)
    dx = dt * xf
    dproj = 0
    for c0 in range(0, d, group):                           # group order
        g = slice(c0, c0 + group)
        dproj = dproj + torch.cat(
            [torch.einsum("btdn,btd->btn", lam[:, :, g], dx[:, :, g]),
             torch.einsum("btdn,btd->btn", hs[:, :, g], dy[:, :, g].float()),
             dz[:, :, g].sum(-1, keepdim=True)], dim=-1)    # [B, T, 2n+1]
    dxc = dt * lam_b + dproj @ w.T
    dx_proj = xf.reshape(b * steps, d).T @ dproj.reshape(b * steps, -1)
    da = (q * dt[..., None]).sum(1)                         # per row
    dbias = dz.sum(1)
    da_sum, dbias_sum = 0, 0
    for r in range(b):                                      # row order
        da_sum, dbias_sum = da_sum + da[r], dbias_sum + dbias[r]
    return (dxc.to(xc.dtype), dx_proj.to(x_proj.dtype), dbias_sum,
            -da_sum * A, carry)


def ssm_scan_chunked_ref(xc: torch.Tensor, x_proj: torch.Tensor,
                         dt_bias: torch.Tensor, a_log: torch.Tensor,
                         h0: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA chunked route's two-level algebra in tensor code (tests
    only; same arguments and results as :func:`ssm_scan_ref`):

    (a) each chunk of ``chunk`` steps is scanned from h = 0, giving its
        local y, its end state ``h_end`` and the running sum of dt;
    (b) the carries ``h_in[c+1] = exp(-A * sum dt[c]) * h_in[c] +
        h_end[c]``, from ``h0``;
    (c) the fix-up ``y_t += sum_n C_t * exp(-A * cumdt_t) * h_in[c]``,
        with ``cumdt_t`` the sum of dt over the chunk up to t.

    Only ``exp(-A * s)`` of a non-negative sum s is formed, never
    ``exp(+A * cumdt)``."""
    n = a_log.shape[1]
    steps = xc.shape[1]
    xf = xc.float()
    proj = xf @ x_proj.float()
    bb, cc, dtr = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n]
    dt = softplus(dtr[..., None] + dt_bias.float())         # [B, T, d]
    A = torch.exp(a_log.float())                            # [d, n]
    a = torch.exp(-A * dt[..., None])                       # [B, T, d, n]
    bx = (dt * xf)[..., None] * bb[..., None, :]
    h_in = h0.float()
    ys = []
    for t0 in range(0, steps, chunk):
        t1 = min(steps, t0 + chunk)
        h = torch.zeros_like(h_in)                          # (a)
        local = []
        for t in range(t0, t1):
            h = a[:, t] * h + bx[:, t]
            local.append(torch.einsum("bdn,bn->bd", h, cc[:, t]))
        cum = torch.cumsum(dt[:, t0:t1], dim=1)             # [B, L, d]
        decay = torch.exp(-A * cum[..., None])              # [B, L, d, n]
        ys.append(torch.stack(local, dim=1) + torch.einsum(  # (c)
            "bldn,bdn,bln->bld", decay, h_in, cc[:, t0:t1]))
        h_in = decay[:, -1] * h_in + h                      # (b)
    return torch.cat(ys, dim=1), h_in


def ssm_scan_dt_chunked_ref(u: torch.Tensor, dt: torch.Tensor,
                            dt_bias: torch.Tensor, bm: torch.Tensor,
                            cm: torch.Tensor, a_log: torch.Tensor,
                            h0: torch.Tensor, z: torch.Tensor,
                            d_skip: torch.Tensor, chunk: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA dt route's chunked passes in tensor code (tests only; same
    arguments and results as :func:`ssm_scan_dt_ref`): (a) every chunk
    but the last scanned from h = 0 for its end state and its sum of dt
    (``ssm_dt_chunk_end``); (b) the carries ``h_in[c+1] = exp(-A * sum
    dt[c]) * h_in[c] + h_end[c]`` from ``h0`` (``ssm_chunk_carry``); (c)
    each chunk re-run from ``h_in[c]``, writing the gated y
    (``ssm_dt_chunk_scan``)."""
    steps = u.shape[1]
    dtp = softplus(dt.float() + dt_bias.float())            # [B, T, d]
    A = torch.exp(a_log.float())                            # [d, n]
    a = torch.exp(-A * dtp[..., None])                      # [B, T, d, n]
    bx = (dtp * u.float())[..., None] * bm.float()[:, :, None, :]
    cc = cm.float()
    starts = list(range(0, steps, chunk))
    h_in = [h0.float()]
    for t0 in starts[:-1]:                                  # (a) and (b)
        h = torch.zeros_like(h_in[0])
        for t in range(t0, t0 + chunk):
            h = a[:, t] * h + bx[:, t]
        total = dtp[:, t0:t0 + chunk].sum(dim=1)            # [B, d]
        h_in.append(torch.exp(-A * total[..., None]) * h_in[-1] + h)
    ys = []
    for c, t0 in enumerate(starts):                         # (c)
        h = h_in[c]
        for t in range(t0, min(steps, t0 + chunk)):
            h = a[:, t] * h + bx[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, cc[:, t]))
    return dt_gate_ref(torch.stack(ys, dim=1), u, z, d_skip), h
