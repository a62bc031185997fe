"""Context-parallel selective scan: the sequence sharded over a mesh axis
(the reference's ``models/ssm_cp.py``).

The SSM recurrence h_t = a_t h_{t-1} + bx_t is linear in the carried
state, so a sequence split across S shards needs only a tiny cross-shard
exchange:

  pass 1  (local)   : h_last^s = scan(x^s, h0=0),  A^s = prod_t a_t^s
  exchange (tiny)   : all_gather of (h_last^s, A^s) — [S, B, d, n] each
  prefix  (local)   : h_in^s = sum_{r<s} (prod_{r<q<s} A^q) h_last^r
  pass 2  (local)   : y^s = scan(x^s, h0=h_in^s)

Cost: 2x local scan compute + one all_gather of O(B·d·n).  The depthwise
conv preceding the scan gets its (width-1)-token halo from the left
neighbour via one ``ppermute``.  Both passes go through
``models/ssm.ssm_scan``, so on CUDA each is a launch of the selective-scan
kernel's ``chunked`` route, the second with a carried ``h0``.  The mesh's
shards run one after another on one device (``core/collectives.py``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.core.collectives import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import ParamsLike
from repro_torch.models.ssm import _ssm_coeffs, ssm_scan
from repro_torch.sharding import P


def _local_decay_product(p: ParamsLike, xc: torch.Tensor, cfg: ModelConfig
                         ) -> torch.Tensor:
    """prod_t a_t over the local sequence: [B, d_i, n] (f32), a chunk of
    ``cfg.ssm_chunk`` steps at a time, in the reference's order (the
    product underflows to 0 over long shards in both packages)."""
    b, s, di = xc.shape
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    xp = F.pad(xc, (0, 0, 0, pad))
    nc = xp.shape[1] // chunk
    xp = xp.reshape(b, nc, chunk, di).permute(1, 2, 0, 3)   # [nc,T,B,di]
    valid = (torch.arange(nc * chunk, device=xc.device) < s).reshape(
        nc, chunk)
    acc = torch.ones((b, di, cfg.ssm_state), dtype=torch.float32,
                     device=xc.device)
    for ci in range(nc):
        a, _, _ = _ssm_coeffs(p, xp[ci])                  # [T, B, di, n]
        a = torch.where(valid[ci][:, None, None, None], a, 1.0)
        acc = acc * torch.prod(a, dim=0)
    return acc


def _exclusive_prefix(h_all: torch.Tensor, a_all: torch.Tensor,
                      s: int) -> torch.Tensor:
    """h_in of shard ``s`` from every shard's (h_last, decay product), in
    the reference's loop order: shard r's contribution, decayed by the
    shards between, added for r = 0, 1, ..."""
    h_in = torch.zeros_like(h_all[0])
    for r in range(s):
        decay = torch.ones_like(a_all[0])
        for q in range(r + 1, s):
            decay = decay * a_all[q]
        h_in = h_in + h_all[r] * decay
    return h_in


def ssm_block_context_parallel(
    p: ParamsLike, x: torch.Tensor, cfg: ModelConfig, mesh: Mesh,
    seq_axis: str = "model",
    batch_axes: Optional[Tuple[str, ...]] = ("data",),
) -> torch.Tensor:
    """Mamba-style block with the sequence sharded over ``seq_axis``.

    x: [B, S, d], S split over ``seq_axis`` (and B over those of
    ``batch_axes`` that divide it).  Returns y [B, S, d].  Train/prefill
    only: stateless, the final state is discarded, as the reference's.
    """
    n_seq = mesh.shape[seq_axis]
    b_dim = x.shape[0]
    b_axes = tuple(a for a in (batch_axes or ())
                   if b_dim % mesh.shape[a] == 0) or None
    spec = P(b_axes, seq_axis, None)
    cw = cfg.ssm_conv
    idx = collectives.axis_index(mesh, seq_axis)
    xs = collectives.shard(x, mesh, spec)
    n = mesh.size

    xi: List[Optional[torch.Tensor]] = [None] * n
    z: List[Optional[torch.Tensor]] = [None] * n
    for s in range(n):
        xi[s], z[s] = torch.chunk(xs[s] @ p["in_proj"], 2, dim=-1)
    # conv halo: last (cw-1) tokens from the left neighbour (zeros at 0)
    if cw > 1:
        halo = collectives.ppermute([t[:, -(cw - 1):] for t in xi], mesh,
                                    seq_axis,
                                    [(s, s + 1) for s in range(n_seq - 1)])
    else:
        halo = [t[:, :0] for t in xi]
    xc: List[Optional[torch.Tensor]] = [None] * n
    h_last, a_prod = [None] * n, [None] * n
    for s in range(n):
        bl, sl, _ = xi[s].shape
        xin = torch.cat([halo[s].to(xi[s].dtype), xi[s]], dim=1)
        conv = sum(xin[:, i:i + sl] * p["conv_w"][i] for i in range(cw))
        xc[s] = F.silu(conv)
        xi[s] = None
        # pass 1: local final state + decay product
        _, h_last[s] = ssm_scan(p, xc[s], cfg, h0=torch.zeros(
            (bl, xc[s].shape[-1], cfg.ssm_state), dtype=torch.float32,
            device=x.device))
        a_prod[s] = _local_decay_product(p, xc[s], cfg)
    del halo
    # exchange: [n_seq, B, di, n] each (tiny)
    h_all = collectives.all_gather(h_last, mesh, seq_axis)
    a_all = collectives.all_gather(a_prod, mesh, seq_axis)
    ys = []
    for s in range(n):
        h_in = _exclusive_prefix(h_all[s], a_all[s], idx[s])
        # pass 2: the scan again from the carried state
        y, _ = ssm_scan(p, xc[s], cfg, h0=h_in)
        xc[s] = None
        ys.append((y * F.silu(z[s])) @ p["out_proj"])
        z[s] = None
    return collectives.unshard(ys, mesh, spec)
