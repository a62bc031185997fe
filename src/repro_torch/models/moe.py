"""Mixture-of-Experts FFN with expert-parallel dispatch = MaRe
repartitionBy (the reference's ``models/moe.py``).

The reference's dense path, ``moe_ffn_dense``, sorts the token copies by
expert with ``argsort(stable=True)`` and sizes the groups with
``bincount``.  The port gets both from the dispatch kernel
(``kernels/moe_dispatch``): each copy's stable slot within its expert
plus the experts' sizes.  The slot offset by the exclusive prefix of the
sizes is the sort's inverse permutation, so ``xs[slot] = flat_x`` lays
the copies out exactly as ``take(flat_x, order)`` does.

Under an active mesh with a ``model`` axis (``sharding.use_rules``),
``moe_ffn`` takes the expert-parallel path, ``moe_ffn_sharded``: the
token->expert shuffle is the paper's repartitionBy (keyBy = router
top-k, the partitioner = expert owner): each shard packs its token
copies by owner with ``core/shuffle._pack_by_dest`` (a stable sort, as
the reference's; the dispatch kernel does not serve this path) and
exchanges them with one ``all_to_all`` over ``model``
(``core/collectives.py``: the mesh's shards run one after another on one
device).  Two expert-compute layouts:

* ``weight_gather`` — expert weights are FSDP-sharded over the other
  axes and all-gathered per layer (ZeRO-3; weight-stationary);
* ``token_gather`` — tokens are all-gathered over those axes and each
  shard computes its f-slice for the whole row, reduce-scattering the
  output (activation-stationary TP).

Capacity overflow is dropped and counted (``MoEStats.dropped``), as in
the reference.  The training loss adds each layer's aux loss; a caller
of an entry point that keeps only logits (a prefill) reads every layer's
stats inside :func:`collect_stats`.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.core.shuffle import _pack_by_dest, unpack_gather
from repro_torch.kernels.moe_dispatch.ops import moe_dispatch
from repro_torch.launch import hlo_cost
from repro_torch.models.common import ModelConfig, Params, trunc_normal
from repro_torch.models.layers import ParamsLike
from repro_torch.sharding import P, active


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = cfg.param_dtype
    return Params(router=trunc_normal(gen, (d, E), torch.float32),
                  w1=trunc_normal(gen, (E, d, f), dt),
                  w3=trunc_normal(gen, (E, d, f), dt),
                  w2=trunc_normal(gen, (E, f, d), dt))


def moe_logical_axes(cfg: ModelConfig) -> dict:
    return {"router": ("embed", None),
            "w1": ("experts", None, "expert_ff"),
            "w3": ("experts", None, "expert_ff"),
            "w2": ("experts", "expert_ff", None)}


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
    # one-hot by a compare, which every device runs alike (F.one_hot
    # scatters on CUDA and compares on meta: the work counts would differ)
    f_e = torch.mean((idx[:, :1] == torch.arange(E, device=idx.device))
                     .float(), dim=0)
    p_e = torch.mean(probs, dim=0)
    aux = E * torch.sum(f_e * p_e)
    return idx, gates.to(x2d.dtype), aux


def _expert_mlp(w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                xs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over rows sorted by expert (the reference's
    ``ragged_dot``): one matmul per non-empty expert on its contiguous
    rows; rows past the groups' total are 0.

    The slice bounds come to the host: one device-to-host copy of
    ``group_sizes`` (a stream sync) per call, i.e. per layer.  On the
    meta device the sizes have no values: the rows split evenly over the
    experts.  A work counter counts the products' work by
    :func:`expert_work`, whatever the sizes (which experts are empty is
    the data's)."""
    n, e_all = xs.shape[0], w1.shape[0]
    with hlo_cost.counted_as(*expert_work(n, xs.shape[1], w1.shape[2],
                                          e_all, xs.element_size())):
        ys = torch.empty_like(xs)
        off = 0
        if xs.device.type == "meta":
            sizes = [n // e_all + (e < n % e_all) for e in range(e_all)]
        else:
            sizes = group_sizes.tolist()
        for e, c in enumerate(sizes):
            if c:
                x = xs[off:off + c]
                h = F.silu(x @ w1[e]) * (x @ w3[e])
                ys[off:off + c] = h @ w2[e]
            off += c
        ys[off:] = 0
    return ys


def expert_work(n: int, d: int, f: int, experts: int,
                itemsize: int) -> Tuple[int, int, int]:
    """(operations, bytes, matmul operations) of the grouped SwiGLU over
    ``n`` rows of width ``d``, expert width ``f``: the three products
    (2 n d f operations each), SiLU and the gate's multiply (n f each);
    every expert's weights read once, each product's rows read and output
    written, and SiLU's, the multiply's and the copy into the output's
    traffic, as its eager ops move them when every expert holds rows."""
    matmul = 6 * n * d * f
    return (matmul + 2 * n * f,
            itemsize * (5 * n * d + 8 * n * f + 3 * experts * d * f),
            matmul)


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


# ---------------------------------------------------------------------------
# Expert-parallel path: repartitionBy over the `model` axis of the mesh
# ---------------------------------------------------------------------------

def moe_ffn_sharded(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig,
                    mode: Optional[str] = None
                    ) -> Tuple[torch.Tensor, MoEStats]:
    """x: [B, S, d], batch over the rules' batch axes and seq over
    ``model`` where they divide.  Each shard routes its tokens, packs its
    ``k`` copies of each by owner shard into ``[m, cap, d]`` (cap =
    tokens * k / m * capacity_factor), exchanges them over ``model``,
    packs what it received by local expert into ``[e_loc, cap_e, d]``,
    runs its experts as batched matmuls, and sends the outputs back the
    same way; ``dropped`` counts the copies lost to either capacity over
    the whole mesh, and the aux loss is the mesh's mean."""
    mode = mode or cfg.moe_mode
    rules, mesh = active()
    if mesh is None or "model" not in mesh.shape or \
            mesh.shape["model"] == 1 or \
            cfg.num_experts % mesh.shape["model"] != 0:
        return moe_ffn_dense(p, x, cfg)
    m = mesh.shape["model"]
    e_loc = cfg.num_experts // m
    k = cfg.experts_per_token
    # FSDP axes for expert weights (everything except 'model')
    fsdp_axes = tuple(a for a in mesh.axis_names if a != "model")
    fsdp = collectives.axis_size(mesh, fsdp_axes)
    f = cfg.moe_d_ff
    f_shard = fsdp if (f % fsdp == 0 and fsdp > 1) else 1
    f_axes = fsdp_axes if f_shard > 1 else ()

    batch_axes = rules.table.get("batch") if rules else "data"
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    seq_ax = rules.table.get("seq") if rules else "model"
    b_dim, s_dim = x.shape[0], x.shape[1]
    if b_dim % collectives.axis_size(mesh, batch_axes or ()) != 0:
        batch_axes = None
    if seq_ax is not None and (s_dim % mesh.shape.get(seq_ax, 1) != 0
                               or s_dim == 1):
        seq_ax = None  # decode / non-divisible: replicate seq over model

    x_spec = P(batch_axes, seq_ax, None)
    w_spec = P("model", None, f_axes if f_axes else None)
    w2_spec = P("model", f_axes if f_axes else None, None)
    xs = collectives.shard(x, mesh, x_spec)
    w1s = collectives.shard(p["w1"], mesh, w_spec)
    w3s = collectives.shard(p["w3"], mesh, w_spec)
    w2s = collectives.shard(p["w2"], mesh, w2_spec)
    dt = cfg.param_dtype
    model_idx = collectives.axis_index(mesh, "model")
    n_shards = mesh.size
    d = x.shape[-1]

    # route and pack each shard's token copies by owner shard (each
    # loop's shard bodies are alike: a work counter that counts loops once
    # runs three, launch/hlo_cost.like_bodies)
    gates, aux, pack1, bx, be, counts = ([None] * n_shards for _ in range(6))
    shards = hlo_cost.like_bodies(n_shards)
    for s in shards:
        x2 = xs[s].reshape(-1, d).to(dt)
        tl = x2.shape[0]
        idx, g, aux[s] = _route({"router": p["router"]}, x2, cfg)
        gates[s] = g.to(dt)
        flat_e = idx.reshape(-1)                   # [tl*k] expert ids
        owner = flat_e // e_loc                    # destination model shard
        flat_x = torch.repeat_interleave(x2, k, dim=0).to(dt)
        cap = max(1, int(tl * k / m * cfg.capacity_factor))
        valid = torch.ones((tl * k,), dtype=torch.bool, device=x.device)
        pack1[s] = _pack_by_dest((flat_x, flat_e.to(torch.int32)), owner,
                                 valid, m, cap)
        bx[s], be[s] = pack1[s].buffer
        counts[s] = pack1[s].counts.reshape(m, 1)
    shards.fill(gates, aux, pack1, bx, be, counts)
    rx = collectives.all_to_all(bx, mesh, "model")       # [m, cap, d]
    re = collectives.all_to_all(be, mesh, "model")
    rc = collectives.all_to_all(counts, mesh, "model")
    del bx, be, counts

    # pack what each shard received by LOCAL expert into [e_loc, cap_e, d]
    pack2, bx2 = [None] * n_shards, [None] * n_shards
    shards = hlo_cost.like_bodies(n_shards)
    for s in shards:
        cap = rx[s].shape[1]
        slot_ok = (torch.arange(cap, device=x.device)[None, :]
                   < rc[s].reshape(m)[:, None]).reshape(-1)
        re_l = re[s].reshape(-1) - model_idx[s] * e_loc
        re_l = torch.where(slot_ok, re_l,
                           torch.full_like(re_l, e_loc))  # invalid: sentinel
        cap_e = max(1, int(m * cap / e_loc * cfg.capacity_factor))
        pack2[s] = _pack_by_dest((rx[s].reshape(-1, d).to(dt),), re_l,
                                 slot_ok, e_loc, cap_e)
        (bx2[s],) = pack2[s].buffer
        rx[s] = re[s] = None
    shards.fill(pack2, bx2)

    def experts(xb, w1, w3, w2):
        h = torch.einsum("ecd,edf->ecf", xb, w1)
        u = torch.einsum("ecd,edf->ecf", xb, w3)
        return torch.einsum("ecf,efd->ecd", F.silu(h) * u, w2)

    if mode == "token_gather" and f_shard > 1:
        # activation-stationary: replicate packed tokens over the fsdp
        # axes, compute the local f-slice, reduce-scatter partial sums
        # back (the down-proj contracts f so partials sum exactly)
        xg = collectives.all_gather(bx2, mesh, f_axes, axis=1, tiled=True)
        del bx2
        yg = [None] * n_shards
        shards = hlo_cost.like_bodies(n_shards)
        for s in shards:
            yg[s] = experts(xg[s], w1s[s], w3s[s], w2s[s])
            xg[s] = None
        shards.fill(yg)
        ys_blk = collectives.psum_scatter(
            yg, mesh, f_axes[0] if len(f_axes) == 1 else f_axes,
            scatter_dimension=1, tiled=True)
        del yg
    else:
        if f_shard > 1:
            w1s = collectives.all_gather(w1s, mesh, f_axes, axis=2,
                                         tiled=True)
            w3s = collectives.all_gather(w3s, mesh, f_axes, axis=2,
                                         tiled=True)
            w2s = collectives.all_gather(w2s, mesh, f_axes, axis=1,
                                         tiled=True)
        ys_blk = [None] * n_shards
        shards = hlo_cost.like_bodies(n_shards)
        for s in shards:
            ys_blk[s] = experts(bx2[s], w1s[s], w3s[s], w2s[s])
            bx2[s] = None
        shards.fill(ys_blk)

    # gather expert outputs back to recv-slot layout (pure gather — the
    # pack's inverse; dropped slots read the sentinel zero row)
    y_buf, dropped = [None] * n_shards, [None] * n_shards
    shards = hlo_cost.like_bodies(n_shards)
    for s in shards:
        cap_e = pack2[s].buffer[0].shape[1]
        y_unsort = unpack_gather(ys_blk[s].reshape(-1, d), pack2[s], cap_e)
        dropped[s] = (pack1[s].dropped + pack2[s].dropped).float()
        y_buf[s] = y_unsort.reshape(m, -1, d)
        ys_blk[s] = None
    shards.fill(y_buf, dropped)
    y_back = collectives.all_to_all(y_buf, mesh, "model")  # [m, cap, d]
    del y_buf
    ys = [None] * n_shards
    shards = hlo_cost.like_bodies(n_shards)
    for s in shards:
        cap = y_back[s].shape[1]
        y_per_choice = unpack_gather(y_back[s].reshape(-1, d), pack1[s],
                                     cap)
        tl = y_per_choice.shape[0] // k
        y2 = torch.sum(y_per_choice.reshape(tl, k, d) * gates[s][..., None],
                       dim=1)
        ys[s] = y2.reshape(xs[s].shape)
        y_back[s] = None
    shards.fill(ys)
    all_axes = tuple(mesh.axis_names)
    n_drop = collectives.psum(dropped, mesh, all_axes)
    aux = collectives.pmean(aux, mesh, all_axes)
    y = collectives.unshard(ys, mesh, x_spec)
    return y, MoEStats(aux_loss=aux[0], dropped=n_drop[0])


_SINK: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_stats", default=None)


@contextlib.contextmanager
def collect_stats():
    """Yields a list to which every :func:`moe_ffn` call inside appends
    its MoEStats, in call order (a forward's layers in order)."""
    sink: List[MoEStats] = []
    tok = _SINK.set(sink)
    try:
        yield sink
    finally:
        _SINK.reset(tok)


def moe_ffn(p: ParamsLike, x: torch.Tensor, cfg: ModelConfig,
            mode: Optional[str] = None) -> Tuple[torch.Tensor, MoEStats]:
    """The MoE FFN: the expert-parallel path under an active mesh whose
    ``model`` axis has more than one shard and divides the experts, else
    the dense path."""
    _, mesh = active()
    if mesh is not None and mesh.shape.get("model", 1) > 1 and \
            cfg.num_experts % mesh.shape["model"] == 0:
        y, stats = moe_ffn_sharded(p, x, cfg, mode=mode or cfg.moe_mode)
    else:
        y, stats = moe_ffn_dense(p, x, cfg)
    sink = _SINK.get()
    if sink is not None:
        sink.append(stats)
    return y, stats
