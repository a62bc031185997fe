"""The benchmark's plain float32 reference of a Jamba stack, and the
comparison that decides ``correct`` for an ``lm_request`` cell.

A copy of the port's ``models/jamba_ref.py``, kept here so that a change
to the program cannot move the yardstick; it imports nothing of the
port.  The forward is written from the published ``modeling_jamba.py``
(transformers: ``JambaAttentionDecoderLayer``, ``JambaMambaDecoderLayer``,
the slow path of ``JambaMambaMixer``, ``JambaSparseMoeBlock``,
``JambaMLP``, ``JambaRMSNorm``) in plain ``torch``, every weight taken as
float32: no kernel, no JAX.  One sequence at a time, no cache, no
batching, no padding; TF32 off while it runs.  On the card the caller
makes each layer's weights again from the seed (``data/lm_weights.py``)
as ``layer(i)`` asks for them, bfloat16 values taken as float32.

Departures from ``modeling_jamba.py``, none of which changes the
function in exact arithmetic:

* every matrix is ``[in, out]`` (``x @ w``, as the port holds them), not
  ``nn.Linear``'s ``[out, in]``; attention's are ``[d, heads, head_dim]``
  and ``[heads, head_dim, d]``;
* all of it in float32, where the published model runs in its weights'
  type and rounds the scan state to it for the ``C`` product;
* ``dt_proj``'s bias (``dt_bias``) is added with the projection, then
  softplus, as the slow path does; the scan runs a step at a time over
  blocks of steps whose decays and inputs are formed at once;
* the router's product in float32 (the published one is a linear layer in
  the weights' type; its softmax is float32 in both);
* attention in blocks of query rows, each against the keys up to its last
  row, with the causal mask; a row's softmax over all its keys at once;
* given the program's choice of experts (``routing``), a token takes it
  where each chosen expert's router logit lies within a margin of the
  k-th largest here: two experts that tie within rounding may come out
  either way, and such a flip would move the logits by more than any
  rounding does.  Choices outside the margin are counted, not taken.

The weights: ``outer`` holds ``embed.table`` [V, d], ``embed.unembed``
[d, V] and ``final_norm.scale`` [d]; ``layer(i)`` returns layer ``i``'s
tensors under the port's names (``norm1.scale``, ``attn.wq``,
``mamba.in_proj``, ``moe.w1``, ...).  ``cfg`` holds the published keys
(``hidden_size``, ``num_attention_heads``, ``mamba_d_state``, ...).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

#: The type a control rounds every matrix product's operands to (None: the
#: products take their operands as they are).
_LOW: contextvars.ContextVar = contextvars.ContextVar("jamba_ref_low",
                                                      default=None)


def _round(t: torch.Tensor, low: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``low`` under one scale for the whole tensor (its
    largest magnitude to ``low``'s largest finite value), back in t's
    type: the per-tensor scaling of a float8 product."""
    scale = torch.finfo(low).max / t.abs().max().clamp(min=1e-30)
    return (t * scale).to(low).to(t.dtype) / scale


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    low = _LOW.get()
    if low is None:
        return a @ b
    return _round(a, low) @ _round(b, low)


def _ein(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    low = _LOW.get()
    if low is not None:
        a, b = _round(a, low), _round(b, low)
    return torch.einsum(eq, a, b)


def layer_kinds(cfg: dict) -> List[Tuple[str, str]]:
    """Each layer's (``"attention"`` or ``"mamba"``, ``"mlp"`` or
    ``"moe"``) from the period and offset keys, as ``JambaModel``."""
    return [("attention" if i % cfg["attn_layer_period"]
             == cfg["attn_layer_offset"] else "mamba",
             "moe" if i % cfg["expert_layer_period"]
             == cfg["expert_layer_offset"] else "mlp")
            for i in range(cfg["num_hidden_layers"])]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * w.to(x.dtype)


@contextlib.contextmanager
def no_tf32():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def _f(w: Weights, name: str, like: torch.Tensor) -> torch.Tensor:
    """Weight ``name`` in the type of the activations ``like``."""
    return w[name].to(like.dtype)


def attention(w: Weights, x: torch.Tensor, cfg: dict,
              q_block: int = 256) -> torch.Tensor:
    """Causal GQA attention without positions over x [S, d]."""
    s, d = x.shape
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    q = _mm(x, _f(w, "attn.wq", x).reshape(d, h * hd)).reshape(
        s, kv, h // kv, hd)
    k = _mm(x, _f(w, "attn.wk", x).reshape(d, kv * hd)).reshape(s, kv, hd)
    v = _mm(x, _f(w, "attn.wv", x).reshape(d, kv * hd)).reshape(s, kv, hd)
    out = torch.empty((s, kv, h // kv, hd), dtype=x.dtype, device=x.device)
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(s, device=x.device)
    for q0 in range(0, s, q_block):
        q1 = min(s, q0 + q_block)
        scores = _ein("qkgd,skd->kgqs", q[q0:q1], k[:q1]) * scale
        keep = pos[None, :q1] <= pos[q0:q1, None]
        scores = scores.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out[q0:q1] = _ein("kgqs,skd->qkgd", probs, v[:q1])
    return _mm(out.reshape(s, h * hd), _f(w, "attn.wo", x).reshape(h * hd,
                                                                   d))


def mamba(w: Weights, x: torch.Tensor, cfg: dict,
          state_dtype: torch.dtype = torch.float32,
          block: int = 512) -> torch.Tensor:
    """``JambaMambaMixer``'s slow path over x [S, d]: the state held in
    ``state_dtype`` (float32; lower only for a control), the rest in
    x's type."""
    s = x.shape[0]
    n, r, k = cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    eps = cfg["rms_norm_eps"]
    u, z = _mm(x, _f(w, "mamba.in_proj", x)).chunk(2, dim=-1)
    di = u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    conv_w = _f(w, "mamba.conv_w", x)                    # [k, di]
    conv = sum(pad[i:i + s] * conv_w[i] for i in range(k))
    if cfg["mamba_conv_bias"]:
        conv = conv + _f(w, "mamba.conv_b", x)
    u = F.silu(conv)
    del pad, conv
    dtr, bm, cm = torch.split(_mm(u, _f(w, "mamba.x_proj", x)), [r, n, n],
                              dim=-1)
    dtr = rms_norm(dtr, w["mamba.dt_norm.scale"], eps)
    bm = rms_norm(bm, w["mamba.b_norm.scale"], eps)
    cm = rms_norm(cm, w["mamba.c_norm.scale"], eps)
    dt = F.softplus(_mm(dtr, _f(w, "mamba.dt_proj", x))
                    + _f(w, "mamba.dt_bias", x))
    a_neg = -torch.exp(_f(w, "mamba.a_log", x))          # [di, n]
    h = torch.zeros((di, n), dtype=state_dtype, device=x.device)
    y = torch.empty((s, di), dtype=x.dtype, device=x.device)
    for t0 in range(0, s, block):
        t1 = min(s, t0 + block)
        decay = torch.exp(a_neg[None] * dt[t0:t1, :, None])
        inp = (dt[t0:t1] * u[t0:t1])[:, :, None] * bm[t0:t1, None, :]
        hs = torch.empty((t1 - t0, di, n), dtype=state_dtype,
                         device=x.device)
        for a_t, b_t, out_t in zip(decay.unbind(0), inp.unbind(0),
                                   hs.unbind(0)):
            torch.addcmul(b_t, a_t, h, out=out_t)
            h = out_t
        y[t0:t1] = torch.einsum("tdn,tn->td", hs.to(x.dtype), cm[t0:t1])
        del decay, inp, hs
    y = y + u * _f(w, "mamba.d_skip", x)
    return _mm(y * F.silu(z), _f(w, "mamba.out_proj", x))


def mlp(w: Weights, x: torch.Tensor, prefix: str = "mlp.",
        rows: int = 16384) -> torch.Tensor:
    """SwiGLU, ``JambaMLP``: down(silu(gate(x)) * up(x)), in row blocks."""
    w1, w3, w2 = (_f(w, prefix + n, x) for n in ("w1", "w3", "w2"))
    out = torch.empty_like(x)
    for r0 in range(0, x.shape[0], rows):
        xb = x[r0:r0 + rows]
        out[r0:r0 + rows] = _mm(F.silu(_mm(xb, w1)) * _mm(xb, w3), w2)
    return out


def moe(w: Weights, x: torch.Tensor, cfg: dict,
        forced: Optional[torch.Tensor] = None, margin: float = 0.0,
        stats: Optional[dict] = None) -> torch.Tensor:
    """``JambaSparseMoeBlock``: softmax over the experts, the top k
    weights kept as they are (no renormalisation), each expert a SwiGLU
    over its rows, weighted and added.

    ``forced`` [S, k]: another computation's choice of experts (the
    program's).  A row takes it where each expert it names has a router
    logit within ``margin`` of the k-th largest here (two experts that
    tie within rounding may come out either way), else its own top k;
    ``stats`` counts the rows compared (``routing_rows``), those whose
    choice differs (``routing_flips``) and those outside the margin
    (``routing_wrong``), and keeps the largest shortfall of any of the
    given choices (``routing_deficit``)."""
    logits = _mm(x, _f(w, "moe.router", x))
    probs = torch.softmax(logits, dim=-1)
    k = cfg["num_experts_per_tok"]
    top_w, top_i = torch.topk(probs, k, dim=-1)
    if forced is not None:
        forced = forced.to(x.device).long()
        same = (torch.sort(forced, -1).values
                == torch.sort(top_i, -1).values).all(-1)
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        deficit = (kth - torch.gather(logits, 1, forced)).clamp(
            min=0).amax(-1)
        ok = deficit <= margin
        top_i = torch.where(ok[:, None], forced, top_i)
        top_w = torch.gather(probs, 1, top_i)
        if stats is not None:
            stats["routing_rows"] = stats.get("routing_rows", 0) + int(
                same.numel())
            stats["routing_flips"] = stats.get("routing_flips", 0) + int(
                (~same).sum())
            stats["routing_wrong"] = stats.get("routing_wrong", 0) + int(
                (~ok).sum())
            stats["routing_deficit"] = max(
                stats.get("routing_deficit", 0.0), float(deficit.max()))
    y = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        we = {n: w["moe." + n][e].to(x.dtype) for n in ("w1", "w3", "w2")}
        he = F.silu(_mm(xe, we["w1"])) * _mm(xe, we["w3"])
        y.index_add_(0, rows, _mm(he, we["w2"]) * top_w[rows, slot, None])
    return y


def forward(cfg: dict, outer: Weights, layer: Callable[[int], Weights],
            sequences: Sequence[torch.Tensor],
            positions: Sequence[int],
            state_dtype: torch.dtype = torch.float32,
            dtype: torch.dtype = torch.float32,
            matmul_dtype: Optional[torch.dtype] = None,
            routing: Optional[Sequence[Sequence[torch.Tensor]]] = None,
            route_margin: float = 0.0, stats: Optional[dict] = None
            ) -> List[torch.Tensor]:
    """The logits [len(positions), V] float32 at ``positions`` of each
    sequence (1-D token ids), layer by layer over all of them, so that
    each layer's weights are made once.  ``dtype`` (the weights' and
    activations' type) and ``state_dtype`` (the scan state's) are
    float32, and ``matmul_dtype`` None; a control computes lower:
    ``matmul_dtype`` rounds both operands of every matrix product to it
    under a per-tensor scale (``torch.float8_e4m3fn``: float8 products).
    ``routing[j][m]``, where given, is the program's expert choice in the
    m-th MoE layer for sequence j (see :func:`moe`: held to within
    ``route_margin``, counted in ``stats``)."""
    token = _LOW.set(matmul_dtype)
    try:
        return _forward(cfg, outer, layer, sequences, positions,
                        state_dtype, dtype, routing, route_margin, stats)
    finally:
        _LOW.reset(token)


def _forward(cfg, outer, layer, sequences, positions, state_dtype, dtype,
             routing, route_margin, stats):
    eps = cfg["rms_norm_eps"]
    moe_layer = 0
    with no_tf32(), torch.no_grad():
        table = outer["embed.table"]
        xs = [table[seq.long()].to(dtype) for seq in sequences]
        for i, (mixer, ffn) in enumerate(layer_kinds(cfg)):
            w = layer(i)
            for j, x in enumerate(xs):
                h = rms_norm(x, w["norm1.scale"], eps)
                x = x + (attention(w, h, cfg) if mixer == "attention"
                         else mamba(w, h, cfg, state_dtype))
                h = rms_norm(x, w["norm2.scale"], eps)
                if ffn == "moe":
                    forced = routing[j][moe_layer] if routing else None
                    xs[j] = x + moe(w, h, cfg, forced, route_margin, stats)
                else:
                    xs[j] = x + mlp(w, h)
            moe_layer += ffn == "moe"
            del w
        pos = torch.as_tensor(list(positions), device=xs[0].device)
        return [_mm(rms_norm(x[pos], outer["final_norm.scale"], eps),
                    outer["embed.unembed"].to(dtype)).float() for x in xs]


def compare(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]
            ) -> Dict[str, float]:
    """``logits_rel_rms``: the largest over the answers of ||got - want||
    / ||want|| over all of an answer's compared positions;
    ``logits_max_abs``: the largest |got - want| over all of them."""
    rel, worst = 0.0, 0.0
    for g, w in zip(got, want):
        diff = g.double() - w.double()
        rel = max(rel, float(diff.norm() / w.double().norm()))
        worst = max(worst, float(diff.abs().max()))
    return {"logits_rel_rms": rel, "logits_max_abs": worst}
