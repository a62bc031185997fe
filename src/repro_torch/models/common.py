"""Model configuration shared by all 10 assigned architectures, the
parameter-tree node, and the truncated-normal initializer (the reference's
``models/common.py`` on PyTorch)."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, ClassVar, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import hlo_cost


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    #                             | jamba
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 1
    window: Optional[int] = None          # sliding-window size (SWA layers)
    global_layers: Tuple[int, ...] = ()   # full-attention layer ids (hymba)
    # xLSTM
    slstm_every: int = 0                  # 1 sLSTM per this many blocks
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                  # stub frontend output length
    # vlm
    num_patches: int = 0                  # stub vision tokens
    # common
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    use_layernorm: bool = False           # whisper uses LN+bias
    use_gelu: bool = False                # whisper MLP
    dtype: str = "bfloat16"               # activation/param dtype
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "auto"               # ref | chunked | pallas | auto
    attn_chunk: int = 512
    ssm_chunk: int = 256
    capacity_factor: float = 1.25
    moe_mode: str = "weight_gather"   # weight_gather | token_gather
    ssm_cp: bool = False              # context-parallel SSM (seq sharded)

    # What every family but jamba keeps fixed (class attributes, not
    # fields: the ten assigned configs stay the reference's field for
    # field); JambaConfig makes them fields.
    use_rope: ClassVar[bool] = True           # RoPE in every attention
    moe_renormalize: ClassVar[bool] = True    # top-k gates over their sum
    logits_to_keep: ClassVar[int] = 0         # a prefill's logits: all

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run long_500k?  (SSM / hybrid-with-window)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.window is not None:
            return True
        return False

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family (per-arch smoke tests)."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class JambaConfig(ModelConfig):
    """The jamba family (AI21's Jamba): the published Mamba-1 mixer, each
    layer's kinds from a period and an offset, attention without RoPE,
    top-k gates kept as the softmax gives them, and a prefill that keeps
    the last ``logits_to_keep`` positions' logits (0: all)."""
    ssm_dt_rank: int = 0                  # dt's low rank
    ssm_conv_bias: bool = True
    attn_layer_period: int = 1            # attention where i % period ==
    attn_layer_offset: int = 0            # offset, Mamba elsewhere
    expert_layer_period: int = 1          # MoE where i % period == offset,
    expert_layer_offset: int = 0          # a dense MLP elsewhere
    use_rope: bool = False
    moe_renormalize: bool = False
    logits_to_keep: int = 1

    def layer_kind(self, i: int) -> Tuple[str, str]:
        """Layer ``i``'s kinds, (``"attention"`` or ``"mamba"``, ``"mlp"``
        or ``"moe"``): attention where ``i % attn_layer_period ==
        attn_layer_offset``, the MoE where ``i % expert_layer_period ==
        expert_layer_offset``, as the published ``modeling_jamba.py``
        derives them."""
        mixer = "attention" if i % self.attn_layer_period \
            == self.attn_layer_offset else "mamba"
        ffn = "moe" if i % self.expert_layer_period \
            == self.expert_layer_offset else "mlp"
        return mixer, ffn


def lift_axes(axes: dict, prefix: Tuple[str, ...]) -> dict:
    """A logical-axes tree (nested dicts whose leaves are tuples of axis
    names) with ``prefix`` before every leaf: the axes of the reference's
    stacked ``[L, ...]`` layer leaves."""
    return {k: lift_axes(v, prefix) if isinstance(v, dict)
            else tuple(prefix) + tuple(v) for k, v in axes.items()}


def remat(cfg: ModelConfig, fn: Callable, *args):
    """``fn(*args)``; with ``cfg.remat`` where gradients are taken, under
    ``torch.utils.checkpoint`` (non-reentrant): nothing inside ``fn`` is
    kept for the backward, which runs ``fn`` again (the reference's
    ``jax.checkpoint``).  Bind loop variables into ``fn`` (a partial), as
    the recompute runs after the loop."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_remat_contexts)
    return fn(*args)


def _remat_contexts():
    """Checkpoint's (forward, recompute) contexts: a work counter counts a
    recompute as the forward it repeats (``launch/hlo_cost``)."""
    return contextlib.nullcontext(), hlo_cost.recomputing()


class Params(nn.Module):
    """A node of the parameter tree.  Children are read as ``p["name"]``,
    like the reference's nested dicts, so the layer functions take either
    a module or a plain dict of tensors.  Parameters are held without
    gradients, as serving wants them; :meth:`trainable` turns gradients on
    for training."""

    def __init__(self, **children: Union[torch.Tensor, nn.Module]):
        super().__init__()
        for name, child in children.items():
            if isinstance(child, nn.Module):
                self.add_module(name, child)
            else:
                self.register_parameter(
                    name, nn.Parameter(child, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def trainable(self, flag: bool = True) -> "Params":
        """Set ``requires_grad`` on every parameter of the tree; returns
        the tree."""
        for p in self.parameters():
            p.requires_grad_(flag)
        return self


def param_count(params: nn.Module) -> int:
    return sum(int(p.numel()) for p in params.parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """6*N*D accounting: N = active params (MoE: top-k experts only)."""
    total = param_count_analytic(cfg)
    if not cfg.is_moe:
        return total
    expert_p = 3 * cfg.d_model * cfg.moe_d_ff
    inactive = (cfg.num_experts - cfg.experts_per_token) * expert_p
    moe_layers = cfg.num_layers
    if cfg.family == "jamba":
        moe_layers = sum(cfg.layer_kind(i)[1] == "moe"
                         for i in range(cfg.num_layers))
    return total - moe_layers * inactive


def param_count_analytic(cfg: ModelConfig) -> int:
    """Closed-form parameter count (embedding + per-layer weights)."""
    if cfg.family == "jamba":
        return _jamba_param_count(cfg)
    d, hd = cfg.d_model, cfg.hd
    attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
        + cfg.num_heads * hd * d
    if cfg.is_moe:
        ffn = cfg.num_experts * 3 * d * cfg.moe_d_ff \
            + d * cfg.num_experts          # router
    elif cfg.family == "ssm":
        ffn = 0
        di = d * max(cfg.ssm_expand, 1)
        # mLSTM blocks: qkv + gates + out
        attn = 3 * d * di + 2 * d + di * d
    else:
        ffn = 3 * d * cfg.d_ff
    per_layer = attn + ffn + 2 * d
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    enc = 0
    if cfg.encoder_layers:
        enc = cfg.encoder_layers * (4 * d * d + 2 * d * cfg.d_ff + 2 * d)
        per_layer += 2 * d * d + d * cfg.num_kv_heads * hd * 2  # cross-attn
    return embed + cfg.num_layers * per_layer + enc + d


def _jamba_param_count(cfg: ModelConfig) -> int:
    """The jamba family's count: each layer's mixer (attention or the
    published Mamba mixer) and feed-forward (dense MLP or MoE) by the
    layer-kind keys, two norms a layer, the untied embedding and head, and
    the final norm."""
    d, hd, n, r = cfg.d_model, cfg.hd, cfg.ssm_state, cfg.ssm_dt_rank
    di = d * cfg.ssm_expand
    attn = d * cfg.num_heads * hd * 2 + 2 * d * cfg.num_kv_heads * hd
    mamba = (d * 2 * di + cfg.ssm_conv * di + di * cfg.ssm_conv_bias
             + di * (r + 2 * n) + r + 2 * n + r * di + di + di * n + di
             + di * d)
    mlp = 3 * d * cfg.d_ff
    moe = cfg.num_experts * 3 * d * cfg.moe_d_ff + d * cfg.num_experts
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + d
    for i in range(cfg.num_layers):
        mixer, ffn = cfg.layer_kind(i)
        total += 2 * d + (attn if mixer == "attention" else mamba) \
            + (moe if ffn == "moe" else mlp)
    return total


class MetaDraws:
    """Stands in for a generator on the meta device, where no generator
    can live: parameters built with it have shapes and dtypes only, and
    nothing is drawn or allocated (the dry run's models)."""

    device = torch.device("meta")


def trunc_normal(gen: Union[torch.Generator, MetaDraws], shape,
                 dtype: torch.dtype, scale: float = 1.0) -> torch.Tensor:
    """Standard normal truncated at +-2, times ``scale / sqrt(fan_in)``
    (fan_in = product of all but the last dim), cast to ``dtype`` — the
    reference's initializer.  Draws from ``gen`` on ``gen``'s device; the
    numbers differ from ``jax.random``'s.  On the meta device
    (:class:`MetaDraws`) an empty tensor of the shape and dtype."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    fan_in = shape[0] if len(shape) >= 1 else 1
    if len(shape) >= 2:
        fan_in = 1
        for s in shape[:-1]:
            fan_in *= s
    std = scale / (fan_in ** 0.5)
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (out * std).to(dtype)
