"""train_step / serve_step factories: the reference's ``train/step.py``
on one card.

``grad_sync="fused"`` is the single-card step: the gradients are the
card's own, with nothing to synchronize.  The reference's
``"mare_tree"`` (the paper's K-level tree all-reduce over shards,
optionally int8-compressed) and ``"hierarchical"`` need shards on
several cards and raise until the multi-card backend comes (ROADMAP
Queue 1, item 17).

The step is eager: the loss's ``backward()`` fills each parameter's
``.grad`` (through the flash kernel's backward on the card), the grads
are clipped by global norm, the optimizer turns them into updates and
:func:`~repro_torch.optim.base.apply_updates` adds them to the model's
parameters in place.  Microbatching (gradient accumulation) is a plain
loop over the batch's leading axis, accumulating in f32, where the
reference runs ``lax.scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.models import Model
from repro_torch.optim import (Optimizer, apply_updates, clip_by_global_norm,
                               named_tree)
from repro_torch.optim.compression import init_residual

#: Where the multi-card gradient syncs are ported (ROADMAP.md).
MULTI_CARD_ITEM = "ROADMAP Queue 1, item 17 (torch.distributed backend)"


class TrainState(NamedTuple):
    params: Any              # the model (a Params tree), trained in place
    opt_state: Any
    step: torch.Tensor       # int32, 0-d
    residual: Any = ()       # error-feedback buffer (compression only)


def init_train_state(model: Model, optimizer: Optimizer, rng,
                     compression: bool = False) -> TrainState:
    """The model's seeded parameters with gradients on, the optimizer's
    state over them, step 0."""
    params = model.init(rng).trainable()
    res = init_residual(params) if compression else ()
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32), residual=res)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    grad_sync: str = "fused"            # fused | mare_tree | hierarchical
    tree_depth: int = 2                 # MaRe reduce K
    microbatch: int = 1                 # gradient-accumulation factor
    clip_norm: float = 1.0
    compression: bool = False           # int8 EF (mare_tree only)
    moe_mode: str = "weight_gather"


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    def sp(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    split = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: Model, optimizer: Optimizer,
                    lr_schedule: Callable,
                    step_cfg: StepConfig = StepConfig()):
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    0-d tensors on the model's device: loss, grad_norm, lr and the
    model's own (which name "loss" last, as the reference's)."""
    if step_cfg.grad_sync in ("mare_tree", "hierarchical"):
        raise NotImplementedError(
            f"grad_sync={step_cfg.grad_sync!r} synchronizes gradients "
            f"across shards on several cards; it comes with "
            f"{MULTI_CARD_ITEM}")
    if step_cfg.grad_sync != "fused":
        raise ValueError(step_cfg.grad_sync)

    def loss_and_grads(params, batch):
        named = named_tree(params)
        for p in named.values():
            p.grad = None
        total, metrics = model.loss(params, batch)
        total.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in named.items()}
        for p in named.values():
            p.grad = None
        return grads, total.detach(), _detached(metrics)

    def grads_of(params, batch):
        n = step_cfg.microbatch
        if n > 1:
            acc, l_acc = None, torch.zeros((), dtype=torch.float32)
            for mb in _split_microbatches(batch, n):
                g, loss, _ = loss_and_grads(params, mb)
                g = {k: v.to(torch.float32) for k, v in g.items()}
                acc = g if acc is None else {k: acc[k] + g[k] for k in acc}
                l_acc = l_acc.to(loss.device) + loss
            return {k: v / n for k, v in acc.items()}, l_acc / n, {}
        return loss_and_grads(params, batch)

    def train_step(state: TrainState, batch):
        grads, loss, metrics = grads_of(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, step_cfg.clip_norm)
        lr = lr_schedule(state.step)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params, lr)
        del grads
        apply_updates(state.params, updates)
        out_metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                       **metrics}
        return TrainState(params=state.params, opt_state=opt_state,
                          step=state.step + 1,
                          residual=state.residual), out_metrics

    return train_step


def make_eval_step(model: Model):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics
    return eval_step


def make_serve_steps(model: Model, max_len: int = 2048):
    """(prefill_fn, decode_fn) for batched serving, without gradients."""

    def prefill_fn(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, max_len)

    def decode_fn(params, caches, tokens):
        with torch.no_grad():
            return model.decode_step(params, caches, tokens)

    return prefill_fn, decode_fn
