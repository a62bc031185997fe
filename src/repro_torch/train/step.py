"""train_step / serve_step factories: the reference's ``train/step.py``.

Gradient synchronization is a first-class MaRe feature:

* ``grad_sync="fused"`` — the step over the whole batch, under the
  mesh's rules when one is given (so an MoE model takes its
  expert-parallel path): the reference's XLA-partitioned step.
* ``grad_sync="mare_tree"`` — paper-faithful: each shard of the mesh's
  batch axes (``pod``, ``data``) takes its slice of the batch and
  computes its gradients with ``backward()`` on the shared parameters;
  the shards' copies are combined with the K-level tree all-reduce
  (``core/tree_reduce.tree_allreduce``, default K=2) over each batch axis,
  innermost first, and divided by the shard count, exactly like the
  paper's reduce primitive.  Optionally each shard's gradients pass the
  int8 error-feedback codec first (``compression``).
* ``grad_sync="hierarchical"`` — the paper's K=2 tree at mesh
  granularity: the shards' gradients summed over ``data``, then over
  ``pod`` (``hierarchical_allreduce``), then divided by the shard count.
  The reference leaves this reduce to XLA's partitioner; the port runs
  it.  Without a mesh it is the fused step.

The shards of a mesh run one after another on one device
(``core/collectives.py``), each freeing its activations before the next
starts; the parameters are one copy, and the reduced gradients are
applied to it once.  Loss and metrics are the mean over the shards
(``pmean``); they and the gradients equal the fused step's up to
rounding whenever every shard holds as many loss tokens.

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
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.core import collectives
from repro_torch.core.collectives import Mesh
from repro_torch.core.tree_reduce import (hierarchical_allreduce,
                                          tree_allreduce)
from repro_torch.models import Model
from repro_torch.optim import (Optimizer, apply_updates, clip_by_global_norm,
                               named_tree)
from repro_torch.optim.compression import (error_feedback_compress,
                                           init_residual)
from repro_torch.sharding import Rules, use_rules

#: The shard whose error-feedback residual a ``mare_tree`` step keeps:
#: the reference returns its state replicated without checking it
#: (``out_specs=P()``, ``check_vma=False``), which hands back the first
#: device's copy.
RESIDUAL_SHARD = 0


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


def _batch_shards(batch: Dict[str, torch.Tensor], mesh: Mesh
                  ) -> List[Dict[str, torch.Tensor]]:
    """Each shard's slice of the batch's leading axis, split over all of
    ``mesh``'s axes (the reference's ``P(batch_axes)``)."""
    spec = (tuple(mesh.axis_names),)
    per_key = {k: collectives.shard(v, mesh, spec) for k, v in batch.items()}
    return [{k: v[s] for k, v in per_key.items()} for s in range(mesh.size)]


def _mean(xs: List[Any], mesh: Mesh) -> Any:
    """``pmean`` over every axis of ``mesh``: the shards' ordered sum over
    their count, once."""
    return collectives.pmean(xs, mesh, tuple(mesh.axis_names))[0]


def make_train_step(model: Model, optimizer: Optimizer,
                    lr_schedule: Callable,
                    step_cfg: StepConfig = StepConfig(),
                    mesh: Optional[Mesh] = None,
                    rules: Optional[Rules] = None):
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    0-d tensors on the model's device: loss, grad_norm, lr and the
    model's own (which name "loss" last, as the reference's)."""
    if step_cfg.grad_sync not in ("fused", "mare_tree", "hierarchical"):
        raise ValueError(step_cfg.grad_sync)
    if step_cfg.grad_sync == "mare_tree" and mesh is None:
        raise ValueError("grad_sync='mare_tree' needs a mesh")

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

    def apply(state: TrainState, grads, loss, metrics):
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

    batch_axes = tuple(a for a in ("pod", "data")
                       if mesh is not None and a in mesh.shape)
    if step_cfg.grad_sync == "fused" or not batch_axes:
        def train_step(state: TrainState, batch):
            with use_rules(rules, mesh):
                grads, loss, metrics = grads_of(state.params, batch)
            return apply(state, grads, loss, metrics)
        return train_step

    sub = mesh.submesh(batch_axes)   # model-axis replicas compute alike

    def sync(grads: List[Any]) -> Any:
        if step_cfg.grad_sync == "hierarchical":
            if len(batch_axes) == 2:
                grads = hierarchical_allreduce(grads, sub, "data", "pod")
            else:
                grads = collectives.psum(grads, sub, batch_axes[0])
        else:
            # K-level MaRe reduce per batch axis (innermost first: the
            # paper's intra-node-then-cross-node tree)
            for ax in reversed(batch_axes):
                grads = tree_allreduce(grads, sub, ax,
                                       depth=step_cfg.tree_depth)
        return {k: g / sub.size for k, g in grads[0].items()}

    def train_step(state: TrainState, batch):
        grads, losses, metrics = [], [], []
        residual = state.residual
        for s, b in enumerate(_batch_shards(batch, sub)):
            g, loss, m = grads_of(state.params, b)
            if step_cfg.compression and step_cfg.grad_sync == "mare_tree":
                _, g, r = error_feedback_compress(g, state.residual)
                if s == RESIDUAL_SHARD:
                    residual = r
                del r
            grads.append(g)
            losses.append(loss)
            metrics.append(m)
            del g
        grads = sync(grads)
        state = state._replace(residual=residual)
        return apply(state, grads, _mean(losses, sub), _mean(metrics, sub))

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
