"""Minimal functional optimizer interface (optax-style): the reference's
``optim/base.py`` over the port's parameter trees.

A parameter tree is a plain dict of tensors, or a model
(:class:`~repro_torch.models.common.Params`), which :func:`named_tree`
reads as the dict of its parameters by dotted name (``blocks.3.attn.wq``).
Gradients, updates and optimizer moments are dicts with the same keys.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch
from torch import nn

from repro_torch.core.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]                    # params -> state
    update: Callable[..., Any]                    # (grads, state, params,
    #                                                lr) -> (updates, state)


def named_tree(params: Any) -> Dict[str, torch.Tensor]:
    """A model's parameters by dotted name; a dict of tensors as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def apply_updates(params: Any, updates: Any) -> Any:
    """``p + u`` in ``p``'s dtype (``u`` cast to it first), as the
    reference's; the port adds in place, into the tree's own tensors, and
    returns the tree."""
    named = named_tree(params)
    with torch.no_grad():
        for k, p in named.items():
            p.add_(updates[k].to(p.dtype))
    return params


def cast_state(tree: Any, dtype) -> Any:
    return tree_map(lambda x: x.to(dtype), tree)
