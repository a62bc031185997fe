"""Global-norm gradient clipping (the reference's ``optim/clip.py``)."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.tree import leaves, tree_map


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32."""
    sq = [torch.sum(x.to(torch.float32) ** 2) for x in leaves(tree)]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), norm
