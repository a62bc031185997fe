"""Seeded sequencing reads, made where they are used.

A read is 16 float32 features and an int32 id, as the paper's SNP
application stands in for them (``benchmarks/apps.py``).  The features
are standard normal draws from a ``torch.Generator`` on ``device``, in one
call, so the same seed gives the same bits on the card every time; the
reference draws them again after the window the same way.
"""
from __future__ import annotations

import torch


def make_reads(n: int, features: int, seed: int, device) -> tuple:
    """(``[n, features]`` float32 features, ``[n]`` int32 ids)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    feats = torch.randn((n, features), generator=g, device=device,
                        dtype=torch.float32)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    return feats, ids
