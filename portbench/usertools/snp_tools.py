"""The SNP-calling user's tools, ``tools/bwa`` and ``tools/gatk``.

They stand in for the containers of the paper's Listing 3 (BWA, GATK's
HaplotypeCaller) as the JAX package's ``benchmarks/apps.py`` defines
them, and are copied from ``chip_smoke.py``.  They are the user's code,
not MaRe's: the benchmark keeps them, in plain torch, and registers them
into the port's registry through ``container_op``, so no change to the
program can speed up the user's tool.  The mixing matrices go to the
device once per device, as a real tool loads its model once.
"""
from __future__ import annotations

import numpy as np
import torch

_MIX: dict = {}


def mix(r: int, features: int, device) -> torch.Tensor:
    """Round ``r``'s ``[features, features]`` float32 mixing matrix, as
    ``benchmarks/apps.py`` draws it, on ``device``."""
    key = (r, features, str(device))
    if key not in _MIX:
        rng = np.random.default_rng(r)
        m = (rng.normal(size=(features, features)) / np.sqrt(features)
             ).astype(np.float32)
        _MIX[key] = torch.from_numpy(m).to(device)
    return _MIX[key]


def feature_sum(reads: torch.Tensor) -> torch.Tensor:
    """The float32 sum of a read's features taken left to right."""
    s = reads[:, 0].float()
    for j in range(1, reads.shape[1]):
        s = s + reads[:, j].float()
    return s


def bwa_align(reads: torch.Tensor, rounds: int, chromosomes: int) -> tuple:
    """(chromosome, score) of each read: x = sin(x @ mix(17 + r)) + 0.2 x
    for ``rounds`` rounds, score = the sum of x; chromosome =
    |int32(feature sum)| % ``chromosomes``."""
    x = reads.float()
    for r in range(rounds):
        x = torch.sin(x @ mix(17 + r, reads.shape[1], x.device)) + 0.2 * x
    chrom = torch.abs(feature_sum(reads).to(torch.int32)) % chromosomes
    return chrom, torch.sum(x, dim=-1)


def register(chromosomes: int) -> None:
    """Register both tools in the port's default registry, once."""
    from repro_torch.core.container import (DEFAULT_REGISTRY, container_op,
                                            make_partition)
    if "tools/bwa:latest" in DEFAULT_REGISTRY.images():
        return

    @container_op("tools/bwa", registry=DEFAULT_REGISTRY)
    def bwa(part, command: str = "", rounds: int = 4, **kw):
        reads, read_id = part.records
        chrom, score = bwa_align(reads, rounds, chromosomes)
        return make_partition((chrom, score, read_id), part.count)

    @container_op("tools/gatk", registry=DEFAULT_REGISTRY)
    def gatk(part, command: str = "", **kw):
        chrom, score, read_id = part.records
        is_var = (score > 0.0) & part.mask()
        # variants first, each group in read order (a stable sort)
        order = torch.sort((~is_var).to(torch.uint8), stable=True).indices
        return make_partition(tuple(a[order] for a in (chrom, score,
                                                       read_id)),
                              is_var.sum())


def chromosome(recs):
    """``repartition_by``'s key: the chromosome.  Module-level, so that the
    plan cache keys on one callable across actions."""
    return recs[0]
