"""Plain reference of the SNP-calling action (paper Listing 3), and its
comparison.

numpy only; it imports nothing of the port.  ``oracle`` is
``chip_smoke.py``'s ``snp_oracle``, copied, in blocks of rows so that
8M reads fit in a few hundred MB.  ``shard_of`` is the hash partitioner
of ``repartition_by`` (the reference package's ``hash_keys``, a
splitmix32-style mix, modulo the shard count), copied so that the order
of the collected variants can be held to what the exchange implies.

The configuration's guarantees (``configs/snp-listing3.json``): every
read is aligned once; a read is a variant where its score is above 0; the
variants of a chromosome are called on one shard; the collected result
is the shards' variants in shard order, each shard's in read order.
"""
from __future__ import annotations

import numpy as np

BLOCK = 1 << 20
MASK32 = np.uint64(0xFFFFFFFF)


def mix(r: int, features: int) -> np.ndarray:
    """Round ``r``'s ``[features, features]`` float32 mixing matrix, as
    ``benchmarks/apps.py`` draws it."""
    rng = np.random.default_rng(r)
    return (rng.normal(size=(features, features)) / np.sqrt(features)
            ).astype(np.float32)


def oracle(feats: np.ndarray, rounds: int, chromosomes: int) -> tuple:
    """(chromosome int32, score float32) of every read: x = sin(x @
    mix(17 + r)) + 0.2 x for ``rounds`` rounds, score = the sum of x;
    chromosome = |int32(feature sum)| % ``chromosomes``, the sum taken
    left to right in float32 (the cast truncates toward zero)."""
    n, f = feats.shape
    mats = [mix(17 + r, f) for r in range(rounds)]
    chrom = np.empty(n, np.int32)
    score = np.empty(n, np.float32)
    for lo in range(0, n, BLOCK):
        x = feats[lo:lo + BLOCK].astype(np.float32)
        s = x[:, 0].copy()
        for j in range(1, f):
            s += x[:, j]
        chrom[lo:lo + BLOCK] = np.abs(s.astype(np.int32)) % chromosomes
        for m in mats:
            x = np.sin(x @ m) + np.float32(0.2) * x
        score[lo:lo + BLOCK] = x.sum(axis=-1)
    return chrom, score


def shard_of(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """The shard ``repartition_by`` sends each key to."""
    x = np.asarray(keys).astype(np.int64).astype(np.uint64) & MASK32
    x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)) & MASK32
    x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)) & MASK32
    x = x ^ (x >> np.uint64(16))
    return (x % np.uint64(num_shards)).astype(np.int64)


def compare(answer, chrom_ref: np.ndarray, score_ref: np.ndarray,
            score_limit: float, num_shards: int) -> dict:
    """The numbers that decide ``correct`` for one collected answer
    ``(chromosome, score, read id)``:

    - ``score_err``: the largest |score - reference score| of a variant;
    - ``chrom_wrong``: variants whose chromosome differs from the
      reference's (both sum the same float32 features in the same order,
      so they agree bit for bit), plus ids outside the reads;
    - ``variants_wrong``: reads that are a variant on one side only,
      leaving out those whose reference score lies within
      ``score_limit`` of 0;
    - ``ids_repeated``: read ids collected more than once;
    - ``order_faults``: neighbours out of (shard of the chromosome, read
      id) order.
    """
    chrom, score, ids = (np.asarray(a) for a in answer)
    n = chrom_ref.shape[0]
    ids = ids.astype(np.int64)
    inside = (ids >= 0) & (ids < n)
    got_ids = ids[inside]
    err = np.abs(score[inside].astype(np.float64)
                 - score_ref[got_ids].astype(np.float64))
    seen = np.bincount(got_ids, minlength=n)
    border = np.abs(score_ref) <= score_limit
    key = shard_of(chrom, num_shards) * n + ids
    return {"score_err": float(err.max(initial=0.0)),
            "chrom_wrong": int((chrom[inside] != chrom_ref[got_ids]).sum()
                               + (~inside).sum()),
            "variants_wrong": int(((seen > 0) != (score_ref > 0))
                                  [~border].sum()),
            "ids_repeated": int((seen > 1).sum()),
            "order_faults": int((np.diff(key) < 0).sum())}
