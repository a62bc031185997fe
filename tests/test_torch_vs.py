"""The paper's virtual-screening pipeline (Listing 2) through the port
against the reference's, on the same library.

The reference's pipeline is ``benchmarks/apps.py:virtual_screening``
(its ``MaRe`` and its ``tools/fred``); the port's is ``chip_smoke.py``'s
``virtual_screening`` (the port's ``MaRe``, a ``tools/fred`` twin and the
port's ``toolbox/topk``), at 1 and 8 logical shards on the CPU.  The 30
molecule ids are equal in order; the scores to 1e-6 (the surrogate's
float32 matmuls and tanh in two libraries).
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs
from benchmarks import apps as R_apps
from repro_torch.kernels.topk_reduce import kernel as tmod

N = 2000


@pytest.fixture(scope="module")
def reference():
    library = R_apps.make_library(N, seed=7)
    scores, ids = R_apps.virtual_screening(library, top=30)
    return library, np.asarray(scores), np.asarray(ids)


def test_library_and_mix_match_reference(reference):
    library = reference[0]
    ours = cs.make_library(N, seed=7)
    for a, b in zip(library, ours):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for r in range(cs.VS_ROUNDS):
        np.testing.assert_array_equal(
            cs.fred_mix(r).numpy(),
            np.asarray(R_apps._mix(cs.FEATURES, r)))


@pytest.mark.parametrize("shards", [1, 8])
def test_pipeline_matches_reference(reference, shards):
    library, want_scores, want_ids = reference
    chain = cs.virtual_screening(library, num_shards=shards, device="cpu")
    before = tmod.LAUNCHES
    scores, ids = chain.collect(shard=0)
    assert tmod.LAUNCHES == before          # CPU: the plain version
    assert scores.dtype == np.float32 and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-6)
    # and the reference's single-core oracle
    o_scores, o_ids = R_apps.vs_reference(library, top=30)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(scores, o_scores, rtol=0, atol=1e-6)


def test_shard_count_does_not_change_the_records():
    library = cs.make_library(N, seed=3)
    one = cs.virtual_screening(library, 1, "cpu").collect(shard=0)
    eight = cs.virtual_screening(library, 8, "cpu").collect(shard=0)
    for a, b in zip(one, eight):
        np.testing.assert_array_equal(a, b)
    assert list(one[0]) == sorted(one[0], reverse=True)


@pytest.mark.parametrize("shards,depth,calls", [
    (8, 2, 8 + 4 + 1), (8, 1, 8 + 1), (8, 3, 8 + 4 + 2 + 1), (1, 2, 1),
    (6, 2, None)])
def test_topk_combines_counts_the_tree(monkeypatch, shards, depth, calls):
    """The count chip_smoke.py holds the kernel's launches to: one
    toolbox/topk combine per shard and per group leader at each level of
    the tree, as the pipeline really calls it."""
    from repro_torch.core import images
    seen = []

    def counting(*args, **kw):
        seen.append(1)
        return topk_reduce(*args, **kw)

    topk_reduce = images.topk_reduce
    monkeypatch.setattr(images, "topk_reduce", counting)
    library = cs.make_library(200, seed=1)
    cs.virtual_screening(library, shards, "cpu", depth=depth).collect(
        shard=0)
    assert len(seen) == cs.topk_combines(shards, depth)
    if calls is not None:
        assert len(seen) == calls
