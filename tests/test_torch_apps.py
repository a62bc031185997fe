"""The paper's SNP-calling pipeline (Listing 3) through the port against
the reference's, on the same reads.

The reference's pipeline is ``benchmarks/apps.py:snp_calling`` (its
``MaRe``, ``tools/bwa``, ``tools/gatk`` and ``toolbox/concat``); the
port's is ``chip_smoke.py``'s ``snp_calling`` (the port's ``MaRe``, the
two tools' twins and the port's ``toolbox/concat``), over 8,192 reads at 1
shard in this process and at 8 shards against the reference on 8 devices
in a subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``).
Chromosomes, read ids, the variant count and the exchange's drop counter
are equal bit for bit and in order; the scores to 1e-5 (the surrogate's
float32 matmuls and sin in two libraries, on |score| < 20).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs
from benchmarks import apps as R_apps
from repro.runtime.executor import DEFAULT_EXECUTOR as R_EXECUTOR

N = 8192
SEED = 3            # examples/snp_calling.py's library
SCORE_TOL = 1e-5

REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    from benchmarks import apps
    from repro.runtime.executor import DEFAULT_EXECUTOR
    assert jax.device_count() == 8
    out = apps.snp_calling(apps.make_library(int(sys.argv[3]), seed=3))
    np.savez(sys.argv[2], *[np.asarray(a) for a in out])
    with open(sys.argv[2] + ".json", "w") as f:
        json.dump(DEFAULT_EXECUTOR.reports.latest.diagnostics, f)
    print("OK")
""")


def _reference(shards, tmp_path):
    """(chrom, score, read_id) and the drop counters of the reference's
    snp_calling over ``shards`` devices."""
    library = R_apps.make_library(N, seed=SEED)
    if shards == 1:
        out = R_apps.snp_calling(library)
        return ([np.asarray(a) for a in out],
                dict(R_EXECUTOR.reports.latest.diagnostics))
    path = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(
        os.path.join(ROOT, "src")), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, os.path.abspath(ROOT), path,
         str(N)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-4000:]
    ref = np.load(path)
    return ([ref[f"arr_{i}"] for i in range(3)],
            json.load(open(path + ".json")))


def test_library_and_mix_match_reference():
    for a, b in zip(R_apps.make_library(N, seed=SEED),
                    cs.make_library(N, SEED)):
        np.testing.assert_array_equal(a, b)
    for r in range(cs.SNP_ROUNDS):
        np.testing.assert_array_equal(
            cs.fred_mix(17 + r).numpy(),
            np.asarray(R_apps._mix(cs.FEATURES, 17 + r)))


def test_feature_sum_is_left_to_right_like_the_reference():
    """The chromosome rule's float32 sum, in the reference's order, over
    many reads: every sum equal bit for bit to ``jnp.sum``'s."""
    import jax.numpy as jnp
    feats = np.random.default_rng(0).normal(size=(200_000, 16)).astype(
        np.float32) * 4
    want = np.asarray(jnp.sum(jnp.asarray(feats), axis=-1))
    got = cs.feature_sum(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    chrom, _ = cs.bwa_align(torch.from_numpy(feats))
    want_c = np.abs(want.astype(np.int32)) % cs.N_CHROMOSOMES
    np.testing.assert_array_equal(chrom.numpy(), want_c)


@pytest.mark.parametrize("shards", [1, 8])
def test_pipeline_matches_reference(shards, tmp_path):
    (r_chrom, r_score, r_id), r_diag = _reference(shards, tmp_path)
    chain = cs.snp_calling(cs.make_library(N, SEED), num_shards=shards,
                           device="cpu")
    chrom, score, read_id = chain.collect(shard=0)
    assert (chrom.dtype, score.dtype, read_id.dtype) == \
        (np.int32, np.float32, np.int32)
    assert len(read_id) == len(r_id) > N // 4
    np.testing.assert_array_equal(chrom, r_chrom)
    np.testing.assert_array_equal(read_id, r_id)
    np.testing.assert_allclose(score, r_score, rtol=0, atol=SCORE_TOL)
    assert (score > 0).all()
    assert chain.report().diagnostics == r_diag == \
        {"stage1.shuffle_dropped": 0}


def test_shard_count_keeps_the_variants_and_groups_chromosomes():
    """1 and 8 shards call the same variants; at 8 each chromosome lands
    on one shard of the exchange, every read once."""
    library = cs.make_library(2000, 5)
    one = cs.snp_calling(library, 1, "cpu").collect(shard=0)
    eight = cs.snp_calling(library, 8, "cpu").collect(shard=0)
    order = [np.argsort(o[2]) for o in (one, eight)]
    for a, b in zip(one, eight):
        np.testing.assert_array_equal(a[order[0]], b[order[1]])
    from repro_torch.core import MaRe
    cs.register_snp_images()
    ex = MaRe(library, num_shards=8, device="cpu").map(
        image="tools/bwa").repartition_by(cs.snp_chromosome).dataset
    cap, counts = ex.capacity, ex.counts.tolist()
    owner, ids = {}, []
    for s, c in enumerate(counts):
        ids.append(ex.records[2][s * cap:s * cap + c].numpy())
        for ch in np.unique(ex.records[0][s * cap:s * cap + c].numpy()):
            assert owner.setdefault(int(ch), s) == s
    np.testing.assert_array_equal(np.sort(np.concatenate(ids)),
                                  np.arange(2000))


def test_oracle_agrees_with_the_pipeline():
    """chip_smoke.py's numpy oracle (the check on the card) over the
    same reads: the pipeline's variants are its reads with score > 0."""
    library = cs.make_library(4096, SEED)
    chrom, score, read_id = cs.snp_calling(library, 8, "cpu").collect(
        shard=0)
    o_chrom, o_score, frac = cs.snp_oracle(library[0])
    np.testing.assert_array_equal(o_chrom[read_id], chrom)
    np.testing.assert_allclose(o_score[read_id], score, rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(np.sort(read_id),
                                  np.flatnonzero(o_score > 0))
    assert frac.shape == (4096,) and (frac <= 0.5).all()
