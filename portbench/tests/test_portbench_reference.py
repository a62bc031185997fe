"""The benchmark's plain references, comparisons and work formula on small
hand-checked cases."""
import numpy as np
import pytest
import torch

from portbench.reference import kmer, snp
from portbench.work import keyed_fold, peaks

# two FASTA lines of 5 bases: "ACGTN" and the soft-masked, short "acgt"
SEQ = np.frombuffer(b"ACGTNacgt", np.uint8)


def test_kmer_bincount_by_hand():
    table = kmer.kmer_bincount(SEQ, 2, 5)
    # AC = 0*4+1, CG = 1*4+2, GT = 2*4+3, each once a line; TN skipped
    want = np.zeros(16, np.int64)
    want[[1, 6, 11]] = 2
    np.testing.assert_array_equal(table, want)
    assert kmer.work(table) == {"windows": 6, "distinct": 3}


def test_kmer_control_drops_soft_masked_windows():
    table = kmer.kmer_bincount(SEQ, 2, 5, fold_case=False)
    want = np.zeros(16, np.int64)
    want[[1, 6, 11]] = 1
    np.testing.assert_array_equal(table, want)


def test_kmer_windows_do_not_span_lines():
    seq = np.frombuffer(b"AAAAC", np.uint8)
    # lines "AAA" and "AC": AAA has two AA windows; "AC" one; "AA|C" none
    table = kmer.kmer_bincount(seq, 2, 3)
    assert table[0] == 2 and table[1] == 1 and table.sum() == 3


def answer(keys, occ, cnt=None):
    keys, occ = np.asarray(keys, np.int32), np.asarray(occ, np.int32)
    return keys, (occ,), occ.copy() if cnt is None else np.asarray(cnt)


@pytest.mark.parametrize("got, want", [
    (answer([1, 6, 11], [2, 2, 2]),
     {"keys_wrong": 0, "keys_repeated": 0, "rows_count_wrong": 0}),
    # a key folded on two shards and never exchanged: sums agree
    (answer([1, 1, 6, 11], [1, 1, 2, 2]),
     {"keys_wrong": 0, "keys_repeated": 1, "rows_count_wrong": 0}),
    (answer([1, 6, 11], [2, 3, 2]),
     {"keys_wrong": 1, "keys_repeated": 0, "rows_count_wrong": 0}),
    (answer([1, 6, 11, 99], [2, 2, 2, 1]),
     {"keys_wrong": 1, "keys_repeated": 0, "rows_count_wrong": 0}),
    (answer([1, 6], [2, 2]),
     {"keys_wrong": 1, "keys_repeated": 0, "rows_count_wrong": 0}),
    (answer([1, 6, 11], [2, 2, 2], [2, 2, 1]),
     {"keys_wrong": 0, "keys_repeated": 0, "rows_count_wrong": 1}),
])
def test_kmer_compare(got, want):
    assert kmer.compare(got, kmer.kmer_bincount(SEQ, 2, 5)) == want


def test_keyed_fold_least_bytes():
    # the two-line genome: 6 (key, count) pairs in, 3 rows out
    table = kmer.kmer_bincount(SEQ, 2, 5)
    w = kmer.work(table)
    assert keyed_fold.least_bytes(w["windows"], w["distinct"]) == \
        8 * 6 + 12 * 3 == 84


def test_peaks():
    assert peaks.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert peaks.peak("cpu", "hbm_bytes_per_s") is None


def test_snp_oracle_chromosomes_and_scores():
    feats = np.stack([np.full(16, 1.0), np.full(16, -1.5),
                      np.full(16, 0.1), np.zeros(16)]).astype(np.float32)
    chrom, score = snp.oracle(feats, rounds=2, chromosomes=24)
    # sums 16, -24, 1.6 (float32, truncated to 1), 0
    np.testing.assert_array_equal(chrom, [16, 0, 1, 0])
    x = feats.astype(np.float64)
    for r in (17, 18):
        x = np.sin(x @ snp.mix(r, 16)) + 0.2 * x
    np.testing.assert_allclose(score, x.sum(-1), rtol=1e-5, atol=1e-5)


def test_snp_oracle_blocks_agree(monkeypatch):
    feats = np.random.default_rng(0).normal(size=(100, 16)).astype(
        np.float32)
    whole = snp.oracle(feats, 4, 24)
    monkeypatch.setattr(snp, "BLOCK", 7)
    blocked = snp.oracle(feats, 4, 24)
    for a, b in zip(whole, blocked):
        np.testing.assert_array_equal(a, b)


def test_shard_of_is_the_ports_partitioner():
    from repro_torch.core.shuffle import hash_keys
    keys = np.concatenate([np.arange(0, 3000), [-1, -7, 2 ** 31 - 1]])
    got = snp.shard_of(keys, 8)
    want = (hash_keys(torch.from_numpy(keys)) % 8).numpy()
    np.testing.assert_array_equal(got, want)


def snp_case():
    chrom = np.array([3, 5, 3, 7, 5, 3], np.int32)
    score = np.array([1.0, -1.0, 2.0, 0.5, 1e-7, 3.0], np.float32)
    ids = np.flatnonzero(score > 0)                   # 0, 2, 3, 4, 5
    key = snp.shard_of(chrom[ids], 4) * 6 + ids
    ids = ids[np.argsort(key, kind="stable")]
    return chrom, score, ids


def test_snp_compare_sound():
    chrom, score, ids = snp_case()
    got = snp.compare((chrom[ids], score[ids], ids), chrom, score, 1e-5, 4)
    assert got == {"score_err": 0.0, "chrom_wrong": 0, "variants_wrong": 0,
                   "ids_repeated": 0, "order_faults": 0}


@pytest.mark.parametrize("fault, name, value", [
    ("score", "score_err", 1e-3),
    ("chrom", "chrom_wrong", 1),
    ("drop", "variants_wrong", 1),
    ("drop_borderline", "variants_wrong", 0),
    ("repeat", "ids_repeated", 1),
    ("read_order", "order_faults", 1),
])
def test_snp_compare_faults(fault, name, value):
    chrom, score, ids = snp_case()
    c, s = chrom[ids].copy(), score[ids].copy()
    if fault == "score":
        s[0] += 1e-3
    elif fault == "chrom":
        c[0] += 1
    elif fault in ("drop", "drop_borderline"):
        keep = ids != (0 if fault == "drop" else 4)
        c, s, ids = c[keep], s[keep], ids[keep]
    elif fault == "repeat":
        c, s, ids = (np.concatenate([a, a[-1:]]) for a in (c, s, ids))
    else:
        c, s, ids = c[::-1], s[::-1], ids[::-1]
    got = snp.compare((c, s, ids), chrom, score, 1e-5, 4)
    assert got[name] >= value if name != "score_err" else \
        got[name] == pytest.approx(value, rel=1e-3)
    if value == 0:
        assert got[name] == 0
