"""Plain reference of the k-mer statistics action, and its comparison.

``kmer_bincount`` is copied from ``chip_smoke.py``: numpy only, over the
bases the benchmark made.  It imports nothing of the port.

The configuration's guarantees (``configs/grch38-chr21.json``): every
window of k bases inside one FASTA line whose bases are all A, C, G or T,
in either case, is counted exactly once under its 2-bit key (A=0 C=1 G=2
T=3, first base most significant); each key is one row of the result,
with its occurrences equal to its record count.
"""
from __future__ import annotations

import numpy as np


def kmer_bincount(seq: np.ndarray, k: int, line: int,
                  fold_case: bool = True) -> np.ndarray:
    """Exact k-mer occurrence table ``[4**k]`` int64 of the FASTA's lines
    (k-mers do not span lines; windows with a non-ACGT base are skipped).
    ``fold_case=False`` counts only upper-case windows: the control, which
    breaks the guarantee that soft-masked bases count as their bases."""
    n_lines = -(-len(seq) // line)
    lines = np.zeros((n_lines, line), np.uint8)
    lines.reshape(-1)[:len(seq)] = seq
    lens = np.full(n_lines, line)
    lens[-1] = len(seq) - (n_lines - 1) * line
    upper = (np.where((lines >= 97) & (lines <= 122), lines - 32, lines)
             if fold_case else lines)
    code = np.zeros(256, np.int64)
    ok = np.zeros(256, bool)
    for i, b in enumerate(b"ACGT"):
        code[b], ok[b] = i, True
    c, o = code[upper], ok[upper]
    nw = line - k + 1
    acc = np.zeros((n_lines, nw), np.int64)
    win = np.ones((n_lines, nw), bool)
    for j in range(k):
        acc = acc * 4 + c[:, j:j + nw]
        win &= o[:, j:j + nw]
    win &= (np.arange(nw)[None, :] + k) <= lens[:, None]
    return np.bincount(acc[win], minlength=4 ** k)


def compare(answer, table: np.ndarray) -> dict:
    """The numbers that decide ``correct`` for one collected answer
    ``(keys, (occurrences,), counts)`` against the reference table:

    - ``keys_wrong``: keys whose summed occurrences differ from the table,
      plus rows whose key lies outside ``[0, 4**k)``;
    - ``keys_repeated``: keys that appear on more than one row (a fold or
      an exchange left undone shows here even where the sums agree);
    - ``rows_count_wrong``: rows whose occurrences differ from their
      record count.
    """
    keys, (occ,), cnt = answer
    keys = np.asarray(keys).astype(np.int64)
    occ = np.asarray(occ).astype(np.int64)
    cnt = np.asarray(cnt).astype(np.int64)
    size = table.shape[0]
    inside = (keys >= 0) & (keys < size)
    # float64 sums are exact far beyond any count a genome gives
    got = np.bincount(keys[inside], weights=occ[inside], minlength=size)
    rows = np.bincount(keys[inside], minlength=size)
    return {"keys_wrong": int((got != table).sum() + (~inside).sum()),
            "keys_repeated": int((rows > 1).sum()),
            "rows_count_wrong": int((occ != cnt).sum())}


def work(table: np.ndarray) -> dict:
    """What the keyed fold has to do for this data: the valid windows and
    the distinct keys among them."""
    return {"windows": int(table.sum()), "distinct": int((table > 0).sum())}
