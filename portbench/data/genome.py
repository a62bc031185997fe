"""A seeded synthetic chromosome and its FASTA file.

Copied from ``chip_smoke.py`` (``make_genome``, ``write_fasta``) so that
a later change there cannot move the benchmark's inputs.
"""
from __future__ import annotations

import numpy as np


def make_genome(n: int, seed: int, n_fraction: float = 0.01,
                softmask_fraction: float = 0.05) -> np.ndarray:
    """``n`` random ACGT bases with about ``n_fraction`` of them in N runs
    and ``softmask_fraction`` in soft-masked (lowercase) runs of 1,000 to
    20,000 bases, as uint8 bytes."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    for code, frac in ((ord("N"), n_fraction), (None, softmask_fraction)):
        target = int(n * frac)
        while target > 0:
            length = min(int(rng.integers(1000, 20000)), target)
            start = int(rng.integers(0, n - length))
            if code is None:
                seq[start:start + length] |= 0x20      # to lowercase
            else:
                seq[start:start + length] = code
            target -= length
    return seq


def write_fasta(path: str, seq: np.ndarray, line: int) -> None:
    """One record, ``line`` bases a line, Ensembl's chromosome header."""
    full = len(seq) // line
    body = np.empty((full, line + 1), np.uint8)
    body[:, :line] = seq[:full * line].reshape(full, line)
    body[:, line] = ord("\n")
    with open(path, "wb") as f:
        f.write(f">21 dna:chromosome chromosome:GRCh38:21:1:{len(seq)}:1 "
                f"REF\n".encode())
        f.write(body.tobytes())
        tail = seq[full * line:]
        if tail.size:
            f.write(tail.tobytes() + b"\n")
