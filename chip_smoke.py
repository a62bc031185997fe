#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU, at chromosome scale.

    python3 chip_smoke.py [--seed 0]

Drives ``repro_torch`` through its public entry points on a synthetic
genome the size of GRCh38 chr21 (46,709,983 bases, FASTA with 60-base
lines, ~1% of bases in N runs), split into 8 logical shards:

1. build the CUDA segment-sum kernel from ``src/repro_torch/csrc``;
2. hold the kernel against its plain PyTorch version on the card, at the
   shapes the k-mer path gives it (combiner and merge) and on edge cases,
   and time kernel, plain version and ``index_add_`` with CUDA events;
3. GC count (the paper's Listing 1: ``grep-chars GC`` -> ``awk-sum``)
   against an exact numpy count;
4. k-mer statistics (``kmer-stats`` k=12 -> ``reduce_by_key`` sum) against
   a numpy ``bincount``, with the kernel's launch counter read around it;
5. the card's name and power limit.

Every phase prints its wall time; the first failure exits non-zero.  The
last lines are a JSON object describing the kernel, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.  Without a CUDA device (or
without the repository's ``src/`` beside it) the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

CHR21_BASES = 46_709_983       # GRCh38 chromosome 21, Ensembl release
LINE = 60                      # Ensembl FASTA line width
K = 12
NUM_SHARDS = 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
REPLACES = "src/repro/kernels/segment_reduce/kernel.py:105"
SOURCE = "src/repro_torch/csrc/segment_sum.cu"


def phase(name: str, t0: float, extra: str = "") -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s"
          + (f"  {extra}" if extra else ""), flush=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_genome(n: int, seed: int) -> np.ndarray:
    """Random ACGT bases with ~1% in N runs and ~5% soft-masked
    (lowercase) runs, as uint8 bytes."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    for code, frac in ((ord("N"), 0.01), (None, 0.05)):
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


def write_fasta(path: str, seq: np.ndarray) -> None:
    full = len(seq) // LINE
    body = np.empty((full, LINE + 1), np.uint8)
    body[:, :LINE] = seq[:full * LINE].reshape(full, LINE)
    body[:, LINE] = ord("\n")
    with open(path, "wb") as f:
        f.write(f">21 dna:chromosome chromosome:GRCh38:21:1:{len(seq)}:1 "
                f"REF\n".encode())
        f.write(body.tobytes())
        tail = seq[full * LINE:]
        if tail.size:
            f.write(tail.tobytes() + b"\n")


def kmer_bincount(seq: np.ndarray, k: int) -> np.ndarray:
    """Exact k-mer occurrence table of the FASTA's lines (k-mers do not
    span lines; windows with a non-ACGT base are skipped)."""
    n_lines = -(-len(seq) // LINE)
    lines = np.zeros((n_lines, LINE), np.uint8)
    lines.reshape(-1)[:len(seq)] = seq
    lens = np.full(n_lines, LINE)
    lens[-1] = len(seq) - (n_lines - 1) * LINE
    upper = np.where((lines >= 97) & (lines <= 122), lines - 32, lines)
    code = np.zeros(256, np.int64)
    ok = np.zeros(256, bool)
    for i, b in enumerate(b"ACGT"):
        code[b], ok[b] = i, True
    c, o = code[upper], ok[upper]
    nw = LINE - k + 1
    acc = np.zeros((n_lines, nw), np.int64)
    win = np.ones((n_lines, nw), bool)
    for j in range(k):
        acc = acc * 4 + c[:, j:j + nw]
        win &= o[:, j:j + nw]
    win &= (np.arange(nw)[None, :] + k) <= lens[:, None]
    return np.bincount(acc[win], minlength=4 ** k)


# ---------------------------------------------------------------------------
# kernel check and timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kern, plain, atol: float = 0.0) -> float:
    """Max abs error between kernel and plain outputs; raises on
    disagreement.  Integer outputs must be equal.  A float32 table is
    held to the plain version taken in float64 with rtol 1e-5 and
    ``atol`` (tied to the inputs by the caller)."""
    import torch
    err = 0.0
    for a, b in zip(kern, plain):
        floats = a.dtype == torch.float32 and b.dtype == torch.float64
        if a.shape != b.shape or (a.dtype != b.dtype and not floats):
            raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
        if floats:
            if not torch.allclose(a.double(), b, rtol=1e-5, atol=atol):
                raise AssertionError(f"{name}: kernel !~ plain version")
        elif not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel != plain version")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def bound_ms(n: int, n_valid: int, d: int, num_keys: int) -> float:
    """Least time for the work on these inputs: every valid flag (1 B)
    read, the key (4 B) and values (d * 4 B) of each valid record read
    once, each output byte written once (table, counts, overflow), over
    HBM bandwidth.  The n_valid * (d + 1) adds take far less time at any
    peak rate, so bytes bound it."""
    nbytes = n + n_valid * (4 + 4 * d) + num_keys * (4 * d + 4) + 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_kernel(keys, vals, valid, num_keys):
    """ms of kernel, plain version and one ``index_add_`` call (the
    library yardstick: pre-masked sentinel keys, counts as an extra
    column), same inputs."""
    import torch
    from repro_torch.kernels.segment_reduce.kernel import segment_sum
    from repro_torch.kernels.segment_reduce.ref import segment_sum_ref
    n, d = vals.shape
    ms = cuda_ms(lambda: segment_sum(keys, vals, num_keys, valid))
    plain = cuda_ms(lambda: segment_sum_ref(keys, vals, num_keys, valid))
    idx = torch.where(valid & (keys >= 0) & (keys < num_keys), keys,
                      num_keys).long()
    aug = torch.cat([vals, torch.ones((n, 1), dtype=vals.dtype,
                                      device=vals.device)], dim=1)
    table = torch.zeros((num_keys + 1, d + 1), dtype=vals.dtype,
                        device=vals.device)
    lib = cuda_ms(lambda: table.index_add_(0, idx, aug))
    return ms, plain, lib


def kernel_phase(ds, cap2: int):
    """Kernel vs plain version on the card at the k-mer path's shapes,
    plus edge cases; returns the JSON record for the combiner shape."""
    import torch
    from repro_torch.core import images
    from repro_torch.kernels.segment_reduce import kernel as kmod
    from repro_torch.kernels.segment_reduce.ref import segment_sum_ref
    seg = kmod.segment_sum
    dev = ds.device
    g = torch.Generator(device=dev).manual_seed(1)
    num_keys = 4 ** K
    # combiner input: the real kmer-stats output of shard 0
    part = images.kmer_stats(k=K)(ds.shard(0))
    ckeys, cones = part.records
    cvalid = part.mask()
    cvals = cones.reshape(-1, 1).contiguous()
    n_c = ckeys.shape[0]
    # merge input: 8 received buckets of (key, value, count) partials
    n_m = NUM_SHARDS * cap2
    mkeys = torch.randint(0, num_keys, (n_m,), device=dev,
                          dtype=torch.int32, generator=g)
    mvals = torch.randint(1, 50, (n_m, 2), device=dev, dtype=torch.int32,
                          generator=g)
    mvalid = torch.rand(n_m, device=dev, generator=g) < 0.95
    cases = [
        ("combiner", ckeys, cvals, cvalid, num_keys),
        ("merge d=2", mkeys, mvals, mvalid, num_keys),
        ("merge d=1", mkeys, mvals[:, :1].contiguous(), mvalid, num_keys),
    ]
    n_e = 1 << 20
    ekeys = torch.randint(-5, 1000008, (n_e,), device=dev,
                          dtype=torch.int32, generator=g)
    evals = torch.randint(-100, 100, (n_e, 3), device=dev,
                          dtype=torch.int32, generator=g)
    evalid = torch.rand(n_e, device=dev, generator=g) < 0.7
    fvals = torch.randn((n_e, 3), device=dev, generator=g)
    fvals[~evalid] = float("nan")      # padding may hold NaN
    cases += [
        ("out-of-range keys, odd num_keys", ekeys, evals, evalid, 1000003),
        ("float32", ekeys, fvals, evalid, 1000003),
        ("all masked", ekeys, evals, torch.zeros_like(evalid), 1000003),
        ("one hot key", torch.full((n_c,), 12345, device=dev,
                                   dtype=torch.int32), cvals, cvalid,
         num_keys),
        ("n=0", ekeys[:0], evals[:0], evalid[:0], 1000003),
    ]
    errs = {}
    for name, keys, vals, valid, nk in cases:
        t0 = time.perf_counter()
        before = kmod.LAUNCHES
        got = seg(keys, vals, nk, valid)
        torch.cuda.synchronize()
        launched = kmod.LAUNCHES - before
        atol = 0.0
        if vals.dtype == torch.float32:
            # plain version in float64; the atomics add in another order,
            # so allow 1e-6 x (largest per-key count) x max |valid value|
            want = segment_sum_ref(keys, vals.double(), nk, valid)
            atol = (1e-6 * int(want[1].max())
                    * float(vals[valid].abs().max()))
        else:
            want = segment_sum_ref(keys, vals, nk, valid)
        errs[name] = compare(name, got, want, atol)
        expect = 0 if keys.shape[0] == 0 else 1
        if launched != expect:
            raise AssertionError(f"{name}: {launched} launches, expected "
                                 f"{expect}")
        phase(f"kernel check {name}", t0,
              f"n={keys.shape[0]} d={vals.shape[1]} num_keys={nk} "
              f"max_abs_err={errs[name]} atol={atol} "
              f"overflow={int(got[2][0])}")
    timings = {}
    for name, keys, vals, valid, nk in (
            ("combiner", ckeys, cvals, cvalid, num_keys),
            ("merge d=2", mkeys, mvals, mvalid, num_keys)):
        t0 = time.perf_counter()
        ms, plain, lib = time_kernel(keys, vals, valid, nk)
        n, d = vals.shape
        bnd = bound_ms(n, int(valid.sum()), d, nk)
        timings[name] = (ms, plain, lib, bnd)
        phase(f"kernel timing {name}", t0,
              f"n={n} d={d} num_keys={nk} kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} index_add_ms={lib:.4f} "
              f"bound_ms={bnd:.4f}")
    ms, plain, lib, bnd = timings["combiner"]
    return {"name": "segment_sum", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": None,
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": "bytes", "library_ms": lib}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import MaRe, TextFile
    from repro_torch.core.shuffle import keyed_bucket_capacity
    from repro_torch.io import fasta_source
    from repro_torch.kernels.segment_reduce import kernel as kmod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = kmod.build(verbose=True)
    phase("build kernel", t0, f"nvcc_s={kmod.BUILD_SECONDS:.3f} lib={lib}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        seq = make_genome(CHR21_BASES, args.seed)
        fasta = os.path.join(tmp, "chr21.fa")
        write_fasta(fasta, seq)
        phase("write genome", t0, f"bases={len(seq)} "
              f"N={int((seq == ord('N')).sum())} "
              f"bytes={os.path.getsize(fasta)}")

        t0 = time.perf_counter()
        src = fasta_source(fasta)
        ds = MaRe.from_source(src, num_shards=NUM_SHARDS).dataset
        torch.cuda.synchronize()
        phase("ingest", t0, f"shards={ds.num_shards} cap={ds.capacity} "
              f"width={ds.records['data'].shape[1]} "
              f"records={int(ds.counts.sum())} device={ds.device}")

        record = kernel_phase(ds, keyed_bucket_capacity(4 ** K, NUM_SHARDS))

        # GC count: the paper's Listing 1
        t0 = time.perf_counter()
        gc = (MaRe.from_source(src, num_shards=NUM_SHARDS)
              .map(input_mount=TextFile("/dna"),
                   output_mount=TextFile("/count"),
                   image="ubuntu", command="grep-chars GC")
              .reduce(input_mount=TextFile("/counts"),
                      output_mount=TextFile("/sum"),
                      image="ubuntu", command="awk-sum"))
        (total,) = gc.collect(shard=0)
        want = int(np.count_nonzero((seq == ord("G")) | (seq == ord("C"))))
        if int(total[0]) != want:
            raise AssertionError(f"GC count {int(total[0])} != numpy {want}")
        phase("GC count", t0, f"gc={int(total[0])} numpy={want} "
              f"phases={json.dumps(gc.report().phases)}")

        # k-mer statistics: the main path through the segment-sum kernel
        t0 = time.perf_counter()
        want_table = kmer_bincount(seq, K)
        phase("numpy k-mer reference", t0,
              f"windows={int(want_table.sum())} "
              f"distinct={int((want_table > 0).sum())}")
        t0 = time.perf_counter()
        kmod.reset_launches()
        stats = (MaRe.from_source(src, num_shards=NUM_SHARDS)
                 .map(image="kmer-stats", command=f"kmer-stats {K}")
                 .reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                                op="sum"))
        desc = stats.describe()
        keys, (occ,), cnt = stats.collect()
        launches = kmod.LAUNCHES
        report = stats.report()
        record["launches"] = launches
        print(desc, flush=True)
        phase("k-mer reduce_by_key", t0,
              f"keys={len(keys)} launches={launches} "
              f"action_wall_s={report.wall_s:.6f} "
              f"diagnostics={json.dumps(report.diagnostics)}")
        print("[report] phases " + json.dumps(report.phases), flush=True)
        t0 = time.perf_counter()
        out = stats.dataset
        on_cuda = all(leaf.is_cuda for leaf in
                      [out.counts, *out.records[:1], *out.records[1],
                       out.records[2]])
        if not on_cuda:
            raise AssertionError("k-mer result does not live on cuda")
        if launches == 0:
            raise AssertionError("the k-mer path launched no segment-sum "
                                 "kernel")
        if len(np.unique(keys)) != len(keys):
            raise AssertionError("a k-mer key appears on two shards")
        got_table = np.zeros(4 ** K, np.int64)
        got_table[keys] = occ
        if not np.array_equal(got_table, want_table):
            bad = int((got_table != want_table).sum())
            raise AssertionError(f"k-mer table differs from numpy at "
                                 f"{bad} keys")
        if not np.array_equal(occ, cnt):
            raise AssertionError("occurrences != record counts")
        phase("k-mer check", t0, "table == numpy bincount, on cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    phase("nvidia-smi", t0)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
