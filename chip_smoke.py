#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU, at full scale.

    python3 chip_smoke.py [--seed 0]

Drives the five slices of ``repro_torch`` through their public entry
points.  First it builds the six CUDA kernels from
``src/repro_torch/csrc`` (one ``nvcc`` each, started together).

Slice 1, the paper's pipeline, on a synthetic genome the size of GRCh38
chr21 (46,709,983 bases, FASTA with 60-base lines, ~1% of bases in N
runs), split into 8 logical shards:

1. hold the segment-sum kernel against its plain PyTorch version on the
   card, at the shapes the k-mer path gives it (combiner and merge) and on
   edge cases, and time kernel, plain version and ``index_add_`` with
   CUDA events;
2. GC count (the paper's Listing 1: ``grep-chars GC`` -> ``awk-sum``)
   against an exact numpy count;
3. k-mer statistics (``kmer-stats`` k=12 -> ``reduce_by_key`` sum) against
   a numpy ``bincount``, with every launch counter read around it.

Slice 2, LM serving at the full width of Llama-3.2-1B (16 layers,
d_model 2048, 32/8 heads, vocab 128256, bf16, random weights from the
seed):

4. hold the flash-attention and RMSNorm kernels against their plain
   versions on the card, at the prefill's shapes and on edge cases, and
   time kernel, plain version and one library call
   (``scaled_dot_product_attention``, ``rms_norm``) with CUDA events;
5. ``repro_torch.launch.serve --model-smoke`` (batch 4, prompt 2048, 32
   greedy tokens) with every launch counter read around it: one flash
   launch per layer;
6. the same prefill with plain attention, and teacher-forced decode
   against the forward pass, within stated bf16 tolerances;
7. RMSNorm's own route, ``models.layers.apply_rmsnorm(use_kernel=True)``,
   on the prefill's and a decode step's hidden-state shapes.

Slice 3a, MoE serving at the full width of granite-moe-1b-a400m (24
layers, d_model 1024, 16/8 heads, 32 experts top-8, expert d_ff 512,
vocab 49155, bf16, random weights from the seed):

8. hold the MoE-dispatch kernel against its plain version on the card,
   bit for bit, at a prefill's and a decode step's shapes and on edge
   cases, and time it beside ``torch.sort(stable=True)`` +
   ``torch.bincount``;
9. ``serve --model-smoke`` at batch 4, prompt 2048, 32 greedy tokens: one
   dispatch launch per layer in the prefill and in every decode step, one
   flash launch per layer in the prefill;
10. the same prefill with the dispatch's plain version: the same
    positions and counts in every layer and the same logits; then
    teacher-forced decode against the forward pass.

Slice 3b, the paper's virtual-screening pipeline (Listing 2) over a
library of 2,097,152 molecules x 16 float32 features in 8 logical shards:

11. hold the top-k kernel against its plain version on the card, bit for
    bit, at a shard's shape (262,144 scores, k = 30) and on edge cases,
    and time it beside ``torch.topk``;
12. ``map(tools/fred, rounds=8) -> reduce(toolbox/topk, k=30, depth=2) ->
    collect()``: one top-k launch per ``toolbox/topk`` combine, the 30
    molecules equal to an oracle's over the whole library, the records
    equal to a plain top-k over the pipeline's own mapped scores.

Slice 4, hybrid serving at the full width and depth of hymba-1.5b (32
layers, d_model 1600, 25/5 heads, window 1024 on all but the global layers
0, 15 and 31, SSM state 16, vocab 32001, bf16, random weights from the
seed):

13. hold the selective-scan kernel against its plain version on the card
    at hymba's prefill and decode shapes and on edge cases (odd T, d not a
    multiple of the block, n of 2 to 16, two halves chained through h),
    time kernel and plain version, and hold the flash kernel at hymba's
    GQA group 5 with window 1024 and without;
14. ``serve --model-smoke`` at batch 4, prompt 2048, 32 greedy tokens: one
    SSM launch per layer in the prefill and in every decode step (1,024 in
    the request), one flash launch per layer in the prefill;
15. the same prefill with the reference's chunked scan in place of the
    kernel, and teacher-forced decode against the forward pass, each on an
    f32 copy of the weights and in bf16 (see ``SSM_ROUTE_TOL_FRAC``).

Every phase prints its wall time; the first failure exits non-zero.  The
last lines are a JSON object describing the kernels, the ``nvidia-smi``
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
# H100 SXM dense bf16 tensor-core and float32 CUDA-core peaks (data sheet)
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
ARCH = "llama3.2-1b"
BATCH, PROMPT, GEN = 4, 2048, 32


def phase(name: str, t0: float, extra: str = "") -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s"
          + (f"  {extra}" if extra else ""), flush=True)


def kernel_modules() -> dict:
    """The port's kernel modules by kernel name; each keeps a ``LAUNCHES``
    counter that its wrapper raises by one per kernel launch."""
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.moe_dispatch import kernel as dmod
    from repro_torch.kernels.rmsnorm import kernel as rmod
    from repro_torch.kernels.segment_reduce import kernel as kmod
    from repro_torch.kernels.ssm_scan import kernel as smod
    from repro_torch.kernels.topk_reduce import kernel as tmod
    return {"segment_sum": kmod, "flash_attention": fmod, "rmsnorm": rmod,
            "moe_dispatch": dmod, "topk_reduce": tmod, "ssm_scan": smod}


def reset_launches() -> None:
    for mod in kernel_modules().values():
        mod.reset_launches()


#: Each main path's launch counts, read just after it ran with every
#: counter set to 0 just before it.
PATH_LAUNCHES: dict = {}


def read_launches(path: str, expect: dict) -> dict:
    """Every kernel's launches since :func:`reset_launches`, kept under
    ``path``; raises unless each kernel named in ``expect`` launched
    exactly that often and every other kernel not at all."""
    got = {name: mod.LAUNCHES for name, mod in kernel_modules().items()}
    PATH_LAUNCHES[path] = got
    want = {name: expect.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")
    return got


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
# slice 1: the paper's pipeline at chr21 scale
# ---------------------------------------------------------------------------

def kmer_slice(seed: int) -> dict:
    """GC count and k-mer statistics on a chr21-sized genome; returns the
    segment-sum kernel's JSON record."""
    import torch
    from repro_torch.core import MaRe, TextFile
    from repro_torch.core.shuffle import keyed_bucket_capacity
    from repro_torch.io import fasta_source
    from repro_torch.kernels.segment_reduce import kernel as kmod

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        seq = make_genome(CHR21_BASES, seed)
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
        reset_launches()
        stats = (MaRe.from_source(src, num_shards=NUM_SHARDS)
                 .map(image="kmer-stats", command=f"kmer-stats {K}")
                 .reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                                op="sum"))
        desc = stats.describe()
        keys, (occ,), cnt = stats.collect()
        launches = kmod.LAUNCHES
        if launches == 0:
            raise AssertionError("the k-mer path launched no segment-sum "
                                 "kernel")
        read_launches("kmer", {"segment_sum": launches})
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

    return record


# ---------------------------------------------------------------------------
# slice 2: Llama-3.2-1B serving at full width
# ---------------------------------------------------------------------------

FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:86"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
RMS_REPLACES = "src/repro/kernels/rmsnorm/kernel.py:27"
RMS_SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
# kernel vs plain version taken in f32: bf16 output rounds once to 8
# mantissa bits (2e-2 for |out| < 4, as the reference's kernel tests);
# f32 differs in summation order only
FLASH_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 2e-5}
RMS_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-6}
# Logits of two bf16 paths through 16 layers differ by bf16 roundings at
# other places (each path rounds its attention output, the decode path
# its one-row products): at 16 layers of this width on the CPU (seq 256,
# vocab 8192) the largest difference was 1.9-2.4% of the largest |logit|,
# for plain vs kernel-order attention and for decode vs forward.  Allow
# 10%.  A wrong mask or head mapping moves logits by their spread, which
# is 15-20% of the largest.
LOGIT_TOL_FRAC = 0.1
TEACHER_FORCED = 4


def flash_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps, per head."""
    qpos = np.arange(sq) + (sk - sq)
    masked = causal or window is not None
    hi = np.minimum(qpos + 1, sk) if masked else np.full(sq, sk)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.clip(hi - lo, 0, None).sum())


def flash_bound(b, hq, hkv, sq, sk, d, causal, window, itemsize):
    """Least time for attention on these inputs: q.k and p.v over the
    pairs the mask keeps (4 * d operations a pair) at the tensor cores'
    peak for the inputs' type, against q, k, v read once and o written
    once over HBM bandwidth."""
    ops = 4 * d * b * hq * flash_pairs(sq, sk, causal, window)
    nbytes = itemsize * d * (2 * b * hq * sq + 2 * b * hkv * sk)
    t_ops = ops / (BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rms_bound(rows: int, d: int, itemsize: int):
    """x read once, w read once, out written once over HBM bandwidth; the
    ~4 operations per element take far less at any peak rate."""
    nbytes = itemsize * (2 * rows * d + d)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * rows * d / F32_FLOP_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def flash_check(dev, g, name, b, hq, hkv, sq, sk, d, dt, causal, window):
    """One flash launch on random inputs against the plain version taken
    in f32; returns (max abs error, (q, k, v))."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    t0 = time.perf_counter()
    q = torch.randn((b, hq, sq, d), device=dev, generator=g).to(dt)
    k = torch.randn((b, hkv, sk, d), device=dev, generator=g).to(dt)
    v = torch.randn((b, hkv, sk, d), device=dev, generator=g).to(dt)
    before = fmod.LAUNCHES
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if fmod.LAUNCHES - before != 1:
        raise AssertionError(f"flash {name}: "
                             f"{fmod.LAUNCHES - before} launches")
    want = flash_attention_plain(
        q.float().reshape(b * hq, sq, d),
        k.float().reshape(b * hkv, sk, d),
        v.float().reshape(b * hkv, sk, d), hq // hkv, causal=causal,
        window=window).reshape(b, hq, sq, d)
    err = float((got.float() - want).abs().max())
    tol = FLASH_TOL[str(dt)]
    if got.dtype != dt or not err < tol:
        raise AssertionError(f"flash {name}: {got.dtype}, max abs err "
                             f"{err} vs tolerance {tol}")
    empty = sq - sk if causal and sq > sk else 0
    if empty and not bool((got[:, :, :empty] == 0).all()):
        raise AssertionError(f"flash {name}: a row without keys is not 0")
    phase(f"flash check {name}", t0,
          f"q={tuple(q.shape)} kv={tuple(k.shape)} {dt} causal={causal}"
          f" window={window} max_abs_err={err} tol={tol}"
          f" rows_without_keys={empty * b * hq}")
    return err, (q, k, v)


def flash_kernel_phase(dev) -> dict:
    """Flash kernel vs its plain version at the prefill shape and on edge
    cases; times kernel, plain version and SDPA at the prefill shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, hq, hkv, sq, sk, d, dtype, causal, window
        ("prefill", BATCH, 32, 8, PROMPT, PROMPT, 64, bf16, True, None),
        ("prefill f32", BATCH, 32, 8, PROMPT, PROMPT, 64, f32, True, None),
        ("right-aligned Sq<Sk", 2, 32, 8, 96, PROMPT, 64, bf16, True, None),
        ("window 256", 1, 32, 8, 1024, 1024, 64, bf16, True, 256),
        ("unaligned Sq, Sk", 1, 12, 4, 1000, 1037, 64, bf16, True, None),
        ("Hq == Hkv", 2, 8, 8, 300, 300, 64, bf16, True, None),
        ("not causal d=128", 2, 8, 2, 200, 333, 128, bf16, False, None),
        ("rows without keys", 1, 8, 2, 300, 100, 64, bf16, True, None),
    ]
    g = torch.Generator(device=dev).manual_seed(21)
    errs = {}
    prefill_inputs = None
    for case in cases:
        errs[case[0]], inputs = flash_check(dev, g, *case)
        if case[0] == "prefill":
            prefill_inputs = inputs
        del inputs
    t0 = time.perf_counter()
    q, k, v = prefill_inputs
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    q3, k3, v3 = (t.reshape(-1, t.shape[2], d) for t in (q, k, v))
    ms = cuda_ms(lambda: fmod.flash_attention_kernel(q3, k3, v3,
                                                     group=hq // hkv))
    plain = cuda_ms(lambda: flash_attention_plain(q3, k3, v3, hq // hkv),
                    reps=5, warmup=1)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    bnd, by = flash_bound(b, hq, hkv, sq, sk, d, True, None, 2)
    phase("flash timing prefill", t0,
          f"q={tuple(q.shape)} kv={tuple(k.shape)} bf16 causal "
          f"kernel_ms={ms:.4f} plain_ms={plain:.4f} sdpa_ms={lib:.4f} "
          f"bound_ms={bnd:.4f} ({by}) pairs_per_head="
          f"{flash_pairs(sq, sk, True, None)}")
    return {"name": "flash_attention", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": None, "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


def rms_kernel_phase(dev, d_model: int) -> dict:
    """RMSNorm kernel vs its plain version at the prefill's and a decode
    step's rows and on edge cases; times kernel, plain version and
    ``F.rms_norm`` at the prefill rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as rmod
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    bf16, f32 = torch.bfloat16, torch.float32
    rows = BATCH * PROMPT
    cases = [("prefill rows", rows, d_model, bf16),
             ("decode rows", BATCH, d_model, bf16),
             ("prefill rows f32", rows, d_model, f32),
             ("d=2050 (no 16-byte path)", 64, d_model + 2, bf16),
             ("d=100", 33, 100, bf16),
             ("d=1000 f32", 7, 1000, f32)]
    g = torch.Generator(device=dev).manual_seed(22)
    errs = {}
    for name, r, d, dt in cases:
        t0 = time.perf_counter()
        x = torch.randn((r, d), device=dev, generator=g).to(dt)
        # norm scales near 1, as a model's: |out| < 8
        w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
        before = rmod.LAUNCHES
        got = rmod.rmsnorm_kernel(x, w, 1e-6)
        torch.cuda.synchronize()
        if rmod.LAUNCHES - before != 1:
            raise AssertionError(f"rmsnorm {name}: "
                                 f"{rmod.LAUNCHES - before} launches")
        want = rmsnorm_ref(x.float(), w.float(), 1e-6)
        err_t = (got.float() - want).abs()
        tol = RMS_TOL[str(dt)]
        # f32: 1e-6 abs plus 1e-6 relative (rsqrtf and the warp's
        # summation order each move the statistic by ~1 ulp)
        rtol = 1e-6 if dt == f32 else 0.0
        ok = bool((err_t <= tol + rtol * want.abs()).all())
        err = float(err_t.max())
        if got.dtype != dt or not ok:
            raise AssertionError(f"rmsnorm {name}: max abs err {err} vs "
                                 f"tolerance {tol} + {rtol} rel")
        errs[name] = err
        phase(f"rmsnorm check {name}", t0,
              f"x={tuple(x.shape)} {dt} max_abs_err={err} tol={tol}"
              f" rtol={rtol}")
    t0 = time.perf_counter()
    x = torch.randn((rows, d_model), device=dev, generator=g).to(bf16)
    w = (1 + 0.1 * torch.randn(d_model, device=dev, generator=g)).to(bf16)
    ms = cuda_ms(lambda: rmod.rmsnorm_kernel(x, w, 1e-6))
    plain = cuda_ms(lambda: rmsnorm_ref(x, w, 1e-6))
    lib = cuda_ms(lambda: F.rms_norm(x, (d_model,), w, 1e-6))
    xd = x[:BATCH].contiguous()
    ms_dec = cuda_ms(lambda: rmod.rmsnorm_kernel(xd, w, 1e-6))
    bnd, by = rms_bound(rows, d_model, 2)
    phase("rmsnorm timing prefill rows", t0,
          f"x={tuple(x.shape)} bf16 kernel_ms={ms:.4f} plain_ms={plain:.4f}"
          f" rms_norm_ms={lib:.4f} bound_ms={bnd:.4f} ({by}) "
          f"decode_rows_kernel_ms={ms_dec:.4f}")
    return {"name": "rmsnorm", "route": "cuda", "source": RMS_SOURCE,
            "replaces": RMS_REPLACES, "launches": None,
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib}


def max_abs_diff(a, b) -> float:
    """max |a - b| in f32, one batch row at a time (logits are GBs)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def max_abs(a) -> float:
    return max(float(x.float().abs().max()) for x in a)


def check_run(run, cfg) -> None:
    """The serving run's logits are finite of the prompt's shape and its
    tokens lie in the vocabulary."""
    import torch
    if run.logits.shape != (BATCH, PROMPT, cfg.vocab_size) or \
            not bool(torch.isfinite(run.logits).all()):
        raise AssertionError("prefill logits are not finite of shape "
                             f"{(BATCH, PROMPT, cfg.vocab_size)}")
    if run.generated.shape != (BATCH, GEN) or \
            not ((run.generated >= 0) & (run.generated < cfg.vocab_size)
                 ).all():
        raise AssertionError(f"generated tokens {run.generated.shape}")


def warm_repeat(run, steps: int = 8) -> tuple:
    """Warm walls of the same prefill and of ``steps`` decode steps;
    returns (prefill s, decode s per token)."""
    import torch
    t0 = time.perf_counter()
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, cache = run.model.prefill(run.params, {"tokens": run.prompt},
                                     PROMPT + GEN)
        torch.cuda.synchronize()
        warm_prefill = time.perf_counter() - t1
        tok = torch.from_numpy(run.generated[:, 0]).to(run.prompt.device)
        t1 = time.perf_counter()
        for _ in range(steps):
            _, cache = run.model.decode_step(run.params, cache, tok)
        torch.cuda.synchronize()
        warm_decode = (time.perf_counter() - t1) / steps
        del cache
    phase("serve warm repeat", t0,
          f"prefill_ms={warm_prefill * 1e3:.3f} "
          f"decode_ms_per_token={warm_decode * 1e3:.3f}")
    return warm_prefill, warm_decode


def teacher_forced(run) -> None:
    """Teacher-forced decode equals the forward pass on the same tokens,
    to LOGIT_TOL_FRAC of the largest |logit|."""
    import torch
    t0 = time.perf_counter()
    forced = torch.from_numpy(run.generated[:, :TEACHER_FORCED]).to(
        run.prompt.device)
    toks = torch.cat([run.prompt, forced], dim=1)
    with torch.no_grad():
        full = run.model.forward(run.params, {"tokens": toks})
        lg, cache = run.model.prefill(
            run.params, {"tokens": toks[:, :PROMPT]},
            PROMPT + TEACHER_FORCED)
        errs = [max_abs_diff(full[:, :PROMPT], lg)]
        del lg
        for t in range(TEACHER_FORCED):
            lg, cache = run.model.decode_step(run.params, cache,
                                              toks[:, PROMPT + t])
            errs.append(float((full[:, PROMPT + t].float()
                               - lg.float()).abs().max()))
    scale = max_abs(full)
    del full, cache
    if not max(errs) <= LOGIT_TOL_FRAC * scale:
        raise AssertionError(f"teacher-forced decode differs from forward: "
                             f"{errs} (> {LOGIT_TOL_FRAC} x {scale})")
    phase("teacher-forced decode vs forward", t0,
          f"max_abs_diff prefill/steps={errs} max_abs_logit={scale} "
          f"tol={LOGIT_TOL_FRAC * scale}")


def lm_slice(seed: int) -> list:
    """Kernel checks, then the serving path at Llama-3.2-1B's full width;
    returns the flash and RMSNorm kernels' JSON records."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.layers import apply_rmsnorm, embed_tokens

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    flash_rec = flash_kernel_phase(dev)
    rms_rec = rms_kernel_phase(dev, cfg.d_model)
    torch.cuda.empty_cache()

    # the main path: the serving entry, every launch counter read around it
    argv = ["--model-smoke", "--arch", ARCH, "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--seed",
            str(seed), "--device", "cuda"]
    args = serve.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    run = serve.model_smoke(args)
    launches = read_launches(
        ARCH, {"flash_attention": cfg.num_layers})   # one per layer
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in serve.report_lines(args, run):
        print(line, flush=True)
    phase("serve --model-smoke", t0,
          f"arch={ARCH} layers={cfg.num_layers} params="
          f"{sum(p.numel() for p in run.params.parameters())} "
          f"batch={BATCH} prompt={PROMPT} gen={GEN} "
          f"prefill_ms={run.prefill_s * 1e3:.3f} "
          f"decode_ms_per_token={run.decode_s_per_token * 1e3:.3f} "
          f"peak_mem_gb={peak_gb:.3f} launches={json.dumps(launches)}")
    check_run(run, cfg)
    flash_rec["launches"] = launches["flash_attention"]
    warm_repeat(run)

    # the same prefill through plain attention, same weights
    t0 = time.perf_counter()
    plain_model = build_model(cfg.scaled(attn_impl="ref"), device=dev)
    with torch.no_grad():
        plain_logits, _ = plain_model.prefill(
            run.params, {"tokens": run.prompt}, PROMPT)
    diff = max_abs_diff(run.logits, plain_logits)
    scale = max_abs(plain_logits)
    del plain_logits
    if not diff <= LOGIT_TOL_FRAC * scale:
        raise AssertionError(f"kernel-path logits differ from the plain "
                             f"path by {diff} (> {LOGIT_TOL_FRAC} x "
                             f"{scale})")
    phase("prefill kernel vs plain attention", t0,
          f"max_abs_diff={diff} max_abs_logit={scale} "
          f"tol={LOGIT_TOL_FRAC * scale}")

    teacher_forced(run)
    forced = torch.from_numpy(run.generated[:, :1]).to(dev)

    # RMSNorm's route: layers.apply_rmsnorm(use_kernel=True), on the
    # serving path's hidden-state shapes (the model's own apply_norm
    # keeps the plain version, as the reference does)
    t0 = time.perf_counter()
    with torch.no_grad():
        x_pre = embed_tokens(run.params["embed"], run.prompt, cfg)
        x_dec = embed_tokens(run.params["embed"], forced[:, :1], cfg)
        norm = run.params["final_norm"]
        reset_launches()
        y_pre = apply_rmsnorm(norm, x_pre, cfg.norm_eps, use_kernel=True)
        y_dec = apply_rmsnorm(norm, x_dec, cfg.norm_eps, use_kernel=True)
        rms_launches = read_launches("apply_rmsnorm(use_kernel=True)",
                                     {"rmsnorm": 2})["rmsnorm"]
        err = max(float((y.float() - apply_rmsnorm(
            norm, x.float(), cfg.norm_eps).float()).abs().max())
            for x, y in ((x_pre, y_pre), (x_dec, y_dec)))
    if not err < RMS_TOL["torch.bfloat16"]:
        raise AssertionError(f"apply_rmsnorm(use_kernel=True): err {err}")
    rms_rec["launches"] = rms_launches
    rms_rec["path"] = ("models.layers.apply_rmsnorm(use_kernel=True) on "
                       "the prefill's and a decode step's hidden states")
    phase("apply_rmsnorm(use_kernel=True)", t0,
          f"x={tuple(x_pre.shape)},{tuple(x_dec.shape)} launches="
          f"{rms_launches} max_abs_err={err}")
    return [flash_rec, rms_rec]


# ---------------------------------------------------------------------------
# slice 3a: granite-moe-1b-a400m serving at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"
DISPATCH_REPLACES = "src/repro/kernels/moe_dispatch/kernel.py:50"
DISPATCH_SOURCE = "src/repro_torch/csrc/moe_dispatch.cu"


def bytes_bound(nbytes: int, ops: int):
    """(bound ms, by): ``nbytes`` over HBM bandwidth against ``ops``
    integer or compare operations at the CUDA cores' 67 T/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOP_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def dispatch_bound(n: int, groups: int):
    """n ids read, n positions and ``groups`` counts written; one compare
    and one add an id."""
    return bytes_bound(4 * (2 * n + groups), 2 * n)


def dispatch_kernel_phase(dev, n_prefill: int, n_decode: int,
                          groups: int) -> dict:
    """Dispatch kernel vs its plain version, bit for bit, at the prefill's
    and a decode step's sizes and on edge cases; times kernel, plain
    version and ``torch.sort(stable=True)`` + ``torch.bincount`` at the
    prefill's size."""
    import torch
    from repro_torch.kernels.moe_dispatch import kernel as dmod
    from repro_torch.kernels.moe_dispatch.ref import dispatch_ref
    g = torch.Generator(device=dev).manual_seed(31)

    def ids(n, lo, hi):
        return torch.randint(lo, hi, (n,), device=dev, dtype=torch.int32,
                             generator=g)

    cases = [
        ("prefill", ids(n_prefill, 0, groups), groups),
        ("decode", ids(n_decode, 0, groups), groups),
        ("n=1", ids(1, 0, groups), groups),
        ("one group", ids(5000, 0, 1), 1),
        ("G=64, n=64", ids(64, 0, 64), 64),
        ("n not a multiple of the tile", ids(n_prefill + 77, 0, groups),
         groups),
        ("one hot group", torch.full((n_prefill,), 7, device=dev,
                                     dtype=torch.int32), groups),
        ("ids outside [0, G)", ids(10000, -3, groups + 3), groups),
        ("G=5000", ids(100000, 0, 5000), 5000),
        ("n=0", ids(0, 0, groups), groups),
    ]
    for name, a, G in cases:
        t0 = time.perf_counter()
        before = dmod.LAUNCHES
        got = dmod.moe_dispatch_kernel(a, G)
        torch.cuda.synchronize()
        launched = dmod.LAUNCHES - before
        compare(f"dispatch {name}", got, dispatch_ref(a, G))
        if launched != (1 if a.numel() else 0):
            raise AssertionError(f"dispatch {name}: {launched} launches")
        phase(f"dispatch check {name}", t0,
              f"n={a.numel()} groups={G} bit-equal to plain version")
    t0 = time.perf_counter()
    a = cases[0][1]
    ms = cuda_ms(lambda: dmod.moe_dispatch_kernel(a, groups), reps=50)
    plain = cuda_ms(lambda: dispatch_ref(a, groups))
    lib = cuda_ms(lambda: (torch.sort(a, stable=True),
                           torch.bincount(a, minlength=groups)), reps=50)
    ad = cases[1][1]
    ms_dec = cuda_ms(lambda: dmod.moe_dispatch_kernel(ad, groups), reps=50)
    bnd, by = dispatch_bound(n_prefill, groups)
    phase("dispatch timing prefill", t0,
          f"n={n_prefill} groups={groups} kernel_ms={ms:.4f} "
          f"plain_ms={plain:.4f} sort_bincount_ms={lib:.4f} "
          f"bound_ms={bnd:.6f} ({by}) decode_n={n_decode}_kernel_ms="
          f"{ms_dec:.4f}")
    return {"name": "moe_dispatch", "route": "cuda",
            "source": DISPATCH_SOURCE, "replaces": DISPATCH_REPLACES,
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib,
            "library": "torch.sort(stable=True) + torch.bincount"}


def recording(fn, log: list):
    """``fn`` (a dispatch) that also appends (ids, positions, counts) of
    every call to ``log``."""
    def dispatch(assignments, num_groups):
        positions, counts = fn(assignments, num_groups)
        log.append((assignments.reshape(-1).to(positions.dtype),
                    positions, counts))
        return positions, counts
    return dispatch


def moe_slice(seed: int) -> dict:
    """Dispatch kernel checks, then MoE serving at granite's full width;
    returns the dispatch kernel's JSON record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch.ref import dispatch_ref
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_lib

    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    k, E, L = cfg.experts_per_token, cfg.num_experts, cfg.num_layers
    rec = dispatch_kernel_phase(dev, BATCH * PROMPT * k, BATCH * k, E)
    torch.cuda.empty_cache()

    # the main path: the serving entry, every launch counter read around it
    argv = ["--model-smoke", "--arch", MOE_ARCH, "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--seed",
            str(seed), "--device", "cuda"]
    args = serve.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    run = serve.model_smoke(args)
    # one dispatch per layer in the prefill and in each of GEN - 1 decode
    # steps; one flash launch per layer in the prefill
    launches = read_launches(MOE_ARCH, {"moe_dispatch": L * GEN,
                                        "flash_attention": L})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in serve.report_lines(args, run):
        print(line, flush=True)
    phase("serve --model-smoke", t0,
          f"arch={MOE_ARCH} layers={L} experts={E} top_k={k} params="
          f"{sum(p.numel() for p in run.params.parameters())} "
          f"batch={BATCH} prompt={PROMPT} gen={GEN} "
          f"prefill_ms={run.prefill_s * 1e3:.3f} "
          f"decode_ms_per_token={run.decode_s_per_token * 1e3:.3f} "
          f"peak_mem_gb={peak_gb:.3f} launches={json.dumps(launches)}")
    check_run(run, cfg)
    rec["launches"] = launches["moe_dispatch"]
    warm_repeat(run)

    # one prefill and one decode step apart, with the dispatch's inputs and
    # outputs recorded; then the same prefill through its plain version
    t0 = time.perf_counter()
    kernel_log, plain_log = [], []
    kernel_dispatch = moe_lib.moe_dispatch
    try:
        moe_lib.moe_dispatch = recording(kernel_dispatch, kernel_log)
        with torch.no_grad():
            reset_launches()
            logits, cache = run.model.prefill(
                run.params, {"tokens": run.prompt}, PROMPT + 1)
            read_launches(f"{MOE_ARCH} prefill", {"moe_dispatch": L,
                                                  "flash_attention": L})
            reset_launches()
            run.model.decode_step(run.params, cache, torch.from_numpy(
                run.generated[:, 0]).to(dev))
            read_launches(f"{MOE_ARCH} decode step", {"moe_dispatch": L})
            del cache
            moe_lib.moe_dispatch = recording(
                lambda a, G: dispatch_ref(a.reshape(-1).to(torch.int32), G),
                plain_log)
            plain_logits, _ = run.model.prefill(
                run.params, {"tokens": run.prompt}, PROMPT)
    finally:
        moe_lib.moe_dispatch = kernel_dispatch
    kernel_log = kernel_log[:L]              # the prefill's layers
    if len(kernel_log) != L or len(plain_log) != L:
        raise AssertionError(f"{len(kernel_log)} / {len(plain_log)} "
                             f"dispatch calls, expected {L}")
    for layer, (kc, pc) in enumerate(zip(kernel_log, plain_log)):
        for what, a, b in zip(("ids", "positions", "counts"), kc, pc):
            if not torch.equal(a, b):
                raise AssertionError(f"layer {layer}: dispatch {what} of "
                                     f"the kernel path != plain path")
    bit_equal = torch.equal(logits, plain_logits)
    diff = max_abs_diff(logits, plain_logits)
    scale = max_abs(plain_logits)
    del logits, plain_logits
    # the dispatch is integer: with equal ids, positions and counts in
    # every layer, every float op downstream sees the same inputs
    if not bit_equal:
        raise AssertionError(f"kernel-path logits differ from the plain "
                             f"dispatch's by {diff} (max |logit| {scale})")
    phase("prefill dispatch kernel vs plain version", t0,
          f"layers={L} ids/positions/counts equal in every layer; logits "
          f"bit-equal (max_abs_diff={diff}, max_abs_logit={scale}); "
          f"tokens_per_expert_layer0="
          f"{plain_log[0][2].tolist()}")

    teacher_forced(run)
    return rec


# ---------------------------------------------------------------------------
# slice 3b: the paper's virtual-screening pipeline
# ---------------------------------------------------------------------------

VS_MOLECULES = 2_097_152         # 8 shards of 262,144
VS_TOP, VS_ROUNDS, VS_DEPTH = 30, 8, 2
FEATURES = 16
TOPK_REPLACES = "src/repro/kernels/topk_reduce/kernel.py:72"
TOPK_SOURCE = "src/repro_torch/csrc/topk_reduce.cu"


def fred_mix(r: int):
    """Round ``r``'s [16, 16] mixing matrix, as ``benchmarks/apps.py``
    draws it."""
    import torch
    rng = np.random.default_rng(r)
    return torch.from_numpy(
        (rng.normal(size=(FEATURES, FEATURES)) / np.sqrt(FEATURES)
         ).astype(np.float32))


def fred_score(feats, rounds: int = VS_ROUNDS):
    """The surrogate docking score: x = tanh(x @ mix_r) + 0.1 x for
    ``rounds`` rounds, then the sum of the features."""
    import torch
    x = feats.float()
    for r in range(rounds):
        x = torch.tanh(x @ fred_mix(r).to(x.device)) + 0.1 * x
    return torch.sum(x, dim=-1)


def register_fred() -> None:
    """The ``tools/fred`` image of ``benchmarks/apps.py`` in the port's
    registry: (features, molecule id) -> (score, molecule id)."""
    from repro_torch.core.container import (DEFAULT_REGISTRY, container_op,
                                            make_partition)
    if "tools/fred:latest" in DEFAULT_REGISTRY.images():
        return

    @container_op("tools/fred", registry=DEFAULT_REGISTRY)
    def fred(part, command: str = "", rounds: int = VS_ROUNDS, **kw):
        feats, mol_id = part.records
        return make_partition((fred_score(feats, rounds), mol_id),
                              part.count)


def make_library(n: int, seed: int):
    """n molecules: ([n, 16] float32 features, [n] int32 ids), as
    ``benchmarks/apps.py:make_library``."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, FEATURES)).astype(np.float32)
    return feats, np.arange(n, dtype=np.int32)


def virtual_screening(data, num_shards: int = 1, device=None,
                      top: int = VS_TOP, rounds: int = VS_ROUNDS,
                      depth: int = VS_DEPTH):
    """Paper Listing 2 on the port: map(tools/fred) -> reduce(toolbox/
    topk); ``data`` is the library or a dataset.  Returns the lazy chain."""
    from repro_torch.core import MaRe, TextFile
    register_fred()
    sdf = ("/in.sdf", "/out.sdf")
    return (MaRe(data, num_shards=num_shards, device=device)
            .map(input_mount=TextFile(sdf[0], "\n$$$$\n"),
                 output_mount=TextFile(sdf[1], "\n$$$$\n"),
                 image="tools/fred", rounds=rounds)
            .reduce(input_mount=TextFile(sdf[0], "\n$$$$\n"),
                    output_mount=TextFile(sdf[1], "\n$$$$\n"),
                    image="toolbox/topk", k=top, depth=depth))


def topk_combines(num_shards: int, depth: int) -> int:
    """``toolbox/topk`` calls of one depth-K tree reduce: one per shard,
    then one per group leader at each level (``core/tree_reduce``)."""
    from repro_torch.core.tree_reduce import split_factors
    calls, stride = num_shards, 1
    for g in split_factors(num_shards, depth):
        if g > 1:
            calls += -(-num_shards // (stride * g))
            stride *= g
    return calls


def topk_bound(n: int, k: int):
    """n scores read, k values and indices written; one compare a
    score."""
    return bytes_bound(4 * n + 8 * k + 4, n)


def topk_kernel_phase(dev, n: int, k: int) -> dict:
    """Top-k kernel vs its plain version, bit for bit, at a shard's size
    and on edge cases; times kernel, plain version and ``torch.topk``."""
    import torch
    from repro_torch.kernels.topk_reduce import kernel as tmod
    from repro_torch.kernels.topk_reduce.ref import topk_ref
    g = torch.Generator(device=dev).manual_seed(41)
    s = torch.randn((n,), device=dev, generator=g)
    dup = torch.round(torch.randn((n,), device=dev, generator=g) * 4) / 4
    small = torch.randn((100,), device=dev, generator=g)
    ties = torch.tensor([1.0, float("-inf"), 0.0, -0.0, 1.0, float("-inf"),
                         2.0, 0.0], device=dev)
    cases = [
        ("shard", s, k, n),
        ("shard, count < n", s, k, n - 12345),
        ("duplicates", dup, k, n),
        ("k > valid_count", s, k, 10),
        ("valid_count = 0", s, k, 0),
        ("k = n", small, 100, 100),
        ("n not a multiple of the tile", s[:n - 77], k, n - 1000),
        ("tree level", s[:2 * k], k, k + 7),
        ("n = 1", s[:1], 1, 1),
        ("+-0 and -inf ties", ties, 8, 7),
        ("8 shards at once", torch.randn((8 * n,), device=dev,
                                         generator=g), k, 8 * n),
    ]
    for name, x, kk, vc in cases:
        t0 = time.perf_counter()
        vct = torch.tensor(vc, device=dev, dtype=torch.int32)
        before = tmod.LAUNCHES
        got = tmod.topk_reduce_kernel(x, kk, vct)
        torch.cuda.synchronize()
        if tmod.LAUNCHES - before != 1:
            raise AssertionError(f"top-k {name}: "
                                 f"{tmod.LAUNCHES - before} launches")
        compare(f"top-k {name}", got, topk_ref(x, kk, vct))
        phase(f"top-k check {name}", t0,
              f"n={x.numel()} k={kk} valid_count={vc} bit-equal to plain "
              f"version")
    t0 = time.perf_counter()
    vct = torch.tensor(n, device=dev, dtype=torch.int32)
    ms = cuda_ms(lambda: tmod.topk_reduce_kernel(s, k, vct), reps=50)
    plain = cuda_ms(lambda: topk_ref(s, k, vct))
    lib = cuda_ms(lambda: torch.topk(s, k), reps=50)
    bnd, by = topk_bound(n, k)
    phase("top-k timing shard", t0,
          f"n={n} k={k} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"torch_topk_ms={lib:.4f} bound_ms={bnd:.6f} ({by})")
    return {"name": "topk_reduce", "route": "cuda", "source": TOPK_SOURCE,
            "replaces": TOPK_REPLACES, "launches": None,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib}


def vs_slice(seed: int) -> dict:
    """Top-k kernel checks, then the virtual-screening pipeline over 2M
    molecules in 8 shards; returns the top-k kernel's JSON record."""
    import torch
    from repro_torch.core import MaRe
    from repro_torch.kernels.topk_reduce.ref import topk_ref

    dev = torch.device("cuda")
    shard = VS_MOLECULES // NUM_SHARDS
    rec = topk_kernel_phase(dev, shard, VS_TOP)

    t0 = time.perf_counter()
    library = make_library(VS_MOLECULES, seed)
    ds = MaRe(library, num_shards=NUM_SHARDS, device=dev).dataset
    torch.cuda.synchronize()
    phase("VS library", t0, f"molecules={VS_MOLECULES} shards="
          f"{ds.num_shards} cap={ds.capacity} features={FEATURES} "
          f"bytes={library[0].nbytes + library[1].nbytes}")

    # the main path, every launch counter read around it
    t0 = time.perf_counter()
    reset_launches()
    chain = virtual_screening(ds, top=VS_TOP)
    scores, ids = chain.collect(shard=0)
    combines = topk_combines(NUM_SHARDS, VS_DEPTH)
    launches = read_launches("virtual screening",
                             {"topk_reduce": combines})
    first = chain.report().wall_s
    rec["launches"] = launches["topk_reduce"]
    print(chain.describe(), flush=True)
    phase("VS map(tools/fred) -> reduce(toolbox/topk)", t0,
          f"top={len(ids)} action_wall_s={first:.6f} "
          f"topk_combines={combines} launches={json.dumps(launches)} "
          f"phases={json.dumps(chain.report().phases)}")
    t0 = time.perf_counter()
    warm = []
    for _ in range(3):
        again = virtual_screening(ds, top=VS_TOP)
        s2, i2 = again.collect(shard=0)
        warm.append(again.report().wall_s)
        if not (np.array_equal(s2, scores) and np.array_equal(i2, ids)):
            raise AssertionError("a warm VS action gave other records")
    phase("VS warm actions", t0, f"action_wall_s={warm}")

    # records == a plain top-k over the pipeline's own mapped scores
    t0 = time.perf_counter()
    register_fred()
    mapped = MaRe(ds).map(image="tools/fred", rounds=VS_ROUNDS).dataset
    cap, cnt = mapped.capacity, mapped.counts.tolist()
    m_scores, m_ids = mapped.records
    keep = torch.cat([torch.arange(s * cap, s * cap + c, device=dev)
                      for s, c in enumerate(cnt)])
    pv, pi = topk_ref(m_scores[keep], VS_TOP)
    want_scores = pv.cpu().numpy()
    want_ids = m_ids[keep][pi.long()].cpu().numpy()
    if not (np.array_equal(scores, want_scores)
            and np.array_equal(ids, want_ids)):
        raise AssertionError("VS records != plain top-k of the pipeline's "
                             "mapped scores")
    # ... and the oracle: score the whole library at once, stable sort
    feats = torch.from_numpy(library[0]).to(dev)
    all_scores = fred_score(feats)
    order = torch.sort(all_scores, descending=True, stable=True).indices
    o_ids = order[:VS_TOP].cpu().numpy()
    o_scores = all_scores[order[:VS_TOP]].cpu().numpy()
    if set(o_ids.tolist()) != set(ids.tolist()):
        raise AssertionError(f"VS top-{VS_TOP} ids differ from the oracle's")
    err = float(np.abs(np.sort(o_scores) - np.sort(scores)).max())
    if not err <= 1e-5:
        raise AssertionError(f"VS scores differ from the oracle's by {err}")
    phase("VS check", t0,
          f"records == plain top-k of mapped scores; ids == oracle's as a "
          f"set; max_abs_score_err={err}; best={float(scores[0])} "
          f"(molecule {int(ids[0])})")
    return rec


# ---------------------------------------------------------------------------
# slice 4: hymba-1.5b (hybrid attention + SSM) serving at full width
# ---------------------------------------------------------------------------

HYBRID_ARCH = "hymba-1.5b"
HYMBA_PARAMS = 1_342_006_400     # the reference's init_lm leaves, counted
SSM_REPLACES = "src/repro/kernels/ssm_scan/kernel.py:72"
SSM_SOURCE = "src/repro_torch/csrc/ssm_scan.cu"
# kernel vs plain version: both accumulate in f32, in another order (the
# projection's sum over d, the sum over n); hold y and h within 1e-3 of
# their largest magnitude
SSM_TOL_FRAC = 1e-3


def ssm_bound(b: int, t: int, d: int, n: int, itemsize: int):
    """Least time for the scan on these inputs: xc and x_proj read once
    (their type), dt_bias, a_log and h0 once, y and h written once (f32),
    over HBM bandwidth; against the operations at the CUDA cores' f32
    peak: 2 a multiply-add of the projection (2n+1 columns), 5 a channel
    and step (dt * x and softplus's add, exp, log1p, max) and 7 a state
    and step (-A * dt, exp, dt * x * B, a * h + bx, h * C summed)."""
    cols = 2 * n + 1
    nbytes = (itemsize * (b * t * d + d * cols) + 4 * (d + d * n + b * d * n)
              + 4 * (b * t * d + b * d * n))
    ops = 2 * b * t * d * cols + 5 * b * t * d + 7 * b * t * d * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOP_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ssm_inputs(dev, g, b, t, d, n, dtype, carried: bool):
    """Inputs shaped like the model's: xc a SiLU output, x_proj at the
    init's 1/sqrt(d) scale, dt_bias and a_log near the init's, h0 zero
    (a prefill) or carried (a decode step)."""
    import torch

    def rn(*shape):
        return torch.randn(shape, device=dev, generator=g)

    xc = torch.nn.functional.silu(rn(b, t, d)).to(dtype)
    x_proj = (rn(d, 2 * n + 1) / d ** 0.5).to(dtype)
    dt_bias = 0.5 * rn(d)
    a_log = torch.log(torch.arange(1, n + 1, device=dev,
                                   dtype=torch.float32)).repeat(d, 1) \
        + 0.1 * rn(d, n)
    h0 = 0.3 * rn(b, d, n) if carried else torch.zeros((b, d, n),
                                                       device=dev)
    return xc, x_proj, dt_bias, a_log, h0


def ssm_compare(name, got, want) -> tuple:
    """(max abs error, its fraction of the largest |value|) over y and h;
    raises past SSM_TOL_FRAC."""
    err = frac = 0.0
    for what, a, b in zip(("y", "h"), got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"ssm {name} {what}: {a.dtype}"
                                 f"{tuple(a.shape)} vs {b.dtype}"
                                 f"{tuple(b.shape)}")
        e = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not e <= SSM_TOL_FRAC * scale:
            raise AssertionError(f"ssm {name} {what}: max abs err {e} > "
                                 f"{SSM_TOL_FRAC} x {scale}")
        err, frac = max(err, e), max(frac, e / max(scale, 1e-30))
    return err, frac


def ssm_kernel_phase(dev, d: int, n: int) -> dict:
    """SSM kernel vs its plain version at hymba's prefill and decode
    shapes and on edge cases; times kernel and plain version."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as smod
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, t, d, n, xc dtype, carried h0
        ("prefill", BATCH, PROMPT, d, n, bf16, False),
        ("decode", BATCH, 1, d, n, bf16, True),
        ("prefill f32", BATCH, PROMPT, d, n, f32, False),
        ("odd T=33", 2, 33, d, n, bf16, True),
        ("T=100", 1, 100, d, n, f32, True),
        ("d=1001 (not a multiple of the block)", 3, 50, 1001, n, bf16, True),
        ("n=2", 2, 40, 37, 2, f32, True),
        ("n=4", 2, 40, 37, 4, bf16, True),
        ("n=8", 2, 40, 37, 8, f32, True),
        ("n=5 (not a power of two)", 1, 17, 9, 5, f32, True),
    ]
    g = torch.Generator(device=dev).manual_seed(51)
    errs, fracs, keep = {}, {}, {}
    for name, b, t, dd, nn, dt, carried in cases:
        t0 = time.perf_counter()
        args = ssm_inputs(dev, g, b, t, dd, nn, dt, carried)
        before = smod.LAUNCHES
        got = smod.ssm_scan_kernel(*args)
        torch.cuda.synchronize()
        if smod.LAUNCHES - before != 1:
            raise AssertionError(f"ssm {name}: "
                                 f"{smod.LAUNCHES - before} launches")
        errs[name], fracs[name] = ssm_compare(name, got, ssm_scan_ref(*args))
        phase(f"ssm check {name}", t0,
              f"xc={tuple(args[0].shape)} {dt} n={nn} carried_h0={carried}"
              f" max_abs_err={errs[name]} frac_of_max={fracs[name]:.3e}"
              f" tol_frac={SSM_TOL_FRAC}")
        if name in ("prefill", "decode"):
            keep[name] = args
    # two halves chained through h == one pass
    t0 = time.perf_counter()
    xc, x_proj, dt_bias, a_log, h0 = ssm_inputs(dev, g, 2, 300, d, n, bf16,
                                                True)
    y, h = smod.ssm_scan_kernel(xc, x_proj, dt_bias, a_log, h0)
    y1, h1 = smod.ssm_scan_kernel(xc[:, :137].contiguous(), x_proj,
                                  dt_bias, a_log, h0)
    y2, h2 = smod.ssm_scan_kernel(xc[:, 137:].contiguous(), x_proj,
                                  dt_bias, a_log, h1)
    errs["chained"], fracs["chained"] = ssm_compare(
        "chained halves", (torch.cat([y1, y2], 1), h2), (y, h))
    phase("ssm check two halves chained == one pass", t0,
          f"T=300 split at 137 max_abs_err={errs['chained']}")

    t0 = time.perf_counter()
    args = keep["prefill"]
    ms = cuda_ms(lambda: smod.ssm_scan_kernel(*args))
    plain = cuda_ms(lambda: ssm_scan_ref(*args), reps=2, warmup=1)
    ms_dec = cuda_ms(lambda: smod.ssm_scan_kernel(*keep["decode"]), reps=50)
    plain_dec = cuda_ms(lambda: ssm_scan_ref(*keep["decode"]))
    bnd, by = ssm_bound(BATCH, PROMPT, d, n, 2)
    bnd_dec, by_dec = ssm_bound(BATCH, 1, d, n, 2)
    phase("ssm timing", t0,
          f"prefill xc={tuple(args[0].shape)} bf16 kernel_ms={ms:.4f} "
          f"plain_ms={plain:.4f} bound_ms={bnd:.4f} ({by}); decode "
          f"kernel_ms={ms_dec:.4f} plain_ms={plain_dec:.4f} "
          f"bound_ms={bnd_dec:.6f} ({by_dec}); library: none")
    return {"name": "ssm_scan", "route": "cuda", "source": SSM_SOURCE,
            "replaces": SSM_REPLACES, "launches": None,
            "max_abs_err": max(errs.values()),
            "max_err_frac_of_max": max(fracs.values()), "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None,
            "library": "none: no single PyTorch call computes a selective "
                       "scan",
            "decode_ms": ms_dec, "decode_plain_ms": plain_dec,
            "decode_bound_ms": bnd_dec}


def hybrid_slice(seed: int) -> dict:
    """SSM kernel checks, then hymba serving at full width; returns the
    SSM kernel's JSON record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    cfg = get_config(HYBRID_ARCH)
    L = cfg.num_layers
    windows = [tf.layer_window(cfg, i) for i in range(L)]
    rec = ssm_kernel_phase(dev, cfg.d_model * max(cfg.ssm_expand, 1),
                           cfg.ssm_state)
    # flash at hymba's prefill: GQA group 5, head_dim 64, window 1024 on
    # the sliding-window layers and none on the global ones
    g = torch.Generator(device=dev).manual_seed(52)
    for w in (cfg.window, None):
        flash_check(dev, g, f"hymba window={w}", BATCH, cfg.num_heads,
                    cfg.num_kv_heads, PROMPT, PROMPT, cfg.hd,
                    torch.bfloat16, True, w)
    torch.cuda.empty_cache()

    # the main path: the serving entry, every launch counter read around it
    argv = ["--model-smoke", "--arch", HYBRID_ARCH, "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--seed",
            str(seed), "--device", "cuda"]
    args = serve.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    run = serve.model_smoke(args)
    # the SSM kernel once per layer in the prefill and in each of GEN - 1
    # decode steps; flash once per layer in the prefill
    launches = read_launches(HYBRID_ARCH, {"ssm_scan": L * GEN,
                                           "flash_attention": L})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params = sum(p.numel() for p in run.params.parameters())
    for line in serve.report_lines(args, run):
        print(line, flush=True)
    phase("serve --model-smoke", t0,
          f"arch={HYBRID_ARCH} layers={L} windows={windows} params={params}"
          f" batch={BATCH} prompt={PROMPT} gen={GEN} "
          f"prefill_ms={run.prefill_s * 1e3:.3f} "
          f"decode_ms_per_token={run.decode_s_per_token * 1e3:.3f} "
          f"peak_mem_gb={peak_gb:.3f} launches={json.dumps(launches)}")
    if params != HYMBA_PARAMS:
        raise AssertionError(f"{params} parameters, expected {HYMBA_PARAMS}")
    check_run(run, cfg)
    sizes = [c.kv.k.shape[2] for c in run.cache]
    want_sizes = [PROMPT + GEN if w is None else w for w in windows]
    if sizes != want_sizes or any(c.kv.pos != PROMPT + GEN - 1
                                  for c in run.cache):
        raise AssertionError(f"cache sizes {sizes} (want {want_sizes}) or "
                             f"positions {[c.kv.pos for c in run.cache]}")
    rec["launches"] = launches["ssm_scan"]
    warm_repeat(run)

    # one prefill and one decode step apart, each with its launches
    t0 = time.perf_counter()
    with torch.no_grad():
        reset_launches()
        logits, cache = run.model.prefill(run.params, {"tokens": run.prompt},
                                          PROMPT + 1)
        read_launches(f"{HYBRID_ARCH} prefill", {"ssm_scan": L,
                                                 "flash_attention": L})
        reset_launches()
        run.model.decode_step(run.params, cache, torch.from_numpy(
            run.generated[:, 0]).to(dev))
        read_launches(f"{HYBRID_ARCH} decode step", {"ssm_scan": L})
        del cache
    phase("prefill and decode step launches", t0,
          f"prefill ssm_scan={L} flash_attention={L}; decode step "
          f"ssm_scan={L}")
    # the bf16 checks below are taken against this f32 copy of the weights
    import copy
    from repro_torch.models import build_model
    m32 = build_model(cfg.scaled(dtype="float32"), device=dev)
    p32 = copy.deepcopy(run.params).float()
    compare_scan_routes(run, m32, p32, logits)
    del logits
    teacher_forced_hybrid(run, m32, p32)
    return rec


# The bf16 hybrid stack amplifies rounding: norm_s rescales SSM output
# rows of small RMS, so two roundings of the same computation drift apart
# layer by layer.  At full width and depth the served bf16 model's largest
# logit error against its own weights taken in f32 is 0.35-0.44 of the
# largest |logit|, through either scan route, and its teacher-forced
# decode lies 0.03-0.23 from its own forward pass, depending on the tokens
# (measured on the H100).  So the scan routes, and decode against forward,
# are held to each other on an f32 copy of the served weights, where they
# differ in summation order only (measured 3e-4 and 6e-6 of the largest
# |logit| at 32 layers): within SSM_ROUTE_TOL_FRAC.  In bf16 the kernel
# route (and decode) must lie no farther from that f32 model than the
# chunked route (and the bf16 forward pass) does, plus LOGIT_TOL_FRAC, in
# relative RMS error: over all the logits, not at the largest outlier,
# whose size depends on the tokens.
SSM_ROUTE_TOL_FRAC = 1e-2


def scan_route_prefill(model, params, prompt, impl: str, path: str):
    """One prefill with the SSM scan's route named (the kernel, or the
    reference's chunked scan in its place), launches read around it."""
    import torch
    from repro_torch.models import ssm as ssm_lib
    L = model.cfg.num_layers
    kernel_route = ssm_lib.resolve_scan_impl
    try:
        ssm_lib.resolve_scan_impl = lambda device: impl
        reset_launches()
        with torch.no_grad():
            logits, _ = model.prefill(params, {"tokens": prompt}, PROMPT)
        read_launches(path, {"ssm_scan": L if impl == "kernel" else 0,
                             "flash_attention": L})
    finally:
        ssm_lib.resolve_scan_impl = kernel_route
    return logits


def rel_rms(a, b) -> float:
    """||a - b|| / ||b|| over all elements, in f32, one batch row at a
    time."""
    num = sum(float(((x.float() - y.float()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.float() ** 2).sum()) for y in b)
    return (num / den) ** 0.5


def hold_to_f32(what: str, f32_diff: float, scale: float, bf16_own: float,
                bf16_ref: float) -> None:
    """Raise unless the f32 pair agrees within SSM_ROUTE_TOL_FRAC of the
    largest |logit| and the bf16 path under test lies within LOGIT_TOL_FRAC
    of the bf16 reference path's relative RMS error (``bf16_own``,
    ``bf16_ref``: each against the f32 model)."""
    if not f32_diff <= SSM_ROUTE_TOL_FRAC * scale:
        raise AssertionError(f"{what}, f32: differ by {f32_diff} (> "
                             f"{SSM_ROUTE_TOL_FRAC} x {scale})")
    if not bf16_own <= bf16_ref + LOGIT_TOL_FRAC:
        raise AssertionError(f"{what}, bf16: relative RMS error {bf16_own} "
                             f"against the f32 model, the reference path's "
                             f"{bf16_ref} (+ {LOGIT_TOL_FRAC} allowed)")


def compare_scan_routes(run, m32, p32, bf16_kernel_logits) -> None:
    """The prefill through the SSM kernel against the same prefill with
    the reference's chunked scan in its place, held to each other on the
    f32 copy and to the f32 model in bf16 (see SSM_ROUTE_TOL_FRAC)."""
    import torch
    t0 = time.perf_counter()
    bf16_chunked = scan_route_prefill(run.model, run.params, run.prompt,
                                      "chunked",
                                      f"{HYBRID_ARCH} prefill, chunked scan")
    f32_kernel = scan_route_prefill(m32, p32, run.prompt, "kernel",
                                    f"{HYBRID_ARCH} prefill f32")
    f32_chunked = scan_route_prefill(m32, p32, run.prompt, "chunked",
                                     f"{HYBRID_ARCH} prefill f32, chunked "
                                     f"scan")
    scale = max_abs(f32_chunked)
    f32_diff = max_abs_diff(f32_kernel, f32_chunked)
    del f32_kernel
    bf16 = {"kernel": bf16_kernel_logits, "chunked": bf16_chunked}
    rms = {k: rel_rms(v, f32_chunked) for k, v in bf16.items()}
    worst = {k: max_abs_diff(v, f32_chunked) for k, v in bf16.items()}
    bf16_diff = max_abs_diff(bf16_kernel_logits, bf16_chunked)
    del f32_chunked, bf16_chunked, bf16
    torch.cuda.empty_cache()
    hold_to_f32("prefill, SSM kernel vs chunked scan", f32_diff, scale,
                rms["kernel"], rms["chunked"])
    phase("prefill SSM kernel vs chunked scan", t0,
          f"f32: max_abs_diff={f32_diff} max_abs_logit={scale} "
          f"frac={f32_diff / scale:.3e} tol_frac={SSM_ROUTE_TOL_FRAC}; "
          f"bf16 to f32 rel_rms: kernel={rms['kernel']:.5f} chunked="
          f"{rms['chunked']:.5f} (tol +{LOGIT_TOL_FRAC}); bf16 to f32 "
          f"max_abs: kernel={worst['kernel']} chunked={worst['chunked']}; "
          f"bf16 kernel vs chunked max_abs={bf16_diff}")


def teacher_forced_hybrid(run, m32, p32) -> None:
    """Teacher-forced decode (SSM kernel at T = 1 from the carried state,
    ring caches) against the forward pass on the same tokens: on the f32
    copy within SSM_ROUTE_TOL_FRAC, and in bf16 no farther from the f32
    forward pass than the bf16 forward pass is, plus LOGIT_TOL_FRAC."""
    import torch
    t0 = time.perf_counter()
    forced = torch.from_numpy(run.generated[:, :TEACHER_FORCED]).to(
        run.prompt.device)
    toks = torch.cat([run.prompt, forced], dim=1)

    def decode_logits(model, params):
        """[prefill's last logits, the decode steps' logits]."""
        out = []
        lg, cache = model.prefill(params, {"tokens": toks[:, :PROMPT]},
                                  PROMPT + TEACHER_FORCED)
        out.append(lg[:, -1])
        del lg
        for t in range(TEACHER_FORCED):
            lg, cache = model.decode_step(params, cache, toks[:, PROMPT + t])
            out.append(lg)
        return torch.stack(out, dim=1)          # [B, 1 + steps, V]

    with torch.no_grad():
        full32 = m32.forward(p32, {"tokens": toks})[:, PROMPT - 1:]
        dec32 = decode_logits(m32, p32)
        full16 = run.model.forward(run.params, {"tokens": toks})[
            :, PROMPT - 1:]
        dec16 = decode_logits(run.model, run.params)
    scale = max_abs(full32)
    f32_diff = max_abs_diff(dec32, full32)
    rms = {"decode": rel_rms(dec16, full32),
           "forward": rel_rms(full16, full32)}
    bf16_diff = max_abs_diff(dec16, full16)
    del full32, dec32, full16, dec16
    hold_to_f32("teacher-forced decode vs forward", f32_diff, scale,
                rms["decode"], rms["forward"])
    phase("teacher-forced decode vs forward", t0,
          f"steps={TEACHER_FORCED} f32: max_abs_diff={f32_diff} "
          f"max_abs_logit={scale} frac={f32_diff / scale:.3e}; bf16 to f32 "
          f"rel_rms: decode={rms['decode']:.5f} forward="
          f"{rms['forward']:.5f} (tol +{LOGIT_TOL_FRAC}); bf16 decode vs "
          f"forward max_abs={bf16_diff} (frac {bf16_diff / scale:.4f})")


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
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = [mod.LIBRARY for mod in kernel_modules().values()]
    paths = build.build_all(libs, verbose=True)
    phase("build kernels", t0, " ".join(
        f"{lib.name}_nvcc_s={build.BUILD_SECONDS.get(lib.name, 0.0):.3f}"
        for lib in libs) + f" libs={[str(p) for p in paths]}")

    records = [kmer_slice(args.seed)]
    torch.cuda.empty_cache()
    records += lm_slice(args.seed)
    torch.cuda.empty_cache()
    records.append(moe_slice(args.seed))
    torch.cuda.empty_cache()
    records.append(vs_slice(args.seed))
    torch.cuda.empty_cache()
    records.append(hybrid_slice(args.seed))
    for rec in records:
        rec["launches_by_path"] = {
            path: got[rec["name"]] for path, got in PATH_LAUNCHES.items()
            if got.get(rec["name"])}

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    phase("nvidia-smi", t0)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
