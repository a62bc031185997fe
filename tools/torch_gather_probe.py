#!/usr/bin/env python3
"""The result gather's copy to the host on one GPU: the host link's rates,
the gather against the device-cat + pageable path it replaced, and the
caching host allocator's pool over a benchmark window.

    python3 tools/torch_gather_probe.py [--reps 20] [--kmer-seconds 0]

* **Link**: one 60 MB device-to-host copy into pinned memory (CUDA
  events), into fresh pageable memory (``.cpu()``) and into pageable
  memory already touched (host clock around a synchronous copy); median
  of ``--reps``.
* **Gather**: an 8-shard table of three int32 leaves (the k-mer answer's
  form) at answer sizes from 64 rows to 15M: ``collect`` copying a shard
  at a time, concatenating on the card first, and as committed
  (``dataset.CAT_BELOW_BYTES``), and ``collect_shard(0)``, each against
  the old path (the valid slices concatenated on the card, then
  ``.cpu().numpy()``), in turns, each answer dropped before the next;
  median walls on the host clock, the answer compared bit for bit.
* **Pool**: ``torch.cuda.host_memory_stats()`` (where this torch has it)
  after the gathers; with ``--kmer-seconds S`` instead of all the above,
  before and after a window of ``S`` seconds of ``portbench``'s
  ``kmer12.collect`` cell run through its harness (seed 1234567891,
  untraced).

Prints the card's name and power limit first.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (collect, collect_shard, dataset,  # noqa: E402
                               from_numpy, tree)

SIZES = (64, 1024, 16_384, 65_536, 131_072, 262_144, 524_288, 1_048_576,
         4_194_304, 15_000_000)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def old_gather(ds, shard=None):
    """The gather as it was: the shards' valid slices concatenated on the
    card, then copied to fresh pageable host memory."""
    counts = ds.counts.cpu().numpy()
    cap = ds.capacity
    shards = range(ds.num_shards) if shard is None else [shard]

    def one(leaf):
        return torch.cat([leaf[s * cap:s * cap + int(counts[s])]
                          for s in shards]).cpu().numpy()

    return tree.tree_map(one, ds.records)


def host_stats() -> dict:
    fn = getattr(torch.cuda, "host_memory_stats", None)
    if fn is None:
        return {}
    keep = ("allocated_bytes.current", "reserved_bytes.current",
            "reserved_bytes.peak", "num_host_alloc", "num_host_free",
            "host_alloc_time.total", "host_free_time.total")
    stats = fn()
    return {k: stats[k] for k in keep if k in stats}


def link(reps: int) -> None:
    n = 60_000_000 // 4
    src = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                        device="cuda")
    pinned = torch.empty(n, dtype=torch.int32, pin_memory=True)
    touched = torch.from_numpy(np.ones(n, np.int32))
    pin_ms, fresh_ms, touched_ms = [], [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        pinned.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        pin_ms.append(a.elapsed_time(b))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = src.cpu()
        fresh_ms.append(1e3 * (time.perf_counter() - t0))
        del fresh
        t0 = time.perf_counter()
        touched.copy_(src)
        touched_ms.append(1e3 * (time.perf_counter() - t0))
    assert torch.equal(pinned, touched)
    for name, ms in (("pinned", pin_ms), ("pageable fresh", fresh_ms),
                     ("pageable touched", touched_ms)):
        med = statistics.median(ms)
        print(f"[link] 60 MB DtoH {name}: median {med:.3f} ms "
              f"({60 / med:.2f} GB/s), min {min(ms):.3f}", flush=True)


def table(rows: int, seed: int):
    cap = -(-rows // 8)
    counts = np.full(8, cap, np.int32)
    counts[-1] = rows - 7 * cap
    rng = np.random.default_rng(seed)
    recs = tuple(rng.integers(-2**31, 2**31, 8 * cap).astype(np.int32)
                 for _ in range(3))
    return from_numpy((recs[0], (recs[1],), recs[2]), counts, 8,
                      device="cuda")


def timed(fn) -> float:
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    del out
    return 1e3 * wall


def gathers(reps: int) -> None:
    """Each size: ``collect`` with every leaf copied a shard at a time
    (``CAT_BELOW_BYTES`` 0), with every leaf concatenated on the card
    first and copied once (``CAT_BELOW_BYTES`` above the leaf), as
    committed, and the old path; ``collect_shard(0)`` as committed and
    the old path.  In turns, each answer dropped before the next."""
    committed = dataset.CAT_BELOW_BYTES
    for rows in SIZES:
        ds = table(rows, rows)
        want = old_gather(ds)
        variants = {"per-shard": (0, lambda: collect(ds)),
                    "cat": (1 << 62, lambda: collect(ds)),
                    "committed": (committed, lambda: collect(ds)),
                    "old": (committed, lambda: old_gather(ds)),
                    "shard0": (committed, lambda: collect_shard(ds, 0)),
                    "shard0-old": (committed, lambda: old_gather(ds, 0))}
        times = {name: [] for name in variants}
        for _ in range(reps + 2):
            for name, (cat_below, fn) in variants.items():
                dataset.CAT_BELOW_BYTES = cat_below
                times[name].append(timed(fn))
        dataset.CAT_BELOW_BYTES = committed
        got = collect(ds)
        same = all(x.tobytes() == y.tobytes()
                   for x, y in zip(tree.leaves(got), tree.leaves(want)))
        del got, want
        med = {name: statistics.median(t[2:]) for name, t in times.items()}
        print(f"[gather] rows {rows} leaf bytes {4 * rows} equal {same}: "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in med.items())
              + " ms", flush=True)
        del ds
        torch.cuda.empty_cache()
    print(f"[pool] after the gathers: {host_stats()}", flush=True)


def kmer_window(seconds: float) -> None:
    from portbench import harness
    before = host_stats()
    line = harness.run_cell("kmer12.collect", 1234567891, seconds, False)
    print(f"[pool] kmer12.collect {seconds} s window: before {before}, "
          f"after {host_stats()}", flush=True)
    print(f"[pool] kmer12.collect correct {line['correct']} metrics "
          f"{line['metrics']}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kmer-seconds", type=float, default=0.0)
    args = ap.parse_args()
    print(f"card: {card()}; torch {torch.__version__}", flush=True)
    if args.kmer_seconds > 0:
        kmer_window(args.kmer_seconds)
        return 0
    link(args.reps)
    gathers(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
