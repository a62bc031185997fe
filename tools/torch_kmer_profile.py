#!/usr/bin/env python3
"""Where the time of one chr21-scale k-mer action goes, on one GPU.

    python3 tools/torch_kmer_profile.py [--seed 0] [--reps 3]

Builds the same synthetic GRCh38-chr21-sized genome as ``chip_smoke.py``,
ingests it into 8 logical shards on ``cuda``, runs the k-mer
``reduce_by_key`` action once to warm up (kernel build, plan cache), then:

* times ``--reps`` warm actions (host clock around work that ends in a
  device synchronise) and prints each action's phases;
* runs one more action with the segment-sum calls recorded, and keeps
  clones of the first combine's (d = 1) and the first merge's (d = 2)
  inputs: their valid share, the ascending runs of their valid keys, and
  the kernel's time on them beside the bytes bound, the plain version and
  ``index_add_`` (``chip_smoke.time_kernel``, ``chip_smoke.bound_ms``);
* profiles one more action with ``torch.profiler`` (CPU + CUDA) and
  prints the device time by kernel, the device busy share of the action's
  wall time, and the segment-sum kernels' device time split into combine
  and merge calls (the kernels of each call follow each other on the
  stream, so the i-th group of them belongs to the i-th recorded call),
  and each split by kernel, with the zero-fill kernels beside them;
* writes the Chrome trace to ``chiprun_out/torch_kmer_trace.json``.

Runs on any version of the port that keeps ``chip_smoke``'s genome and
timing helpers (a parent commit too: copy this file into its tree).
Prints the card's name and power limit beside the numbers.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

#: Device kernels of a segment-sum call: the one-thread-a-record atomic
#: kernel, and every kernel of the binned route.
SEGMENT_KERNELS = ("segment_sum_kernel", "segsum_")


def kernel_name(name: str) -> str:
    """A device kernel's bare name: ``void (anonymous namespace)::
    segsum_fold<int, 1>(...)`` -> ``segsum_fold``."""
    found = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return found.group(1) if found else name


def ascending_runs(keys, valid) -> int:
    """Ascending runs in the valid keys, in slot order (1 + descents)."""
    k = keys[valid]
    return int((k[1:] < k[:-1]).sum()) + 1 if k.numel() else 0


def recorder(fn, log: list, keep: dict):
    """``fn`` (the segment sum) that also appends each call's (n, d) to
    ``log`` and keeps clones of the first call's inputs at each d in
    ``keep`` (when ``keep`` is not None)."""
    def segment_sum(keys, values, num_keys, valid):
        n, d = values.shape
        log.append((n, d))
        if keep is not None and d not in keep:
            keep[d] = (keys.clone(), values.clone(), valid.clone(), num_keys)
        return fn(keys, values, num_keys, valid)
    return segment_sum


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_kmer_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import MaRe
    from repro_torch.io import fasta_source
    from repro_torch.kernels.segment_reduce import kernel as kmod
    from repro_torch.kernels.segment_reduce import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    with tempfile.TemporaryDirectory(prefix="kmer_profile_") as tmp:
        fasta = os.path.join(tmp, "chr21.fa")
        cs.write_fasta(fasta, cs.make_genome(cs.CHR21_BASES, args.seed))
        ds = MaRe.from_source(fasta_source(fasta),
                              num_shards=cs.NUM_SHARDS).dataset

    def action():
        m = (MaRe(ds).map(image="kmer-stats", command=f"kmer-stats {cs.K}")
             .reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                            op="sum"))
        out = m.dataset
        torch.cuda.synchronize()
        return m, out

    action()                                   # warm-up
    walls = []
    for i in range(args.reps):
        t0 = time.perf_counter()
        m, _ = action()
        walls.append(time.perf_counter() - t0)
        print(f"warm action {i}: wall_s={walls[-1]:.6f} "
              f"phases={json.dumps(m.report().phases)}")

    # the real inputs of a combine and of a merge
    real = ops.segment_sum
    log: list = []
    keep: dict = {}
    ops.segment_sum = recorder(real, log, keep)
    try:
        action()
    finally:
        ops.segment_sum = real
    for d, what in ((1, "combine"), (2, "merge")):
        keys, vals, valid, nk = keep[d]
        n = keys.shape[0]
        n_valid = int(valid.sum())
        ms, plain, lib = cs.time_kernel(keys, vals, valid, nk)
        print(f"real {what}: n={n} d={d} num_keys={nk} valid={n_valid} "
              f"valid_share={n_valid / n:.4f} "
              f"ascending_runs={ascending_runs(keys, valid)} "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"index_add_ms={lib:.4f} "
              f"bound_ms={cs.bound_ms(n, n_valid, d, nk):.4f}")
    del keep

    kmod.reset_launches()
    log.clear()
    ops.segment_sum = recorder(real, log, None)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            action()
            wall = time.perf_counter() - t0
    finally:
        ops.segment_sum = real
    # device-side events only: an aten op's row repeats the time of the
    # kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    seg_us = sum(e.self_device_time_total for e in rows
                 if any(s in e.key for s in SEGMENT_KERNELS))
    fill_us = sum(e.self_device_time_total for e in rows
                  if "FillFunctor" in e.key)
    by_route = getattr(kmod, "LAUNCHES_BY_ROUTE", None)
    print(f"profiled action: wall_s={wall:.6f} device_busy_s="
          f"{busy_us / 1e6:.6f} busy_share={busy_us / 1e6 / wall:.4f} "
          f"segment_sum_ms={seg_us / 1e3:.3f} "
          f"segment_sum_share_of_device={seg_us / max(busy_us, 1):.4f} "
          f"fill_ms={fill_us / 1e3:.3f} "
          f"segment_sum_calls={len(log)} "
          f"segment_sum_launches={kmod.LAUNCHES}"
          + (f" by_route={json.dumps(by_route)}" if by_route else ""))

    # split by call: the segment kernels in stream order, grouped per call
    seg = sorted((e for e in prof.events() if e.device_type == cuda
                  and any(s in e.name for s in SEGMENT_KERNELS)),
                 key=lambda e: e.time_range.start)
    per_call, rest = divmod(len(seg), max(len(log), 1))
    if rest or not per_call:
        raise RuntimeError(f"{len(seg)} segment-sum kernels for "
                           f"{len(log)} calls")
    split: dict = {}
    for i, (n, d) in enumerate(log):
        group = seg[i * per_call:(i + 1) * per_call]
        what = {1: "combine", 2: "merge"}.get(d, f"d={d}")
        calls, total, sizes, by_kernel = split.get(what, (0, 0.0, set(),
                                                          {}))
        for e in group:
            name = kernel_name(e.name)
            by_kernel[name] = by_kernel.get(name, 0.0) + \
                e.time_range.elapsed_us()
        split[what] = (calls + 1,
                       total + sum(e.time_range.elapsed_us() for e in group),
                       sizes | {n}, by_kernel)
    for what, (calls, us, sizes, by_kernel) in split.items():
        print(f"segment_sum {what}: calls={calls} kernels_per_call="
              f"{per_call} device_ms={us / 1e3:.3f} "
              f"per_call_ms={us / 1e3 / calls:.4f} n={sorted(sizes)}")
        print(f"segment_sum {what} per call by kernel (us): " + " ".join(
            f"{k}={v / calls:.1f}" for k, v in by_kernel.items()))
    print(f"{'device_ms':>10} {'calls':>6}  kernel")
    for e in rows[:20]:
        print(f"{e.self_device_time_total / 1e3:>10.3f} {e.count:>6}  "
              f"{e.key[:100]}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "torch_kmer_trace.json"))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
