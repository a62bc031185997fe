#!/usr/bin/env python3
"""Where the time of one chr21-scale k-mer action goes, on one GPU.

    python3 tools/torch_kmer_profile.py [--seed 0] [--reps 3]

Builds the same synthetic GRCh38-chr21-sized genome as ``chip_smoke.py``,
ingests it into 8 logical shards on ``cuda``, runs the k-mer
``reduce_by_key`` action once to warm up (kernel build, plan cache), then:

* times ``--reps`` warm actions (host clock around work that ends in a
  device synchronise) and prints each action's phases;
* profiles one more action with ``torch.profiler`` (CPU + CUDA) and
  prints the device time by kernel, the device busy share of the action's
  wall time, and the segment-sum kernel's share of device time;
* writes the Chrome trace to ``chiprun_out/torch_kmer_trace.json``.

Prints the card's name and power limit beside the numbers.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


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

    kmod.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        action()
        wall = time.perf_counter() - t0
    # device-side events only: an aten op's row repeats the time of the
    # kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    seg_us = sum(e.self_device_time_total for e in rows
                 if "segment_sum_kernel" in e.key)
    print(f"profiled action: wall_s={wall:.6f} device_busy_s="
          f"{busy_us / 1e6:.6f} busy_share={busy_us / 1e6 / wall:.4f} "
          f"segment_sum_share_of_device={seg_us / max(busy_us, 1):.4f} "
          f"segment_sum_launches={kmod.LAUNCHES}")
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
