#!/usr/bin/env python3
"""Where the time of one SNP-calling action goes, on one GPU.

    python3 tools/torch_snp_profile.py [--reps 5]

Builds ``chip_smoke.py``'s read library (2,097,152 reads x 16 float32
features, seed 3, in 8 logical shards) on ``cuda``, runs the paper's
Listing 3 action (``map(tools/bwa) -> repartition_by(chromosome) ->
map(tools/gatk) -> reduce(toolbox/concat, depth=2) -> collect(shard=0)``)
once to warm up (plan cache), then:

* times ``--reps`` warm actions (``ActionReport.wall_s``: host clock
  around work that ends in a device synchronise) and prints each one's
  phases;
* profiles one more action with ``torch.profiler`` (CPU + CUDA) and
  prints the device time by kernel, grouped by what it does (matrix
  products, sorts, gathers and scatters, copies, elementwise and
  reductions), and the device busy share of the profiled action's wall
  and of the warm median wall (the profiler slows the host, not the
  device);
* writes the Chrome trace to ``chiprun_out/torch_snp_trace.json``.

The action launches none of the port's kernels.  Prints the card's name
and power limit beside the numbers.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

#: Device kernels by group: the first group whose word a kernel's name
#: holds takes it.
GROUPS = (("matmul", ("gemm", "sgemm", "cutlass", "xmma")),
          ("sort", ("sort", "Sort", "radix", "Radix")),
          ("gather/scatter", ("index", "gather", "scatter", "Index")),
          ("copy", ("copy", "Memcpy", "Memset", "fill")),
          ("reduce", ("reduce", "Reduce", "sum")))


def group_of(name: str) -> str:
    for group, words in GROUPS:
        if any(w in name for w in words):
            return group
    return "elementwise/other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_snp_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import MaRe

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    library = cs.make_library(cs.SNP_READS, cs.SNP_SEED)
    ds = MaRe(library, num_shards=cs.NUM_SHARDS, device=dev).dataset
    torch.cuda.synchronize()

    def action():
        chain = cs.snp_calling(ds)
        out = chain.collect(shard=0)
        return chain.report(), len(out[2])

    action()                                   # warm-up
    walls = []
    for i in range(args.reps):
        rep, n = action()
        walls.append(rep.wall_s)
        print(f"warm action {i}: wall_s={rep.wall_s:.6f} variants={n} "
              f"phases={json.dumps(rep.phases)}")
    median = sorted(walls)[len(walls) // 2]
    print(f"warm walls: median_s={median:.6f} min_s={min(walls):.6f} "
          f"max_s={max(walls):.6f}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        action()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: an aten op's row repeats the time of the
    # kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    groups: dict = {}
    for e in rows:
        g = group_of(e.key)
        us, count = groups.get(g, (0.0, 0))
        groups[g] = (us + e.self_device_time_total, count + e.count)
    print(f"profiled action: wall_s={wall:.6f} device_busy_s="
          f"{busy_us / 1e6:.6f} busy_share={busy_us / 1e6 / wall:.4f} "
          f"busy_share_of_warm_median={busy_us / 1e6 / median:.4f} "
          f"kernel_launches={sum(e.count for e in rows)}")
    for g, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"group {g}: device_ms={us / 1e3:.4f} launches={count} "
              f"share_of_device={us / max(busy_us, 1):.4f}")
    print(f"{'device_ms':>10} {'calls':>6}  kernel")
    for e in rows[:20]:
        print(f"{e.self_device_time_total / 1e3:>10.3f} {e.count:>6}  "
              f"{e.key[:100]}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "torch_snp_trace.json"))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
