#!/usr/bin/env python3
"""Where the time of one virtual-screening action goes, on one GPU.

    python3 tools/torch_vs_profile.py [--seed 0] [--reps 5]

Builds ``chip_smoke.py``'s library (2,097,152 molecules x 16 float32
features in 8 logical shards) on ``cuda``, runs the paper's Listing 2
action (``map(tools/fred) -> reduce(toolbox/topk, k=30, depth=2) ->
collect()``) once to warm up (kernel build, plan cache), then:

* times ``--reps`` warm actions (``ActionReport.wall_s``: host clock
  around work that ends in a device synchronise) and prints each one's
  phases;
* runs one more action with the ``toolbox/topk`` calls recorded: prints
  each call's size (the 8 shard combines and the tree combines of
  ``tree_reduce.split_factors(8, 2)``), keeps the first call's inputs at
  each size, and times the top-k kernel's wrapper and ``torch.topk`` on
  them, by CUDA-graph replay (device time) and back to back (the host's
  launch cost included), beside the bound (``chip_smoke.topk_bound``);
* profiles one more action with ``torch.profiler`` (CPU + CUDA) and
  prints the device time by kernel, the device busy share of the
  profiled action's wall time and of the warm median wall (the profiler
  slows the host, not the device), and the top-k kernels' device time
  split into shard and tree calls (the kernels of each call follow each
  other on the stream, and each call's first kernel is its first level,
  ``topk_tile<true>``, or the one-launch ``topk_select``);
* writes the Chrome trace to ``chiprun_out/torch_vs_trace.json``.

Runs on any version of the port that keeps ``chip_smoke``'s library,
pipeline and timing helpers (a parent commit too: copy this file into its
tree).  Prints the card's name and power limit beside the numbers.  Needs
a CUDA device.
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

#: Device kernels of a top-k call, and those that open a call (its first
#: level on the tree route, the only kernel on the select route).
TOPK_KERNELS = ("topk_tile", "topk_select")
CALL_STARTS = ("topk_tile<true>", "topk_select")


def recorder(fn, log: list, keep: dict):
    """``fn`` (the top-k op) that also appends each call's (n, k) to
    ``log`` and keeps clones of the first call's inputs at each n in
    ``keep`` (when ``keep`` is not None)."""
    def topk_reduce(scores, k, valid_count=None):
        n = scores.shape[0]
        log.append((n, k))
        if keep is not None and n not in keep:
            keep[n] = (scores.clone(), k, valid_count.clone())
        return fn(scores, k, valid_count)
    return topk_reduce


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_vs_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import MaRe
    from repro_torch.core import images
    from repro_torch.kernels.topk_reduce import kernel as tmod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    library = cs.make_library(cs.VS_MOLECULES, args.seed)
    ds = MaRe(library, num_shards=cs.NUM_SHARDS, device=dev).dataset
    torch.cuda.synchronize()

    def action():
        chain = cs.virtual_screening(ds, top=cs.VS_TOP)
        chain.collect(shard=0)
        return chain.report()

    action()                                   # warm-up
    walls = []
    for i in range(args.reps):
        rep = action()
        walls.append(rep.wall_s)
        print(f"warm action {i}: wall_s={rep.wall_s:.6f} "
              f"phases={json.dumps(rep.phases)}")
    median = sorted(walls)[len(walls) // 2]
    print(f"warm walls: median_s={median:.6f} min_s={min(walls):.6f} "
          f"max_s={max(walls):.6f}")

    # every toolbox/topk call's size, and the first call's inputs at each
    real = images.topk_reduce
    log: list = []
    keep: dict = {}
    images.topk_reduce = recorder(real, log, keep)
    try:
        action()
    finally:
        images.topk_reduce = real
    print(f"topk calls: {len(log)} sizes (n, k) in order: {log}")
    for n, (scores, k, vc) in sorted(keep.items(), reverse=True):
        what = "shard" if n == log[0][0] else "tree"
        def kern(s=scores, k=k, v=vc):
            return tmod.topk_reduce_kernel(s, k, v)

        def lib(s=scores, k=k):
            return torch.topk(s, k)

        bnd, by = cs.topk_bound(n, k)
        print(f"topk {what} n={n} k={k} valid_count={int(vc)}: kernel "
              f"graph_ms={cs.graph_ms(kern):.5f} back_to_back_ms="
              f"{cs.cuda_ms(kern):.5f}; torch.topk graph_ms="
              f"{cs.graph_ms(lib):.5f} back_to_back_ms="
              f"{cs.cuda_ms(lib):.5f}; bound_ms={bnd:.6f} ({by})")
    del keep

    tmod.reset_launches()
    log.clear()
    images.topk_reduce = recorder(real, log, None)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            action()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        images.topk_reduce = real
    # device-side events only: an aten op's row repeats the time of the
    # kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    topk_us = sum(e.self_device_time_total for e in rows
                  if any(s in e.key for s in TOPK_KERNELS))
    by_route = getattr(tmod, "LAUNCHES_BY_ROUTE", None)
    print(f"profiled action: wall_s={wall:.6f} device_busy_s="
          f"{busy_us / 1e6:.6f} busy_share={busy_us / 1e6 / wall:.4f} "
          f"kernel_launches={sum(e.count for e in rows)} "
          f"topk_ms={topk_us / 1e3:.4f} "
          f"topk_share_of_device={topk_us / max(busy_us, 1):.4f} "
          f"busy_share_of_warm_median={busy_us / 1e6 / median:.4f} "
          f"topk_calls={len(log)} topk_launches={tmod.LAUNCHES}"
          + (f" by_route={json.dumps(by_route)}" if by_route else ""))

    # split by call: the top-k kernels in stream order, a call opening at
    # each of its first-level kernels
    seg = sorted((e for e in prof.events() if e.device_type == cuda
                  and any(s in e.name for s in TOPK_KERNELS)),
                 key=lambda e: e.time_range.start)
    calls: list = []
    for e in seg:
        if any(s in e.name for s in CALL_STARTS) or not calls:
            calls.append([])
        calls[-1].append(e)
    if len(calls) != len(log):
        raise RuntimeError(f"{len(calls)} top-k calls on the device for "
                           f"{len(log)} on the host")
    split: dict = {}
    for (n, _), group in zip(log, calls):
        what = "shard" if n == log[0][0] else "tree"
        c, us, sizes, kernels = split.get(what, (0, 0.0, set(), 0))
        split[what] = (c + 1, us + sum(e.time_range.elapsed_us()
                                       for e in group),
                       sizes | {n}, kernels + len(group))
    for what, (c, us, sizes, kernels) in split.items():
        print(f"topk {what}: calls={c} kernels={kernels} device_ms="
              f"{us / 1e3:.4f} per_call_ms={us / 1e3 / c:.5f} "
              f"n={sorted(sizes)}")
    print(f"{'device_ms':>10} {'calls':>6}  kernel")
    for e in rows[:20]:
        print(f"{e.self_device_time_total / 1e3:>10.3f} {e.count:>6}  "
              f"{e.key[:100]}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "torch_vs_trace.json"))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
