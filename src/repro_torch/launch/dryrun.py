"""Dry run: count every (arch x shape) cell's work on the production
mesh and record the roofline inputs (the reference's
``launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun               # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod   # 512

Each cell's step runs once on the meta device: the one entry point of
the port that allocates nothing (as the reference's lowers for host
devices), so it runs on any machine, with or without a GPU.  Results
append to reports/dryrun_torch.jsonl (one JSON a cell).
"""
import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.configs import (ARCH_IDS, get_config, get_shape,
                                 shape_skip_reason)
from repro_torch.launch.dryrun_lib import dry_run_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train.step import StepConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grad-sync", default="fused")
    ap.add_argument("--moe-mode", default="weight_gather")
    ap.add_argument("--out", default="reports/dryrun_torch.jsonl")
    ap.add_argument("--no-collectives", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    print(f"mesh: {dict(mesh.shape)} ({mesh.size} shards)", flush=True)

    archs = args.arch or list(ARCH_IDS)
    shapes = args.shape or ["train_4k", "prefill_32k", "decode_32k",
                            "long_500k"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            shape = get_shape(shape_name)
            reason = shape_skip_reason(cfg, shape)
            if reason:
                print(f"SKIP {arch} x {shape_name}: {reason}", flush=True)
                continue
            print(f"RUN  {arch} x {shape_name} ...", flush=True)
            t0 = time.monotonic()
            try:
                res = dry_run_cell(
                    cfg, shape, mesh,
                    extract_collectives=not args.no_collectives,
                    step_cfg=StepConfig(grad_sync=args.grad_sync,
                                        moe_mode=args.moe_mode))
                res["multi_pod"] = args.multi_pod
                res["tag"] = args.tag
                res["grad_sync"] = args.grad_sync
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")
                coll = res["collectives"]
                print(f"  ok in {time.monotonic() - t0:.1f}s  "
                      f"flops/dev={res['flops']:.3e} "
                      f"bytes/dev={res['bytes']:.3e} "
                      f"coll_wire={coll['wire_bytes'] if coll else 0:.3e}",
                      flush=True)
                mem = res["memory"]
                print(f"  mem: args={mem['argument_bytes']:.3e} "
                      f"peak={mem['peak_bytes']:.3e}", flush=True)
            except Exception as e:
                failures.append((arch, shape_name, repr(e)))
                print(f"  FAIL {arch} x {shape_name}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nALL CELLS COUNTED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
