#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the GPUs of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  Makes the cell's data from ``--seed``,
loads it into the port (``src/repro_torch``), warms up, issues actions
back to back for ``--seconds`` seconds, then (``--trace 1``) a few more
under ``torch.profiler``, compares the answers with the plain reference,
and prints each compared number beside its limit as the last lines on
standard error and, as the last line on standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s``, ``window_s``, and a ``breakdown``),
then ``checks``.  Exits non-zero, with no result, without a CUDA device
or with fewer than the cell asks for.

Build and kernel caches are kept under ``build/`` in the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dirs() -> None:
    """Every compiler cache the program might use, at fixed paths inside
    the checkout (the port's own nvcc builds go to ``build/repro_torch``
    by itself)."""
    base = os.path.join(ROOT, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    return args


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    args = parse(argv)
    # the checkout's root, not this script's folder, heads the path
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    from portbench import harness
    bench = harness.benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cache_dirs()
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips[args.workload]:
        print(f"portbench: {args.workload} needs {chips[args.workload]} "
              f"CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", t0=T0, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 3
    line["power_limit"] = power_limit()
    checks = line.pop("checks")
    line["checks"] = checks
    print(f"card: {line['power_limit']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
