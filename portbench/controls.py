#!/usr/bin/env python3
"""The readings that set each compared number's limit.

    python3 portbench/controls.py --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--actions 3] [--out path.jsonl]

For each seed, in one process: the cell's set-up at its own size, one
warm-up action, ``--actions`` actions of the program, and the comparison
of their answers with the plain reference (the program's readings, the
lower end of each limit); for each control seed also the control's
answers (``control`` in the cell's generator: the reference with a
guarantee broken, or the program in the precision next below the one
the configuration states) through the same comparison (the upper end).
Prints one JSON line a seed and a reading, and appends them to ``--out``.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell: str, seeds, control_seeds, actions: int,
             device: str = "cuda", overrides=None):
    """Yield ``{"seed", "side", "checks"}`` for every seed (side
    ``program``) and control seed (side ``control``)."""
    from portbench import harness
    _, config, traffic, kind = harness.resolve(harness.benchmark(), cell,
                                               overrides)
    harness.program_path()
    import torch
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in list(dict.fromkeys(list(seeds) + list(control_seeds))):
        session = kind.setup(config, traffic, seed, dev)
        session.action()
        sides = []
        if seed in seeds:
            sides.append(("program",
                          [session.action()[0] for _ in range(actions)]))
        if seed in control_seeds:
            sides.append(("control", kind.control(session, actions)))
        session.free()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for side, answers in sides:
            checks, _ = session.check(answers)
            yield {"cell": cell, "seed": seed, "side": side,
                   "checks": {k: v for k, (v, _) in checks.items()},
                   "limits": {k: lim for k, (_, lim) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--actions", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    def ints(text):
        return [int(x) for x in text.split(",") if x]
    for rec in readings(args.workload, ints(args.seeds),
                        ints(args.control_seeds), args.actions):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
