#!/usr/bin/env python3
"""Where the time of one Jamba request goes on one GPU, by the program's
layer spans.

    python3 tools/torch_jamba_profile.py [--seed N] [--actions 2]
        [--prompt 65536] [--device cuda] [--tiny]

Sets up the benchmark cell ``jamba.prompt64k`` (``portbench``'s
``lm_request`` kind: the seeded weights of ``jamba2-mini-stage`` loaded
into the port), warms up one request, then runs ``--actions`` requests
under ``torch.profiler`` with the program's profiler sink on
(``repro_torch.obs.tracing(profiler=True)``), and prints one JSON line:
the device busy share of the traced window; the device ms a request
under each span's annotations (``lm.prefill``, ``lm.decode_step``,
``lm.mamba``, ``lm.moe``, ``lm.attention``; each layer also split into
its prefill and decode parts), the device ms under none of the three
layer spans (dense MLPs, norms, embedding and head), the scan kernels'
and the flash kernel's device ms; the top kernels and the idle gaps by
what the host was doing; the ``lm.*`` and ``moe.*`` counters the traced
requests added; and the card's name and power limit.  ``--tiny``
(with ``--device cpu``) runs the cell at the CPU tests' tiny widths, to
rehearse the tool without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

LAYERS = ("lm.mamba", "lm.moe", "lm.attention")
#: The CPU tests' tiny widths (``portbench/tests/test_portbench_lm_request``)
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 96, "num_experts": 4,
        "mamba_d_state": 8, "mamba_dt_rank": 8, "vocab_size": 256,
        "dtype": "float32"}
PHASES = ("lm.prefill", "lm.decode_step")


def intersect(a, b):
    """The intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--actions", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=65536)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import devtrace, harness, layerspans
    from portbench.devtrace import union
    from repro_torch import obs

    over = {"traffic": {"prompt_tokens": args.prompt}}
    if args.tiny:
        over["config"] = TINY
    _, config, traffic, kind = harness.resolve(
        harness.benchmark(), "jamba.prompt64k", over)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    session = kind.setup(config, traffic, args.seed, dev)
    session.action()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    before = obs.METRICS.snapshot()
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with obs.tracing(profiler=True), record_function(devtrace.WINDOW):
            for _ in range(args.actions):
                with record_function(devtrace.ACTION):
                    session.action()
    after = obs.METRICS.snapshot()
    trace, spans = layerspans.parse(layerspans.events_of(prof),
                                    args.actions)
    busy = union(trace.device)

    def cover(ivs):
        """The merged cover of (start, end) pairs."""
        return union([(s, e, "") for s, e in ivs])

    def under(ivs) -> float:
        return 1e3 * layerspans.overlap(busy, cover(ivs)) / args.actions

    marks = {n: cover([(s, e) for s, e, m in spans.device if m == n])
             for n in LAYERS + PHASES}
    out = {"busy_share": trace.busy_s / trace.window_s,
           "window_ms_per_request": 1e3 * trace.window_s / args.actions,
           "device_ms": {n: under(marks[n]) for n in LAYERS + PHASES}}
    for layer in LAYERS:
        for phase in PHASES:
            out["device_ms"][f"{layer} in {phase}"] = under(
                intersect(marks[layer], marks[phase]))
    spanned = cover([iv for n in LAYERS for iv in marks[n]])
    out["device_ms"]["outside the layer spans"] = \
        1e3 * (trace.busy_s - layerspans.overlap(busy, spanned)) \
        / args.actions
    out["device_ms"]["ssm scan kernels"] = 1e3 * trace.seconds(
        lambda n: n.startswith("ssm_")) / args.actions
    out["device_ms"]["mamba conv kernels"] = 1e3 * trace.seconds(
        lambda n: n.startswith("mamba_conv")) / args.actions
    out["device_ms"]["flash_fwd_wgmma"] = 1e3 * trace.seconds(
        lambda n: n == "flash_fwd_wgmma") / args.actions
    out["breakdown"] = trace.breakdown(15)
    out["counters"] = {k: after[k] - before.get(k, 0) for k in after
                       if k.startswith(("lm.", "moe."))
                       and isinstance(after[k], (int, float))}
    out["spans_seen"] = sorted({n for _, _, n in spans.host})
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
