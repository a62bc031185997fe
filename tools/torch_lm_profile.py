#!/usr/bin/env python3
"""Where the time of LM serving goes, on one GPU.

    python3 tools/torch_lm_profile.py [--arch llama3.2-1b] [--seed 0]
        [--reps 3] [--steps 16]

Builds the port's model for ``--arch`` (``llama3.2-1b``,
``granite-moe-1b-a400m``, ``hymba-1.5b``, ``internvl2-1b`` or
``whisper-base``) at full width (random weights from the seed, bf16) on
``cuda`` with ``chip_smoke.py``'s serving shape (batch 4, prompt 2048;
internvl2 with 256 random patch embeddings before it; whisper with 1,500
random encoder frames and a 416-token prompt), warms up one prefill and
two decode steps, then:

* times ``--reps`` warm prefills and ``--reps`` runs of ``--steps``
  greedy decode steps (host clock around work that ends in a device
  synchronise);
* for an MoE arch, records the dispatch calls of one prefill and one
  decode step (their sizes printed), and times the dispatch kernel's
  wrapper, the plain version and the library (``torch.sort(stable=True)``
  + ``torch.bincount``; by graph replay ``index_add_`` in place of
  ``bincount``, which no graph captures) on the first call's ids of each,
  by CUDA-graph replay (device time) and back to back (the host's launch
  cost included), beside the bound (``chip_smoke.dispatch_bound``);
* profiles one prefill and, apart, ``--steps`` decode steps with
  ``torch.profiler`` (CPU + CUDA) and prints for each the device time by
  kernel, the device busy share of the wall time, the device time of the
  port's kernels (flash attention, MoE dispatch, selective scan), of
  matrix products and of device-to-host copies, and the host time spent
  waiting on the device (``cudaStreamSynchronize``, ``cudaMemcpyAsync``:
  the MoE layers' per-layer read of the expert sizes);
* writes the Chrome traces, gzipped, to ``chiprun_out/torch_lm_<arch>_
  {prefill,decode}_trace.json.gz``.

Prints the card's name and power limit beside the numbers.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


#: Device kernels by what they do, matched on the kernel's name.
GROUPS = {
    # flash_fwd_wgmma (bf16 at head dims 64, 128) and flash_fwd (others)
    "flash_attention": ("flash_fwd_wgmma", "flash_fwd"),
    # cluster route: one kernel; tiled route: three passes
    "moe_dispatch": ("dispatch_cluster", "tile_rank", "scan_tiles",
                     "add_base"),
    # chunked route: projection (tensor cores for bf16, CUDA cores for
    # f32), chunk ends, carries and re-run; step route: one fused kernel
    "ssm_scan": ("ssm_proj_mma", "ssm_proj_rows", "ssm_chunk_end",
                 "ssm_chunk_carry", "ssm_chunk_scan", "ssm_step"),
    "matmul": ("gemm", "nvjet", "cutlass", "sm90_xmma"),
    "memcpy_dtoh": ("Memcpy DtoH",),
}
#: Host-side CUDA runtime calls that wait for the device or copy to it.
HOST_WAITS = ("cudaStreamSynchronize", "cudaMemcpyAsync",
              "cudaDeviceSynchronize")


def profile(name, fn, out_dir):
    """Run ``fn`` once under the profiler; print wall, device busy share,
    device time by kernel and by group, and the host's waits."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: an aten op's row repeats the time of the
    # kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    print(f"profiled {name}: wall_s={wall:.6f} device_busy_s="
          f"{busy_us / 1e6:.6f} busy_share={busy_us / 1e6 / wall:.4f} "
          f"kernel_launches={launches}")
    for group, keys in GROUPS.items():
        sel = [e for e in rows if any(k in e.key for k in keys)]
        us = sum(e.self_device_time_total for e in sel)
        print(f"  {group}: device_ms={us / 1e3:.3f} calls="
              f"{sum(e.count for e in sel)} share_of_device="
              f"{us / max(busy_us, 1):.4f}")
    for e in prof.key_averages():
        if e.key in HOST_WAITS:
            print(f"  host {e.key}: calls={e.count} cpu_ms="
                  f"{e.cpu_time_total / 1e3:.3f}")
    print(f"{'device_ms':>10} {'calls':>6}  kernel")
    for e in rows[:15]:
        print(f"{e.self_device_time_total / 1e3:>10.3f} {e.count:>6}  "
              f"{e.key[:100]}")
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"torch_lm_{name}_trace.json.gz"))


def recorder(fn, log: list):
    """``fn`` (the MoE layer's dispatch) that also appends a clone of
    each call's ids, as the kernel takes them, and its group count to
    ``log``."""
    def moe_dispatch(assignments, num_groups):
        import torch
        log.append((assignments.reshape(-1).to(torch.int32).contiguous()
                    .clone(), num_groups))
        return fn(assignments, num_groups)
    return moe_dispatch


def time_dispatch(cs, what, log) -> None:
    """The dispatch's calls of one prefill or decode step, and its time
    on the first call's ids: the kernel's wrapper, the plain version and
    the library (``torch.sort(stable=True)`` + ``torch.bincount``), each
    by graph replay and back to back.  ``torch.bincount`` reads the ids'
    largest value on the host, so no graph can capture it: by graph
    replay the library's counts are ``index_add_`` of ones into zeros."""
    import torch
    from repro_torch.kernels.moe_dispatch import kernel as dmod
    from repro_torch.kernels.moe_dispatch.ref import dispatch_ref
    a, g = log[0]
    n = a.numel()
    ones = torch.ones_like(a)

    def sort_index_add():
        return (torch.sort(a, stable=True),
                torch.zeros((g,), dtype=torch.int32,
                            device=a.device).index_add_(0, a, ones))

    def sort_bincount():
        return torch.sort(a, stable=True), torch.bincount(a, minlength=g)

    bnd, by = cs.dispatch_bound(n, g)
    sizes = sorted({x.numel() for x, _ in log})
    print(f"dispatch {what}: calls={len(log)} n={sizes} groups={g} "
          f"bound_ms={bnd:.7f} ({by})")
    for name, fn in (("kernel", lambda: dmod.moe_dispatch_kernel(a, g)),
                     ("plain", lambda: dispatch_ref(a, g))):
        print(f"  {name}: graph_ms={cs.graph_ms(fn):.5f} "
              f"back_to_back_ms={cs.cuda_ms(fn):.5f}")
    print(f"  library: sort+index_add_ graph_ms="
          f"{cs.graph_ms(sort_index_add):.5f} back_to_back_ms="
          f"{cs.cuda_ms(sort_index_add):.5f}; sort+bincount "
          f"back_to_back_ms={cs.cuda_ms(sort_bincount):.5f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=["llama3.2-1b", "granite-moe-1b-a400m",
                             "hymba-1.5b", "internvl2-1b", "whisper-base"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_lm_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"arch: {args.arch}")
    cfg = get_config(args.arch)
    model = build_model(cfg, device="cuda")
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    prompt_len = cs.AUDIO_PROMPT if cfg.family == "audio" else cs.PROMPT
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (cs.BATCH, prompt_len))).cuda()}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.normal(size=(
            cs.BATCH, cfg.encoder_seq, cfg.d_model))).to("cuda",
                                                          cfg.param_dtype)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.normal(size=(
            cs.BATCH, cfg.num_patches, cfg.d_model))).to("cuda",
                                                          cfg.param_dtype)
    max_len = cs.patch_positions(cfg) + prompt_len + args.steps + 2

    def prefill():
        return model.prefill(params, batch, max_len)

    def decode(cache, tok, steps):
        for _ in range(steps):
            lg, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(lg, dim=-1)
        return cache, tok

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        logits, cache = prefill()                        # warm-up
        tok = torch.argmax(logits[:, -1], dim=-1)
        decode(cache, tok, 2)
        torch.cuda.synchronize()
        for i in range(args.reps):
            t0 = time.perf_counter()
            logits, cache = prefill()
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            t0 = time.perf_counter()
            decode(cache, tok, args.steps)
            torch.cuda.synchronize()
            t_dec = (time.perf_counter() - t0) / args.steps
            print(f"warm rep {i}: prefill_ms={t_pre * 1e3:.3f} "
                  f"decode_ms_per_token={t_dec * 1e3:.3f}")
        if getattr(cfg, "num_experts", 0):
            from repro_torch.models import moe as moe_lib
            real = moe_lib.moe_dispatch
            for what in ("prefill", "decode step"):
                log: list = []
                moe_lib.moe_dispatch = recorder(real, log)
                try:
                    if what == "prefill":
                        prefill()
                    else:
                        decode(cache, tok, 1)
                finally:
                    moe_lib.moe_dispatch = real
                time_dispatch(cs, what, log)
            logits, cache = prefill()
        profile(f"{args.arch}_prefill", prefill, out_dir)
        logits, cache = prefill()
        profile(f"{args.arch}_decode", lambda: decode(cache, tok, args.steps),
                out_dir)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
