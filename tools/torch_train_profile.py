#!/usr/bin/env python3
"""Where the time of a training step goes, on one GPU.

    python3 tools/torch_train_profile.py [--arch llama3.2-1b|hymba-1.5b]
                                         [--seed 0]

Sets up ``chip_smoke.py``'s training run of the arch through
``launch/train.py`` (full width and depth, bf16 parameters, AdamW, remat,
one repeated batch of 4 x 2,048 tokens on ``cuda``), runs steps 1-2 (for
Llama-3.2-1B with the checkpoint saved at step 2 into a temporary
directory, its write joined and flushed, as ``chip_smoke.train_run`` does;
hymba-1.5b's run saves none, as ``chip_smoke.hymba_train_run``), then runs
steps 3 and 4 each under ``torch.profiler`` (CPU + CUDA) and prints, for
each:

* the step's wall (host clock to a synchronise), the device busy share
  of it and the number of kernel launches;
* device time by group: the flash forward (``flash_fwd*``) and backward
  (``flash_bwd*``) kernels, the SSM scan's forward (``ssm_proj*``,
  ``ssm_chunk*``) and backward (``ssm_bwd*``, also split by kernel)
  kernels, matrix products (cuBLAS), device-to-host copies, and the rest;
* device time of the f32 cross-entropy over the vocabulary, forward
  and backward, and of AdamW's update, each between CUDA events recorded
  around it in the step (the backward's from the loss's gradient to the
  logits'), so they hold every kernel of the phase whatever its name;
* the 15 kernels with the most device time.

Steps 1-4's walls (without the profiler on step 1-2) and the traces
(``chiprun_out/torch_train_step{3,4}_trace.json.gz``; hymba's
``torch_train_hymba_step{3,4}_trace.json.gz``) come with it.
Prints the card's name and power limit beside the numbers.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

#: Device kernels by what they do, matched on the kernel's name.
GROUPS = {
    # flash_fwd_wgmma (bf16 at head dims 64, 128) and flash_fwd (others)
    "flash_forward": ("flash_fwd",),
    # wgmma route: prep, dkdv, dq; simt route: delta, dkdv, dq
    "flash_backward": ("flash_bwd",),
    # the chunked route's projection and chunk passes
    "ssm_scan_forward": ("ssm_proj", "ssm_chunk"),
    # ssm_bwd_scan, _group_sum, _dxc, _dw, _params
    "ssm_scan_backward": ("ssm_bwd",),
    "matmul": ("gemm", "nvjet", "cutlass", "sm90_xmma"),
    "memcpy_dtoh": ("Memcpy DtoH",),
}


#: Groups whose kernels are also printed one by one.
SPLIT = ("ssm_scan_backward",)


class _Mark:
    """CUDA events recorded around the step's phases: the cross-entropy's
    forward (``ce_fwd``), its backward (``ce_bwd``) and AdamW's update
    (``adamw``), each a (start, end) pair."""

    def __init__(self):
        import torch
        self.events = {name: (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                       for name in ("ce_fwd", "ce_bwd", "adamw")}

    def ms(self) -> dict:
        return {name: a.elapsed_time(b) for name, (a, b) in
                self.events.items()}


def _record_in_backward():
    """An identity autograd Function whose backward records an event."""
    import torch

    class Record(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, event):
            ctx.event = event
            return x.view_as(x)

        @staticmethod
        def backward(ctx, grad):
            ctx.event.record()
            return grad, None

    return Record


def instrument(marks: list):
    """Wrap ``models.transformer.cross_entropy`` so that the step's
    cross-entropy records its forward and backward events into
    ``marks[-1]``; returns a function that restores it."""
    from repro_torch.models import transformer
    real = transformer.cross_entropy
    record = _record_in_backward()

    def cross_entropy(logits, labels, mask=None):
        mark = marks[-1]
        f0, f1 = mark.events["ce_fwd"]
        b0, b1 = mark.events["ce_bwd"]
        logits = record.apply(logits, b1)   # the logits' gradient: the end
        f0.record()
        loss = real(logits, labels, mask)
        f1.record()
        return record.apply(loss, b0)       # the loss's gradient: the start

    transformer.cross_entropy = cross_entropy
    return lambda: setattr(transformer, "cross_entropy", real)


def timed_optimizer(opt, marks: list):
    """``opt`` whose update is timed between ``marks[-1]``'s events."""
    from repro_torch.optim import Optimizer

    def update(grads, state, params, lr):
        a, b = marks[-1].events["adamw"]
        a.record()
        out = opt.update(grads, state, params, lr)
        b.record()
        return out

    return Optimizer(init=opt.init, update=update)


def profile_step(name, step, state, batch, mark, out_dir):
    """One training step under the profiler; prints its breakdown and
    returns the new state."""
    import torch
    import chip_smoke as cs
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"profiled {name}: loss={float(metrics['loss']):.6f} wall_ms="
          f"{wall * 1e3:.3f} device_busy_ms={busy_us / 1e3:.3f} "
          f"busy_share={busy_us / 1e3 / (wall * 1e3):.4f} kernel_launches="
          f"{sum(e.count for e in rows)}")
    grouped = 0.0
    for group, keys in GROUPS.items():
        sel = [e for e in rows if any(k in e.key for k in keys)]
        us = sum(e.self_device_time_total for e in sel)
        grouped += us
        print(f"  {group}: device_ms={us / 1e3:.3f} calls="
              f"{sum(e.count for e in sel)} share_of_device="
              f"{us / max(busy_us, 1):.4f}")
        if group in SPLIT:
            for e in sel:
                print(f"    {cs.kernel_name(e.key)}: device_ms="
                      f"{e.self_device_time_total / 1e3:.3f} calls={e.count}")
    print(f"  other kernels: device_ms={(busy_us - grouped) / 1e3:.3f} "
          f"share_of_device={(busy_us - grouped) / max(busy_us, 1):.4f}")
    for phase, ms in mark.ms().items():
        what = {"ce_fwd": "f32 cross-entropy forward",
                "ce_bwd": "f32 cross-entropy backward",
                "adamw": "AdamW update"}[phase]
        print(f"  {what} (CUDA events): ms={ms:.3f} share_of_wall="
              f"{ms / (wall * 1e3):.4f}")
    print(f"{'device_ms':>10} {'calls':>6}  kernel")
    for e in rows[:15]:
        print(f"{e.self_device_time_total / 1e3:>10.3f} {e.count:>6}  "
              f"{e.key[:100]}")
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"torch_train_{name}_trace.json.gz"))
    return state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=("llama3.2-1b", "hymba-1.5b"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.optim.schedule import cosine_warmup
    from repro_torch.train import (StepConfig, Trainer, TrainerConfig,
                                   make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="torch_train_profile_")
    marks = [_Mark()]
    restore = instrument(marks)
    try:
        hymba = args.arch == cs.HYBRID_ARCH
        # hymba: the schedule of the four steps run here, none saved
        targs = train.parser().parse_args(
            cs.hymba_train_args(tmp, args.seed, steps=cs.TRAIN_SAVE_AT + 2)
            if hymba else cs.train_args(tmp, args.seed))
        run = train.setup(targs)
        batch = run.batch_fn(0)
        step = make_train_step(
            run.model, timed_optimizer(run.optimizer, marks),
            cosine_warmup(targs.lr, targs.warmup, targs.steps),
            StepConfig(grad_sync=targs.grad_sync,
                       microbatch=targs.microbatch))
        walls = []

        def timed(state, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            return state, metrics

        manager = CheckpointManager(tmp, keep=1)
        t0 = time.perf_counter()
        state = Trainer(timed, run.state, None, manager, TrainerConfig(
            total_steps=cs.TRAIN_SAVE_AT,
            checkpoint_every=targs.ckpt_every, log_every=1),
            batch_fn=lambda s: batch).run()
        save_s = time.perf_counter() - t0 - sum(walls) / 1e3
        t1 = time.perf_counter()
        os.sync()
        print(f"{args.arch} steps 1-{cs.TRAIN_SAVE_AT}: step_ms="
              f"{[round(w, 3) for w in walls]}; "
              + ("no checkpoint" if hymba else
                 f"checkpoint at step {cs.TRAIN_SAVE_AT}: gather and write "
                 f"{save_s:.3f} s, os.sync "
                 f"{time.perf_counter() - t1:.3f} s"))
        for n in (cs.TRAIN_SAVE_AT + 1, cs.TRAIN_SAVE_AT + 2):
            marks.append(_Mark())
            state = profile_step(("hymba_" if hymba else "") + f"step{n}",
                                 step, state, batch, marks[-1], out_dir)
    finally:
        restore()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
