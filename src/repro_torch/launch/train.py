"""Batch training entry point of the port: the reference's
``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 20 --batch 4 --seq 64 --device cpu

Builds the config (``--smoke``: the reduced, CPU-sized one), the model
with seeded random weights, AdamW with a cosine-warmup schedule, the
single-card train step (``--grad-sync fused``), a checkpoint manager and
the restart-oriented trainer, then trains on synthetic batches made from
``np.random.default_rng(seed * 100003 + step)`` and prints the
reference's ``loss a -> b`` line.  Runs on ``cuda`` unless ``--device``
names another device; without a GPU the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model, ModelConfig, build_model
from repro_torch.optim import Optimizer, adamw
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.train import (StepConfig, Trainer, TrainerConfig,
                               TrainState, init_train_state, make_train_step)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-sync", default="fused")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


@dataclasses.dataclass
class TrainSetup:
    """What a run trains with, for callers that drive the trainer."""
    cfg: ModelConfig
    model: Model
    optimizer: Optimizer
    state: TrainState
    batch_fn: Callable[[int], Dict[str, torch.Tensor]]
    train_step: Callable


def make_batch_fn(cfg: ModelConfig, batch: int, seq: int, seed: int,
                  device: torch.device) -> Callable[[int], Dict[str, Any]]:
    """The reference's synthetic batches: step ``s`` draws from
    ``np.random.default_rng(seed * 100003 + s)`` tokens, the labels as
    the tokens shifted by one, and audio frames or vlm patch embeddings
    (in the model's dtype, as the port's layers take them)."""
    def batch_fn(step: int):
        r = np.random.default_rng(seed * 100003 + step)
        b = {"tokens": r.integers(0, cfg.vocab_size,
                                  (batch, seq)).astype(np.int32)}
        b["labels"] = np.roll(b["tokens"], -1, axis=1)
        out = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        if cfg.family == "audio":
            out["frames"] = torch.from_numpy(r.normal(size=(
                batch, cfg.encoder_seq, cfg.d_model)).astype(
                    np.float32)).to(device, cfg.param_dtype)
        if cfg.family == "vlm" and cfg.num_patches:
            out["patch_embeds"] = torch.from_numpy(r.normal(size=(
                batch, cfg.num_patches, cfg.d_model)).astype(
                    np.float32)).to(device, cfg.param_dtype)
        return out
    return batch_fn


def setup(args: argparse.Namespace) -> TrainSetup:
    """The config, model, AdamW, seeded state, batches and train step of
    ``args``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    model = build_model(cfg, device=args.device)
    opt = adamw()
    state = init_train_state(model, opt, args.seed)
    step = make_train_step(
        model, opt, cosine_warmup(args.lr, args.warmup, args.steps),
        StepConfig(grad_sync=args.grad_sync, microbatch=args.microbatch))
    return TrainSetup(cfg=cfg, model=model, optimizer=opt, state=state,
                      batch_fn=make_batch_fn(cfg, args.batch, args.seq,
                                             args.seed, model.device),
                      train_step=step)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    run = setup(args)
    manager = CheckpointManager(args.ckpt_dir)
    state = run.state
    if args.resume and manager.latest_step() is not None:
        state = manager.restore(state)
        print(f"resumed from step {int(state.step)}")
    trainer = Trainer(run.train_step, state, None, manager,
                      TrainerConfig(total_steps=args.steps,
                                    checkpoint_every=args.ckpt_every,
                                    log_every=args.log_every),
                      batch_fn=run.batch_fn)
    trainer.run()
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(trainer.history, f)
    first = trainer.history[0]["loss"]
    last = trainer.history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
