"""Trainer loop: checkpoint/restart fault tolerance + failure injection
(the reference's ``train/trainer.py``).

The loop is restart-oriented: ``FailureInjector`` lets tests kill
arbitrary steps; ``run`` catches that failure (``InjectedFailure``),
restores the last checkpoint and replays from it.  Any other error
propagates: the port's updates change the parameters in place, so a step
that failed partway may have left a half-updated state that must not be
replayed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.train.step import TrainState


class InjectedFailure(RuntimeError):
    """The failure ``FailureInjector`` raises, before a step starts."""


class FailureInjector:
    """Deterministically fail at given steps (once each)."""

    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    max_restarts: int = 3


class Trainer:
    def __init__(self, train_step: Callable, state: TrainState,
                 batches: Optional[Iterator], manager: CheckpointManager,
                 cfg: TrainerConfig = TrainerConfig(),
                 injector: Optional[FailureInjector] = None,
                 batch_fn: Optional[Callable[[int], Any]] = None):
        """``batches``: iterator of batches; OR ``batch_fn(step)`` for
        deterministic replay after restart (preferred for fault
        tolerance — an iterator cannot rewind)."""
        self.train_step = train_step
        self.state = state
        self.batches = batches
        self.batch_fn = batch_fn
        self.manager = manager
        self.cfg = cfg
        self.injector = injector or FailureInjector()
        self.history: List[Dict[str, float]] = []
        self.restarts = 0

    def _batch_for(self, step: int):
        if self.batch_fn is not None:
            return self.batch_fn(step)
        return next(self.batches)

    def run(self) -> TrainState:
        while True:
            try:
                self._run_from(int(self.state.step))
                break
            except InjectedFailure as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                latest = self.manager.latest_step()
                if latest is None:
                    # no checkpoint yet: the injector fires before the
                    # step touches the state, so replay from it as it is
                    continue
                self.manager.wait()
                self.state = self.manager.restore(self.state)
                print(f"[trainer] restart #{self.restarts} from step "
                      f"{int(self.state.step)} after: {e}")
        self.manager.wait()
        return self.state

    def _run_from(self, start: int):
        for step in range(start, self.cfg.total_steps):
            self.injector.maybe_fail(step)
            batch = self._batch_for(step)
            t0 = time.monotonic()
            self.state, metrics = self.train_step(self.state, batch)
            if (step + 1) % self.cfg.log_every == 0 or step == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                m["dt"] = time.monotonic() - t0
                self.history.append(m)
                print(f"[trainer] step {step+1} "
                      + " ".join(f"{k}={v:.4g}" for k, v in m.items()
                                 if k != "step"))
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.manager.save(step + 1, self.state)
