"""Training: the step factories and the restart-oriented trainer (the
reference's ``train/`` on PyTorch, one card)."""
from repro_torch.train.step import (StepConfig, TrainState, init_train_state,
                                    make_eval_step, make_serve_steps,
                                    make_train_step)
from repro_torch.train.trainer import (FailureInjector, InjectedFailure,
                                       Trainer, TrainerConfig)

__all__ = ["StepConfig", "TrainState", "init_train_state", "make_train_step",
           "make_eval_step", "make_serve_steps", "Trainer", "TrainerConfig",
           "FailureInjector", "InjectedFailure"]
