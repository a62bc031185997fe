"""Optimizers, schedules, clipping and the int8 codec: the reference's
``optim/`` on PyTorch, over the port's parameter trees."""
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import (Optimizer, apply_updates, cast_state,
                                    named_tree)
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           error_feedback_compress)
from repro_torch.optim.schedule import constant, cosine_warmup, linear_warmup

__all__ = ["Optimizer", "apply_updates", "cast_state", "named_tree",
           "adamw", "adafactor", "clip_by_global_norm", "global_norm",
           "cosine_warmup", "linear_warmup", "constant", "compress_int8",
           "decompress_int8", "error_feedback_compress"]
