"""Checkpointing (the reference's ``checkpoint/``): the manager and the
elastic rescale onto another mesh."""
from repro_torch.checkpoint.elastic import (NamedSharding, rescale,
                                            shardings_for_params)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "NamedSharding", "rescale",
           "shardings_for_params"]
