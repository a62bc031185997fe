"""Checkpointing (the reference's ``checkpoint/``): the manager.  The
elastic re-shard (``elastic.py``) comes with the multi-card backend
(ROADMAP Queue 1, item 17)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
