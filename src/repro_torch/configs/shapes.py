"""The four assigned input-shape cells (LM-family shape set)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode | long_decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "long_decode", 524_288, 1)

SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                   LONG_500K)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")
