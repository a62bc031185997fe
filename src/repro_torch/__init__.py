"""repro_torch — the MaRe reproduction ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``: the same
MapReduce-oriented primitives over containers, with the reference's
device mesh replaced by logical shards on one CUDA device, and the dense
LM serving path (``models/``, ``launch/serve.py``).  Each Pallas kernel
on those paths is replaced by a hand-written CUDA kernel for Hopper
(``repro_torch/csrc/``: segment sum, flash attention, RMSNorm).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from repro_torch.core import MaRe, PlanTypeError, TextFile, BinaryFiles

__all__ = ["MaRe", "PlanTypeError", "TextFile", "BinaryFiles"]
