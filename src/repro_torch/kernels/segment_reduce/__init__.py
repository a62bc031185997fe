"""Segment reduce: the keyed-aggregation primitive and its CUDA kernel."""
from repro_torch.kernels.segment_reduce.kernel import segment_sum
from repro_torch.kernels.segment_reduce.ops import (STRATEGIES,
                                                    resolve_strategy,
                                                    resolve_use_kernel,
                                                    segment_reduce)
from repro_torch.kernels.segment_reduce.ref import (MONOIDS,
                                                    SegmentReduceResult,
                                                    monoid_identity,
                                                    segment_reduce_ref,
                                                    segment_sum_ref)

__all__ = ["segment_reduce", "segment_reduce_ref", "segment_sum",
           "segment_sum_ref", "resolve_use_kernel", "resolve_strategy",
           "STRATEGIES", "SegmentReduceResult", "MONOIDS",
           "monoid_identity"]
