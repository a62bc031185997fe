"""Segment reduce: the keyed-aggregation primitive, its CUDA kernel and
its per-shape autotuner."""
from repro_torch.kernels.segment_reduce.kernel import segment_sum
from repro_torch.kernels.segment_reduce.ops import (STRATEGIES,
                                                    resolve_strategy,
                                                    resolve_use_kernel,
                                                    segment_reduce)
from repro_torch.kernels.segment_reduce.ref import (MONOIDS,
                                                    SegmentReduceResult,
                                                    monoid_identity,
                                                    segment_reduce_fused,
                                                    segment_reduce_ref,
                                                    segment_reduce_sorted,
                                                    segment_sum_ref)
from repro_torch.kernels.segment_reduce.tune import (clear_cache,
                                                     pick_strategy,
                                                     tune_report)

__all__ = ["segment_reduce", "segment_reduce_ref", "segment_reduce_fused",
           "segment_reduce_sorted", "segment_sum", "segment_sum_ref",
           "resolve_use_kernel", "resolve_strategy", "pick_strategy",
           "tune_report", "clear_cache", "STRATEGIES",
           "SegmentReduceResult", "MONOIDS", "monoid_identity"]
