"""Top-k selection: the public op, its CUDA kernel and plain version."""
from repro_torch.kernels.topk_reduce.kernel import topk_reduce_kernel
from repro_torch.kernels.topk_reduce.ops import topk_reduce
from repro_torch.kernels.topk_reduce.ref import topk_ref

__all__ = ["topk_reduce", "topk_reduce_kernel", "topk_ref"]
