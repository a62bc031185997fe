"""MoE dispatch slotting: the public op, its CUDA kernel and plain
version."""
from repro_torch.kernels.moe_dispatch.kernel import moe_dispatch_kernel
from repro_torch.kernels.moe_dispatch.ops import moe_dispatch
from repro_torch.kernels.moe_dispatch.ref import dispatch_ref

__all__ = ["moe_dispatch", "moe_dispatch_kernel", "dispatch_ref"]
