"""RMSNorm: the public op, its CUDA kernel and plain version."""
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_kernel", "rmsnorm_ref"]
