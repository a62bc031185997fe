"""Selective scan: the public op, its CUDA kernel and plain version."""
from repro_torch.kernels.ssm_scan.kernel import ssm_scan_kernel
from repro_torch.kernels.ssm_scan.ops import ssm_scan_fused
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = ["ssm_scan_fused", "ssm_scan_kernel", "ssm_scan_ref"]
