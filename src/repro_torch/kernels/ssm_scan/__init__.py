"""Selective scan: the public op, its CUDA kernel and plain version, and
its gradient (the backward kernel and its plain version)."""
from repro_torch.kernels.ssm_scan.backward import ssm_scan_bwd_kernel
from repro_torch.kernels.ssm_scan.kernel import ssm_scan_kernel
from repro_torch.kernels.ssm_scan.ops import SSMScan, ssm_scan_fused
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

__all__ = ["SSMScan", "ssm_scan_bwd_kernel", "ssm_scan_bwd_ref",
           "ssm_scan_fused", "ssm_scan_kernel", "ssm_scan_ref"]
