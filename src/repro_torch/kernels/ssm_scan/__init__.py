"""Selective scan: the public ops (the fused route and the dt route), the
CUDA kernel and its plain versions, and the fused route's gradient (the
backward kernel and its plain version)."""
from repro_torch.kernels.ssm_scan.backward import ssm_scan_bwd_kernel
from repro_torch.kernels.ssm_scan.kernel import (ssm_scan_dt_kernel,
                                                 ssm_scan_kernel)
from repro_torch.kernels.ssm_scan.ops import (SSMScan, ssm_scan_dt,
                                              ssm_scan_fused)
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref,
                                              ssm_scan_dt_ref, ssm_scan_ref)

__all__ = ["SSMScan", "ssm_scan_bwd_kernel", "ssm_scan_bwd_ref",
           "ssm_scan_dt", "ssm_scan_dt_kernel", "ssm_scan_dt_ref",
           "ssm_scan_fused", "ssm_scan_kernel", "ssm_scan_ref"]
