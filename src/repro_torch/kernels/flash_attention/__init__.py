"""Flash attention: the public op, its CUDA kernel and plain versions."""
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                    flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_kernel", "attention_ref",
           "flash_attention_plain"]
