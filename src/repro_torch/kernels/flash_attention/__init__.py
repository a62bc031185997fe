"""Flash attention: the public op, its CUDA kernels (forward and backward)
and plain versions."""
from repro_torch.kernels.flash_attention.backward import \
    flash_attention_bwd_kernel
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                    flash_attention_bwd_plain,
                                                    flash_attention_plain)

__all__ = ["FlashAttention", "flash_attention", "flash_attention_kernel",
           "flash_attention_bwd_kernel", "attention_ref",
           "flash_attention_plain", "flash_attention_bwd_plain"]
