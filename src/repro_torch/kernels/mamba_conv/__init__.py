"""The published Mamba-1 mixer's causal conv + bias + SiLU: its CUDA
kernel and plain version."""
from repro_torch.kernels.mamba_conv.kernel import mamba_conv
from repro_torch.kernels.mamba_conv.ref import mamba_conv_ref

__all__ = ["mamba_conv", "mamba_conv_ref"]
