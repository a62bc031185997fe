"""Published peaks of the cards the benchmark may run on.

NVIDIA's H100 data sheet, SXM part, dense rates without sparsity, at the
full power limit of 700 W.  A card set below it runs slower under load:
the harness prints the power limit beside every share of these peaks.
"""
from __future__ import annotations

from typing import Optional

#: By the name ``torch.cuda.get_device_name()`` gives: the SXM part
#: reports its memory as HBM3 (the PCIe part has HBM2e at 2.0 TB/s).
PEAKS = {
    "H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                       "bf16_flops": 989e12, "fp8_flops": 1979e12,
                       "tf32_flops": 495e12, "fp32_flops": 67e12},
}


def peak(device_kind: str, what: str) -> Optional[float]:
    """The peak ``what`` of the card named ``device_kind``, or None for a
    card (or the CPU) the table does not hold."""
    for model, rates in PEAKS.items():
        if model in device_kind:
            return rates[what]
    return None
