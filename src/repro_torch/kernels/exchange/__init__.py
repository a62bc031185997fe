"""The exchange of repartitionBy over the logical shards of one device:
the public op, its CUDA kernel and plain version."""
from repro_torch.kernels.exchange.kernel import exchange, route
from repro_torch.kernels.exchange.ref import (Exchanged, exchange_ref,
                                              hash_keys)

__all__ = ["Exchanged", "exchange", "exchange_ref", "hash_keys", "route"]
