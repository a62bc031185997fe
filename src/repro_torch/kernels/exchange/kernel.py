"""CUDA exchange kernel: bind and launch.

The kernel (``repro_torch/csrc/exchange.cu``) replaces no Pallas kernel:
the reference's exchange is ``lax.all_to_all`` between a stable sort into
send buffers and a compacting sort.  It hashes (or reads) each row's
destination, counts, and writes every source's valid rows straight to
their place in the receiving shards' front-compacted partitions, zero
tails included.  The source says what bounds it (bytes) and how its three
passes answer that.

:func:`exchange` takes n sources' leaves, valid counts and either keys
(destination ``hash_keys(key) % n``) or given destinations, and
:func:`route` picks its route from the device and which of the two it
got: a CPU tensor takes the plain version (:func:`~repro_torch.kernels.
exchange.ref.exchange_ref`); on CUDA the ``hash`` route hashes int32 or
int64 keys in the kernel, and the ``dests`` route reads int32
destinations.  A CUDA tensor launches its route or raises — there is no
fallback; it takes at most ``MAX_SHARDS`` sources of at most
``MAX_LEAVES`` leaves, whose pointers travel in the kernels' parameters.
A meta tensor takes the CUDA checks and empty outputs of the kernel's
shapes and dtypes, no launch.  A call on CUDA or meta reports its
function's work (:func:`repro_torch.kernels.work.exchange`, every row
taken as valid: the valid counts live on the device) to the active work
counter (:mod:`repro_torch.launch.hlo_cost`).  ``LAUNCHES`` counts calls
that launched (one a call, whatever passes it runs),
``LAUNCHES_BY_ROUTE`` splits them by route.
"""
from __future__ import annotations

import ctypes
import math
from functools import partial
from typing import Optional, Sequence

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.exchange.ref import (Exchanged, exchange_ref,
                                              hash_keys)
from repro_torch.launch import hlo_cost

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LIBRARY = KernelLibrary("exchange", "exchange.cu", {
    "exchange_launch": [_I, _I, _I, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P],
    "exchange_tile_rows": []})

#: Sources and leaves the kernels' parameters hold (``MAX_SHARDS`` and
#: ``MAX_LEAVES`` in the source): ~10 KB of pointers.
MAX_SHARDS = 64
MAX_LEAVES = 16
#: The kernel's destinations and rows are int32.
_INT_MAX = 2 ** 31 - 1
#: The source's ``Kind``: what a row's destination is read from.
KEYS_I32, KEYS_I64, DESTS_I32 = 0, 1, 2

#: Calls that launched since the last reset, in all and by route.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"hash": 0, "dests": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0


def route(device, hashed: bool) -> str:
    """The route a call takes: ``"plain"`` for a CPU tensor, ``"meta"``
    for a meta tensor; on CUDA ``"hash"`` for keys and ``"dests"`` for
    given destinations."""
    kind = torch.device(device).type
    if kind in ("cpu", "meta"):
        return "plain" if kind == "cpu" else "meta"
    return "hash" if hashed else "dests"


def _check(leaves, counts, capacity: int, by) -> None:
    n = len(leaves)
    if n < 1 or len(counts) != n or len(by) != n:
        raise ValueError(f"exchange takes as many counts and keys (or "
                         f"destinations) as sources, got {n} sources, "
                         f"{len(counts)} counts, {len(by)} keys")
    cap_in = by[0].shape[0] if by[0].ndim == 1 else -1
    if any(k.ndim != 1 or k.shape[0] != cap_in for k in by):
        raise ValueError(f"exchange takes keys (or destinations) [cap_in] "
                         f"of one length, got "
                         f"{[tuple(k.shape) for k in by]}")
    shapes = [[(tuple(x.shape), x.dtype) for x in src] for src in leaves]
    if any(s != shapes[0] for s in shapes) or any(
            shape[0] != cap_in for shape, _ in shapes[0]):
        raise ValueError(f"exchange takes sources of the same leaves, "
                         f"each [{cap_in}, ...], got {shapes}")
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    devs = {t.device for t in [*by, *counts] + [x for s in leaves
                                                for x in s]}
    if len(devs) != 1:
        raise ValueError(f"exchange inputs on several devices: {devs}")


def exchange(leaves: Sequence[Sequence[torch.Tensor]],
             counts: Sequence[torch.Tensor], capacity: int,
             keys: Optional[Sequence[torch.Tensor]] = None,
             dests: Optional[Sequence[torch.Tensor]] = None) -> Exchanged:
    """The exchange of n sources into n destinations of ``n * capacity``
    rows (see :func:`~repro_torch.kernels.exchange.ref.exchange_ref`).

    ``leaves[s]``: source s's leaves, each ``[cap_in, ...]`` (the same
    shapes and dtypes for every source), its first ``counts[s]`` rows
    valid (an int32 scalar on the same device).  Exactly one of ``keys``
    (integer ``[cap_in]``: destination ``hash_keys(key) % n``) and
    ``dests`` (integer ``[cap_in]`` in ``[0, n)``) is given.
    """
    global LAUNCHES
    if (keys is None) == (dests is None):
        raise ValueError("exchange takes one of keys and destinations")
    by = keys if keys is not None else dests
    _check(leaves, counts, capacity, by)
    n = len(leaves)
    dev = by[0].device
    kind = route(dev, keys is not None)
    if kind == "plain":
        if keys is not None:
            dests = [hash_keys(k) % n for k in keys]
        return exchange_ref(leaves, counts, capacity, dests)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"exchange runs on cpu, cuda or meta, got {dev}")
    if n > MAX_SHARDS or len(leaves[0]) > MAX_LEAVES:
        raise ValueError(f"exchange kernel takes at most {MAX_SHARDS} "
                         f"sources of at most {MAX_LEAVES} leaves, got {n} "
                         f"of {len(leaves[0])}")
    cap_in = by[0].shape[0]
    if cap_in > _INT_MAX or n * capacity > _INT_MAX:
        raise ValueError(f"exchange kernel takes int32 rows: cap_in "
                         f"{cap_in}, n * capacity {n * capacity}")
    code = DESTS_I32
    if keys is not None:
        code = (KEYS_I32 if all(k.dtype == torch.int32 for k in keys)
                else KEYS_I64)
    row_bytes = [x.element_size() * math.prod(x.shape[1:])
                 for x in leaves[0]]
    cost = partial(work.exchange, n, n * cap_in, 8 if code == KEYS_I64 else 4,
                   sum(row_bytes), capacity)
    with hlo_cost.uncounted():
        outs = [torch.empty((n, n * capacity) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=dev) for x in leaves[0]]
        scalars = [torch.empty(shape, dtype=torch.int32, device=dev)
                   for shape in ((n,), (n, n), (n,))]
        result = Exchanged(outs, *scalars)
        if dev.type == "cuda":
            by = [k.to(torch.int64 if code == KEYS_I64 else torch.int32)
                  for k in by]
            _launch(code, leaves, counts, capacity, by, result, row_bytes)
    hlo_cost.report_kernel("exchange", cost)
    if dev.type == "cuda":
        LAUNCHES += 1
        LAUNCHES_BY_ROUTE[kind] += 1
    return result


def _vec(row_bytes: int, ptrs) -> int:
    """The widest load (16, 8, 4, 2 or 1 bytes) that divides a row and
    every pointer of the leaf."""
    vec = 16
    while vec > 1 and (row_bytes % vec or any(p % vec for p in ptrs)):
        vec //= 2
    return vec


def _launch(code: int, leaves, counts, capacity: int, by,
            result: Exchanged, row_bytes) -> None:
    """Allocate the scratch and launch the kernels of ``code`` (the
    source's ``Kind``) into ``result``."""
    n, dev = len(leaves), by[0].device
    lib = LIBRARY.load()
    srcs = [[x.contiguous() for x in src] for src in leaves]
    by = [k.contiguous() for k in by]
    cnts = [c.reshape(()).to(torch.int32) for c in counts]
    tiles = max(1, cdiv(by[0].shape[0], lib.exchange_tile_rows()))
    tile_counts = torch.empty((n * n * tiles,), dtype=torch.int32,
                              device=dev)
    base = torch.empty((n * n,), dtype=torch.int32, device=dev)
    L = len(row_bytes)
    src_ptrs = [srcs[s][l].data_ptr() for l in range(L) for s in range(n)]
    out_ptrs = [o.data_ptr() for o in result.leaves]
    vecs = [_vec(row_bytes[l], src_ptrs[l * n:(l + 1) * n] + [out_ptrs[l]])
            for l in range(L)]
    with torch.cuda.device(dev):
        err = lib.exchange_launch(
            code, n, L, by[0].shape[0], capacity,
            (_P * n)(*[k.data_ptr() for k in by]),
            (_P * n)(*[c.data_ptr() for c in cnts]),
            (_P * (L * n))(*src_ptrs), (_P * L)(*out_ptrs),
            (_L * L)(*row_bytes), (_I * L)(*vecs),
            tile_counts.data_ptr(), base.data_ptr(),
            result.send_counts.data_ptr(), result.counts.data_ptr(),
            result.dropped.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("exchange", err)
