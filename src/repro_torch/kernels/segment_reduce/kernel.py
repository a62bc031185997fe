"""CUDA segment-sum kernels: build, bind and launch.

The kernels (``repro_torch/csrc/segment_sum.cu``) replace the reference's
Pallas kernel ``repro/kernels/segment_reduce/kernel.py:segment_sum_tiled``
(body ``_segment_sum_tiled_kernel``): a masked keyed sum into a bounded
table, plus per-key counts and an overflow count of valid out-of-range
keys.  The source says what bounds them and how the binned route keeps
the table's writes out of L2's way.

They are compiled at first use by the port's shared build helper
(:mod:`repro_torch.kernels.build`) into a shared library with a plain C
interface and loaded with ``ctypes``.

:func:`segment_sum` is the only entry point, and :func:`route` picks its
route from the key space, the value columns and the record count alone: a
CPU tensor takes the plain version (:func:`~repro_torch.kernels.
segment_reduce.ref.segment_sum_ref`); on CUDA the ``binned`` route
(records binned by key tile, each tile folded in shared memory and
written whole) takes every call of one to three value columns whose key
space it can tile, and the ``atomic`` route (one thread a record, global
atomics into a zero-filled table) the rest.
A CUDA tensor launches its route or raises — there is no fallback.  A
meta tensor takes ``"meta"``: the CUDA checks and empty outputs of the
kernels' shapes and dtypes, no launch.  A call on CUDA or meta reports
its function's work (:func:`repro_torch.kernels.work.segment_sum`, every
record taken as valid: the valid count lives on the device) to the
active work counter (:mod:`repro_torch.launch.hlo_cost`); the atomic
route's zero-filled outputs are part of that work, not counted apart.
``LAUNCHES`` counts calls that launched (one per call, whatever passes it
runs), so a run can show that its path went through the kernels;
``LAUNCHES_BY_ROUTE`` splits them by route.
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import KernelLibrary, check_launch
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.segment_reduce.ref import SPLIT, segment_sum_ref
from repro_torch.launch import hlo_cost

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ATOMIC_ARGS = [_P, _P, _P, _L, _I, _L, _P, _P, _P, _I, _P]
_BINNED_ARGS = [_P, _P, _P, _L, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P]
LIBRARY = KernelLibrary("segment_sum", "segment_sum.cu", {
    "segment_sum_binned_i32": _BINNED_ARGS,
    "segment_sum_binned_f32": _BINNED_ARGS,
    "segment_sum_atomic_i32": _ATOMIC_ARGS,
    "segment_sum_atomic_f32": _ATOMIC_ARGS,
    "segsum_meta_ints": [_I, _I],
    "segsum_row_words": [_I],
})

#: Shared memory a key tile of the binned route may take: key_block *
#: (d + 1) int32 words (table row and count), within the 48 KB a block
#: gets without opting in.
TILE_BYTES = 48 * 1024
#: Value columns the binned route takes: a row (key and values) is one 8-
#: or 16-byte vector.
MAX_BINNED_COLUMNS = 3
#: Most tiles the binned route takes (its per-block histograms live in
#: shared memory, 4 bytes a tile).
MAX_TILES = 8192
#: Blocks an SM in the binned route's counting pass.
BIN_BLOCKS_PER_SM = 2
_INT_MAX = 2 ** 31 - 1

#: Calls that launched since the last reset, in all and by route.
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"binned": 0, "atomic": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[name] = 0


def _widest_key_block(d: int) -> int:
    """Largest power of two of keys whose d + 1 words fit TILE_BYTES."""
    return 1 << ((TILE_BYTES // (4 * (d + 1))).bit_length() - 1)


def key_block(num_keys: int, d: int) -> int:
    """Keys a tile of the binned route holds: the widest power of two
    that fits shared memory, no wider than the key space needs."""
    return min(_widest_key_block(d), 1 << max(num_keys - 1, 0).bit_length())


def route(num_keys: int, d: int, n: int, device) -> str:
    """The route a call takes: ``"plain"`` for a CPU tensor, ``"meta"``
    for a meta tensor; on CUDA
    ``"binned"`` for 1 to ``MAX_BINNED_COLUMNS`` value columns when the
    key space needs at most ``MAX_TILES`` tiles and record positions fit
    int32, else ``"atomic"``."""
    kind = torch.device(device).type
    if kind in ("cpu", "meta"):
        return "plain" if kind == "cpu" else "meta"
    if (1 <= d <= MAX_BINNED_COLUMNS and n <= _INT_MAX
            and cdiv(num_keys, _widest_key_block(d)) <= MAX_TILES):
        return "binned"
    return "atomic"


_SUFFIX = {torch.int32: "i32", torch.float32: "f32"}


def _check(keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
           num_keys: int) -> None:
    if values.dtype not in _SUFFIX:
        raise TypeError(f"segment_sum kernel takes int32 or float32 values, "
                        f"got {values.dtype}")
    if keys.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"segment_sum kernel takes int32 keys and bool "
                        f"valid, got {keys.dtype} and {valid.dtype}")
    if values.ndim != 2 or keys.ndim != 1 or valid.shape != keys.shape \
            or values.shape[0] != keys.shape[0]:
        raise ValueError(f"segment_sum kernel takes keys [n], values [n, d] "
                         f"and valid [n], got {tuple(keys.shape)}, "
                         f"{tuple(values.shape)} and {tuple(valid.shape)}")
    devs = {keys.device, values.device, valid.device}
    if len(devs) != 1:
        raise ValueError(f"segment_sum inputs on several devices: {devs}")
    if not (keys.is_contiguous() and values.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("segment_sum kernel takes contiguous tensors")
    if num_keys < 1:
        raise ValueError(f"num_keys must be >= 1, got {num_keys}")


def segment_sum(keys: torch.Tensor, values: torch.Tensor, num_keys: int,
                valid: torch.Tensor):
    """Masked keyed sum.

    ``keys`` [n] int32, ``values`` [n, d] int32 or float32, ``valid`` [n]
    bool -> ``(table [num_keys, d], counts [num_keys] int32, overflow [1]
    int32)``.  CPU tensors take the plain version; CUDA tensors launch
    the kernels of their route (none for ``n == 0``).
    """
    global LAUNCHES
    _check(keys, values, valid, num_keys)
    dev = keys.device
    n, d = values.shape
    kind = route(num_keys, d, n, dev)
    if kind == "plain":
        return segment_sum_ref(keys, values, num_keys, valid)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"segment_sum runs on cpu, cuda or meta, got "
                         f"{dev}")
    if n == 0:
        return (torch.zeros((num_keys, d), dtype=values.dtype, device=dev),
                torch.zeros((num_keys,), dtype=torch.int32, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev))
    cost = partial(work.segment_sum, n, n, d, num_keys)
    if kind == "meta":
        hlo_cost.report_kernel("segment_sum", cost)
        return (torch.empty((num_keys, d), dtype=values.dtype, device=dev),
                torch.empty((num_keys,), dtype=torch.int32, device=dev),
                torch.empty((1,), dtype=torch.int32, device=dev))
    with hlo_cost.uncounted():
        table, counts, overflow = _launch(kind, keys, values, valid,
                                          num_keys)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[kind] += 1
    hlo_cost.report_kernel("segment_sum", cost)
    return table, counts, overflow


def _launch(kind: str, keys: torch.Tensor, values: torch.Tensor,
            valid: torch.Tensor, num_keys: int):
    """Allocate the outputs and scratch of route ``kind`` and launch it."""
    dev = keys.device
    n, d = values.shape
    lib = LIBRARY.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    suffix = _SUFFIX[values.dtype]
    ptrs = (keys.data_ptr(), values.data_ptr(), valid.data_ptr())
    with torch.cuda.device(dev):
        if kind == "binned":
            # every row of the outputs is written by the kernels
            table = torch.empty((num_keys, d), dtype=values.dtype,
                                device=dev)
            counts = torch.empty((num_keys,), dtype=torch.int32, device=dev)
            overflow = torch.empty((1,), dtype=torch.int32, device=dev)
            kb = key_block(num_keys, d)
            blocks = sms * BIN_BLOCKS_PER_SM
            meta = torch.empty((lib.segsum_meta_ints(
                blocks, cdiv(num_keys, kb)),), dtype=torch.int32, device=dev)
            # the partition's two steps: rows by bucket, then by tile
            rows = torch.empty((2, n, lib.segsum_row_words(d)),
                               dtype=torch.int32, device=dev)
            err = getattr(lib, f"segment_sum_binned_{suffix}")(
                *ptrs, n, d, num_keys, kb.bit_length() - 1, SPLIT, blocks,
                meta.data_ptr(), rows.data_ptr(), table.data_ptr(),
                counts.data_ptr(), overflow.data_ptr(), stream)
        else:
            table = torch.zeros((num_keys, d), dtype=values.dtype,
                                device=dev)
            counts = torch.zeros((num_keys,), dtype=torch.int32, device=dev)
            overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
            err = getattr(lib, f"segment_sum_atomic_{suffix}")(
                *ptrs, n, d, num_keys, table.data_ptr(), counts.data_ptr(),
                overflow.data_ptr(), sms * 16, stream)
    check_launch(f"segment_sum ({kind})", err)
    return table, counts, overflow
