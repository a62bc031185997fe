"""First-call autotuner for segment reduce.

``segment_reduce(..., use_kernel=None)`` does not hardcode a strategy on
the CPU: the first time a problem shape is seen there,
:func:`pick_strategy` runs every eligible implementation on synthetic
data of that exact shape, times a few warm repetitions each, and caches
the winner per

    (device type, op, n, num_keys, leaf signature)

where the leaf signature is the tuple of ``(trailing shape, dtype)`` per
value leaf.  The cost is paid once per shape and process.

Candidates (a report row's ``candidate`` label):

* ``scatter`` — :func:`~.ref.segment_reduce_ref`, one scatter per leaf;
* ``fused`` — :func:`~.ref.segment_reduce_fused`, one ``index_add_`` per
  value dtype;
* ``sorted`` — :func:`~.ref.segment_reduce_sorted`, stable sort +
  cumulative sum + boundary difference (integer leaves only).

On CUDA nothing is measured: a sum takes the kernel (``kernel.py``) on
the route and key tile its own :func:`~.kernel.route` and
:func:`~.kernel.key_block` pick, as the reference takes its Pallas kernel
on a TPU.  The plain candidates are not offered there, so a sum on card
tensors never quietly skips the kernel.  A candidate that raises is
skipped, as in the reference, and the skip is recorded in its report row.

Environment knob ``REPRO_SEGMENT_AUTOTUNE=0``: no measurement, the
static choice — the kernel on CUDA, ``fused`` elsewhere.

:func:`tune_report` lists everything measured this process (the chosen
strategy and every candidate's ms).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import tree
from repro_torch.obs import TRACER

_WARMUP = 1
_REPS = 3

# guards the cache and the report; never held while a candidate runs
_LOCK = threading.Lock()
_CACHE: Dict[Tuple, str] = {}
_REPORT: List[Dict[str, Any]] = []


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def leaf_signature(values: Any) -> Tuple:
    return tuple((tuple(leaf.shape[1:]), _dtype_name(leaf.dtype))
                 for leaf in tree.leaves(values))


def _cache_key(device_type: str, op: str, n: int, num_keys: int,
               leaf_sig: Tuple) -> Tuple:
    return (device_type, op, n, num_keys, leaf_sig)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _all_int_leaves(leaf_sig: Tuple) -> bool:
    for _, name in leaf_sig:
        dt = _torch_dtype(name)
        if dt.is_floating_point or dt.is_complex or dt == torch.bool:
            return False
    return True


def candidates(leaf_sig: Tuple) -> List[str]:
    """The strategies timed for a sum of these leaves (off CUDA)."""
    cands = ["fused", "scatter"]
    if _all_int_leaves(leaf_sig):
        cands.append("sorted")
    return cands


def static_choice(device_type: str) -> str:
    """The choice without measurement: the kernel on CUDA (as the
    reference picks ``tiled`` on a TPU), ``fused`` elsewhere."""
    return "kernel" if device_type == "cuda" else "fused"


def _synthetic(n: int, num_keys: int, leaf_sig: Tuple):
    """A sample problem of the traced shapes on the CPU: keys on a
    golden-ratio stride (every strategy sees realistic scatter conflicts;
    no RNG, so tuning is deterministic per shape), values of ones, all
    valid."""
    idx = torch.arange(n, dtype=torch.int64)
    keys = ((idx * 2654435761) % max(num_keys, 1)).to(torch.int32)
    leaves = tuple(torch.ones((n,) + tuple(shape), dtype=_torch_dtype(name))
                   for shape, name in leaf_sig)
    valid = torch.ones((n,), dtype=torch.bool)
    return keys, leaves, valid


def _time_ms(fn: Callable[[], Any]) -> float:
    """Mean host-clock ms of ``fn`` over ``_REPS`` calls after
    ``_WARMUP``."""
    for _ in range(_WARMUP):
        fn()
    t0 = time.perf_counter()
    for _ in range(_REPS):
        fn()
    return (time.perf_counter() - t0) * 1e3 / _REPS


def pick_strategy(op: str, n: int, num_keys: int, values: Any,
                  device: Optional[torch.device] = None) -> str:
    """Return the strategy for this problem shape on ``device`` (default:
    the first value leaf's).

    Non-sum monoids always resolve to ``scatter``; a sum on CUDA to the
    kernel.  Elsewhere the choice is measured once per (device type, op,
    shape signature) and cached for the process.  Concurrent first calls
    of one shape may each measure; the first to finish is kept.
    """
    if op != "sum":
        return "scatter"
    leaves = tree.leaves(values)
    dev = torch.device(device if device is not None else
                       (leaves[0].device if leaves else "cpu"))
    if (dev.type != "cpu" or n == 0
            or os.environ.get("REPRO_SEGMENT_AUTOTUNE") == "0"):
        return static_choice(dev.type)
    leaf_sig = leaf_signature(values)
    key = _cache_key(dev.type, op, n, num_keys, leaf_sig)
    with _LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        return hit
    choice, entry = _measure(op, n, num_keys, leaf_sig)
    with _LOCK:
        if key not in _CACHE:
            _CACHE[key] = choice
            _REPORT.append(entry)
        return _CACHE[key]


def _measure(op: str, n: int, num_keys: int, leaf_sig: Tuple
             ) -> Tuple[str, Dict[str, Any]]:
    from repro_torch.kernels.segment_reduce import ops
    keys, leaves, valid = _synthetic(n, num_keys, leaf_sig)
    rows: List[Dict[str, Any]] = []
    best: Optional[Tuple[float, str]] = None
    with TRACER.span("segment_reduce.autotune", n=n, num_keys=num_keys,
                     device="cpu"):
        for strategy in candidates(leaf_sig):
            def run(_s=strategy):
                return ops.segment_reduce_impl(keys, leaves, num_keys, op=op,
                                               valid=valid, strategy=_s)
            try:
                ms = _time_ms(run)
            except Exception as e:   # a candidate may not apply
                rows.append({"candidate": strategy, "ms": None,
                             "skipped": f"{type(e).__name__}: {e}"})
                continue
            rows.append({"candidate": strategy, "ms": round(ms, 4)})
            if best is None or ms < best[0]:
                best = (ms, strategy)
    choice = best[1] if best else "scatter"
    return choice, {
        "device": "cpu", "op": op, "n": n, "num_keys": num_keys,
        "leaves": [[list(shape), name] for shape, name in leaf_sig],
        "chosen": choice, "candidates": rows,
    }


def tune_report() -> List[Dict[str, Any]]:
    """Everything measured this process: one entry per distinct shape with
    the chosen strategy and all candidate timings (JSON-serializable)."""
    with _LOCK:
        return list(_REPORT)


def clear_cache() -> None:
    """Drop tuning decisions and the report (tests use this for
    isolation)."""
    with _LOCK:
        _CACHE.clear()
        _REPORT.clear()
