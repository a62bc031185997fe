"""Work counter of the port: the reference's ``launch/hlo_cost.py``.

The reference walks a compiled HLO module.  The port has no HLO: it runs
the function under a :class:`Counter`, a ``TorchDispatchMode`` that sees
every aten op the function runs (on CPU, CUDA or meta tensors alike, so
a step counted on the meta device allocates nothing), and it keeps the
reference's conventions:

  flops       — a matmul-family op 2 * |out| * |contracted| (+ |out| for
                the ``add`` variants), an elementwise op |out|, a
                reduction its input elements (the reference's ``reduce``
                rule), softmax and log-softmax 4 an input element and
                their gradients 3 an output element; a kernel the port
                wrote by hand reports its function's operations
                (:mod:`repro_torch.kernels.work`) where it runs on CUDA or
                meta, since a ``ctypes`` launch is invisible to the mode.
  bytes       — per op: operand + output bytes, an operand counted by the
                elements it addresses (a broadcast scalar is one
                element; a copy or fill does not read what it
                overwrites); views, reshapes, ``empty`` and host reads count
                zero; a gather counts its slice read and written, a
                scatter its update (so a consumer of a stacked weight's
                slice reads only the slice, the reference's slicing
                rule); a copy between devices counts zero (no device
                memory work of the step); a hand-written kernel reports
                its function's bytes.  Eager ops are not fused, so bytes
                count every intermediate.
  collectives — result bytes of one shard per op kind, reported by
                ``core/collectives.py`` under the reference's op names,
                and ring wire bytes with the reference's factors
                (``dryrun_lib.parse_collectives``): all-reduce
                2(n-1)/n, all-gather, reduce-scatter and all-to-all
                (n-1)/n, collective-permute 1.0, n the mesh's largest
                axis.

A Python loop is unrolled by nature: a loop of 13 bodies counts 13.
Where a loop's bodies are alike in their work — a recurrence's steps, a
mesh's shards, too many to run one by one on the meta device —
``Counter(count_loops_once=True)`` lets the code run the first, the
second and the last body and count the second for all between, forward
and backward (:class:`like_bodies`): the
port's counterpart of the reference's trip-count rule.  A backward's
nodes are found from the autograd graph (their sequence numbers) and
hooked, and a remat's recompute counts as the forward it repeats
(:func:`recomputing`).  ``unresolved_whiles`` is always 0.

Peak memory: the counter follows the storages that ops allocate while it
is active (a storage leaves when it is freed) and keeps the high-water
mark of their bytes, ``peak_bytes``; storages alive before it started
are the caller's arguments.

The counter is off unless a caller enters it, so no step pays for it
otherwise.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                "reduce-scatter": 1.0, "all-to-all": 1.0,
                "collective-permute": 1.0}

aten = torch.ops.aten

# matmul family: op -> (index of the lhs among the args, the lhs dim that
# is contracted, whether an |out| add comes with it)
_MATMUL = {
    aten.mm: (0, 1, False), aten.addmm: (1, 1, True),
    aten.bmm: (0, 2, False), aten.baddbmm: (1, 2, True),
    aten.mv: (0, 1, False), aten.addmv: (1, 1, True),
    aten.dot: (0, 0, False), aten.vdot: (0, 0, False),
}

# reductions: input elements a reduce (the reference's rule)
_REDUCE = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.prod, aten.linalg_vector_norm, aten.norm, aten.var, aten.std,
    aten.var_mean, aten.std_mean, aten.logsumexp, aten.cumsum,
    aten.cumprod, aten.argmax, aten.argmin, aten.any, aten.all,
    aten.count_nonzero, aten.aminmax,
}
_PER_INPUT = {aten._softmax: 4, aten._log_softmax: 4}
_PER_OUTPUT = {aten._softmax_backward_data: 3,
               aten._log_softmax_backward_data: 3}

_ZERO = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten._local_scalar_dense, aten.item,
    aten.lift_fresh, aten.lift_fresh_copy, aten.resize_, aten.set_,
    aten._unsafe_view, aten.is_nonzero, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.record_stream,
}

# gathers: the slice read and written plus the indices
_GATHER = {aten.index, aten.index_select, aten.gather, aten.embedding,
           aten.take}
# scatters: op -> position of the update among the args (None: a scalar
# fill, |index| elements); the update read and the region written, plus
# the indices, and |update| adds where they accumulate
_SCATTER = {
    aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
    aten.index_add: 3, aten.index_add_: 3, aten.index_copy: 3,
    aten.index_copy_: 3, aten.scatter: 3, aten.scatter_: 3,
    aten.scatter_add: 3, aten.scatter_add_: 3, aten.scatter_reduce: 3,
    aten.scatter_reduce_: 3, aten.index_fill: None,
    aten.index_fill_: None,
}
_ACCUMULATE = {aten.index_add, aten.index_add_, aten.scatter_add,
               aten.scatter_add_, aten.scatter_reduce,
               aten.scatter_reduce_}
_INDEX_DTYPES = (torch.int64, torch.int32, torch.bool, torch.uint8)
_TRANSFERS = {aten._to_copy, aten.copy_}
# ops that overwrite their first argument without reading it
_OVERWRITE = {aten.copy_, aten.fill_, aten.zero_}


def _flat(obj: Any, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _flat(x, out)
    return out


def _elems(t: torch.Tensor) -> int:
    n = 1
    for s in t.shape:
        n *= s
    return n


def nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses: a broadcast dim
    (stride 0) counts once."""
    n = t.element_size()
    for s, st in zip(t.shape, t.stride()):
        if st != 0:
            n *= s
        elif s == 0:
            return 0
    return n


def wire_factor(op: str, ring_n: int) -> float:
    """The reference's ring wire-cost factor of ``op`` over ``ring_n``
    members (``dryrun_lib.parse_collectives``)."""
    if op == "collective-permute":
        return 1.0
    n = max(int(ring_n), 1)
    return _COLL_FACTOR[op] * (n - 1) / n


class Counter(TorchDispatchMode):
    """Counts the work of everything run while it is entered.

    ``count_loops_once``: a loop of like bodies (a recurrence's steps, a
    mesh's shards) runs three of them, counted for all
    (:class:`like_bodies`)."""

    def __init__(self, count_loops_once: bool = False) -> None:
        super().__init__()
        self.count_loops_once = count_loops_once
        self.flops = 0
        self.matmul_flops = 0
        self.bytes = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.wire_bytes = 0.0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.ops = 0
        #: aten op name -> [calls, flops, bytes], for reading a count
        self.by_op: Dict[str, List[int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._paused = 0
        self._scale = 1
        self._live: Dict[int, Any] = {}

    # -- reports from the port's own code ---------------------------------

    def add_kernel(self, name: str, ops: int, nbytes_: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "ops": 0,
                                           "bytes": 0})
        k["calls"] += self._scale
        k["ops"] += ops * self._scale
        k["bytes"] += nbytes_ * self._scale
        self.flops += ops * self._scale
        self.bytes += nbytes_ * self._scale

    def add_work(self, ops: int, nbytes_: int, matmul_ops: int) -> None:
        self.flops += ops * self._scale
        self.bytes += nbytes_ * self._scale
        self.matmul_flops += matmul_ops * self._scale

    def add_collective(self, op: str, result_bytes: int, ring_n: int,
                       hbm_bytes: int = 0) -> None:
        self.bytes += hbm_bytes * self._scale
        self.coll_bytes[op] += result_bytes * self._scale
        self.coll_counts[op] += self._scale
        self.wire_bytes += wire_factor(op, ring_n) * result_bytes \
            * self._scale

    # -- the dispatch ------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _flat(args, _flat(list(kwargs.values()), []))
        outs = _flat(out, [])
        self._track(ins, outs, func)
        if not self._paused:
            self._count(func, args, ins, outs)
        return out

    def _track(self, ins, outs, func) -> None:
        if func.is_view or not outs:
            return
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            size = st.nbytes()
            self._live[key] = weakref.ref(st, self._freer(key, size))
            self.live_bytes += size
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes

    def _freer(self, key: int, size: int) -> Callable[[Any], None]:
        me = weakref.ref(self)

        def free(_):
            c = me()
            if c is not None and c._live.pop(key, None) is not None:
                c.live_bytes -= size
        return free

    def _count(self, func, args, ins, outs) -> None:
        packet = func.overloadpacket
        if func.is_view or packet in _ZERO:
            return
        if packet in _TRANSFERS and ins and outs and \
                ins[-1].device != outs[0].device:
            return
        self.ops += 1
        flops, byts = self.flops, self.bytes
        self._tally(func, args, ins, outs, packet)
        row = self.by_op.setdefault(str(packet), [0, 0, 0])
        row[0] += self._scale
        row[1] += self.flops - flops
        row[2] += self.bytes - byts

    def _tally(self, func, args, ins, outs, packet) -> None:
        s = self._scale
        out_elems = sum(_elems(t) for t in outs)
        if packet in _GATHER:
            idx = sum(nbytes(t) for t in ins[1:]
                      if t.dtype in _INDEX_DTYPES)
            self.bytes += (2 * sum(nbytes(t) for t in outs) + idx) * s
            return
        if packet in _SCATTER:
            pos = _SCATTER[packet]
            upd = args[pos] if pos is not None and len(args) > pos else None
            idx_t = [t for t in ins[1:] if t.dtype in _INDEX_DTYPES
                     and t is not upd]
            if isinstance(upd, torch.Tensor):
                ub, ue = nbytes(upd), _elems(upd)
            else:
                ue = sum(_elems(t) for t in idx_t)
                ub = ue * ins[0].element_size()
            self.bytes += (2 * ub + sum(nbytes(t) for t in idx_t)) * s
            if packet in _ACCUMULATE or (
                    packet in (aten.index_put, aten.index_put_,
                               aten._index_put_impl_)
                    and len(args) > 3 and args[3]):
                self.flops += ue * s
            return
        read = ins[1:] if packet in _OVERWRITE else ins
        self.bytes += (sum(nbytes(t) for t in read)
                       + sum(nbytes(t) for t in outs)) * s
        if packet in _MATMUL:
            pos, dim, add = _MATMUL[packet]
            f = 2 * out_elems * args[pos].shape[dim] + (out_elems if add
                                                        else 0)
            self.flops += f * s
            self.matmul_flops += f * s
        elif packet is aten.convolution:
            w = args[1]
            k = 1
            for x in w.shape[1:]:
                k *= x
            f = 2 * out_elems * k + (out_elems if args[2] is not None
                                     else 0)
            self.flops += f * s
            self.matmul_flops += f * s
        elif packet in _REDUCE:
            self.flops += _elems(ins[0]) * s
        elif packet in _PER_INPUT:
            self.flops += _PER_INPUT[packet] * _elems(ins[0]) * s
        elif packet in _PER_OUTPUT:
            self.flops += _PER_OUTPUT[packet] * out_elems * s
        elif torch.Tag.pointwise in func.tags:
            self.flops += out_elems * s

    # -- the result --------------------------------------------------------

    def result(self) -> Dict[str, Any]:
        """The reference's keys, plus the matmul share, the hand-written
        kernels' reports, the aten ops counted and the peak."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "coll_bytes_by_op": dict(self.coll_bytes),
            "coll_counts": dict(self.coll_counts),
            "wire_bytes": self.wire_bytes,
            "unresolved_whiles": 0,
            "matmul_flops": self.matmul_flops,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "ops": self.ops,
            "peak_bytes": self.peak_bytes,
        }


def active() -> Optional[Counter]:
    """The innermost counter entered on this thread (the autograd
    engine's threads inherit it), or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Counter):
            return mode
    return None


def report_kernel(name: str, work: Callable[[], Any]) -> None:
    """A hand-written kernel's call: its function's operations and bytes
    (``work()``, a :class:`~repro_torch.kernels.work.Work`, evaluated only
    when a counter is active), to the active counter."""
    c = active()
    if c is not None:
        w = work()
        c.add_kernel(name, int(w.ops), int(w.nbytes))


def report_collective(op: str, result_bytes: int, ring_n: int,
                      hbm_bytes: int = 0) -> None:
    """A collective's result bytes on one shard, over a ring of
    ``ring_n``, and the memory traffic of all its shards' operands and
    results, to the active counter."""
    c = active()
    if c is not None:
        c.add_collective(op, int(result_bytes), ring_n, int(hbm_bytes))


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Run a block without counting its ops (a kernel wrapper's argument
    checks, a collective's data movement, which report their work
    themselves); allocations are still followed."""
    c = active()
    if c is None:
        yield
        return
    c._paused += 1
    try:
        yield
    finally:
        c._paused -= 1


@contextlib.contextmanager
def counted_as(ops: int, nbytes_: int, matmul_ops: int = 0
               ) -> Iterator[None]:
    """Run a block uncounted and count ``ops`` operations (``matmul_ops``
    of them in products) and ``nbytes_`` bytes for it: a function whose
    work a formula gives whatever its data (the MoE's grouped expert
    products, whose empty experts are the router's)."""
    c = active()
    with uncounted():
        yield
    if c is not None:
        c.add_work(ops, nbytes_, matmul_ops)


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """A remat's recompute (``models/common.remat``): it counts as the
    forward it repeats, whatever region of a backward triggered it."""
    c = active()
    if c is None:
        yield
        return
    saved = c._scale, c._paused
    c._scale, c._paused = 1, 0
    try:
        yield
    finally:
        c._scale, c._paused = saved


def _probe_seq() -> int:
    """The sequence number the autograd engine gave its newest node on
    this thread (a probe node, uncounted)."""
    with uncounted():
        probe = torch.zeros((), requires_grad=True) * 1
    return probe.grad_fn._sequence_nr()


class _Outputs(TorchFunctionMode):
    """Collects the autograd nodes of every tensor a call in the region
    returns or writes."""

    def __init__(self) -> None:
        super().__init__()
        self.nodes: List[Any] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _flat(out, _flat(args, [])):
            if t.grad_fn is not None:
                self.nodes.append(t.grad_fn)
        return out


class _Region:
    """Counting rules for a block and for its gradient: the block's ops
    count ``scale`` times (or not at all, ``paused``), and so do the ops
    of the backward nodes it created; ``on_backward`` runs once, when the
    first of those nodes runs."""

    def __init__(self, c: Counter, scale: int, paused: bool,
                 on_backward: Optional[Callable[[], None]]) -> None:
        self.c, self.scale, self.paused = c, scale, paused
        self.on_backward = on_backward

    def enter(self) -> None:
        self.c._scale *= self.scale
        self.c._paused += self.paused

    def leave(self) -> None:
        self.c._scale //= self.scale
        self.c._paused -= self.paused

    def hook(self, roots: List[Any], first: int, last: int) -> None:
        """Hooks on every node created between sequence numbers ``first``
        (excluded) and ``last``, found from ``roots``."""
        seen: set = set()
        stack = list(roots)
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            if not first < node._sequence_nr() <= last:
                continue
            node.register_prehook(self._pre)
            node.register_hook(self._post)
            stack.extend(n for n, _ in node.next_functions)

    def _pre(self, grad_outputs) -> None:
        if self.on_backward is not None:
            report, self.on_backward = self.on_backward, None
            report()
        self.enter()

    def _post(self, grad_inputs, grad_outputs) -> None:
        self.leave()


@contextlib.contextmanager
def _region(scale: int = 1, paused: bool = False,
            on_backward: Optional[Callable[[], None]] = None
            ) -> Iterator[None]:
    c = active()
    if c is None:
        yield
        return
    reg = _Region(c, scale, paused, on_backward)
    grads = torch.is_grad_enabled()
    first = _probe_seq() if grads else 0
    outs = _Outputs()
    reg.enter()
    try:
        if grads:
            with outs:
                yield
        else:
            yield
    finally:
        reg.leave()
    if grads and outs.nodes:
        reg.hook(outs.nodes, first, _probe_seq())


class like_bodies:
    """The bodies of a loop over ``items`` (an int n: ``range(n)``) that
    are alike in their work (a recurrence's steps, a mesh's shards).

    Iterate it for the items to run: all of them, unless the active
    counter counts loops once; then the first and the last (which may
    differ: a recurrence's first step starts from a state that takes no
    gradient and its last one's state goes nowhere, a sequence's first
    shard has no left neighbour) and the second, whose ops and whose
    gradient's ops count for every item between the first and the last.
    :meth:`fill` then gives each of those items' entries of the loop's
    lists the second's.  Forward counts are exact for alike bodies; a
    gradient's miss what autograd does outside the bodies for the items
    that did not run (their views' backward, the adds that sum their
    gradients into what they share)."""

    def __init__(self, items) -> None:
        self.items = range(items) if isinstance(items, int) else items
        c = active()
        self.once = (c is not None and c.count_loops_once
                     and len(self.items) > 3)

    def __iter__(self) -> Iterator[Any]:
        if not self.once:
            yield from self.items
            return
        yield self.items[0]
        with _region(scale=len(self.items) - 2):
            yield self.items[1]
        yield self.items[-1]

    def fill(self, *lists: List[Any]) -> None:
        if self.once:
            for lst in lists:
                for it in self.items[2:-1]:
                    lst[it] = lst[self.items[1]]


@contextlib.contextmanager
def stand_in(backward: Callable[[], None]) -> Iterator[None]:
    """A collective's exchange as one process stands it in (copies,
    adds): its ops and their gradient's count nothing; the collective
    reports itself, and ``backward`` reports its transpose when the
    gradient runs."""
    with _region(paused=True, on_backward=backward):
        yield


def count(fn: Callable[..., Any], *args: Any,
          count_loops_once: bool = False, **kwargs: Any
          ) -> Tuple[Any, Dict[str, Any]]:
    """(``fn(*args, **kwargs)``, its work): see :meth:`Counter.result`."""
    with Counter(count_loops_once=count_loops_once) as c:
        out = fn(*args, **kwargs)
    return out, c.result()


def analyze(fn: Callable[..., Any], *args: Any, **kwargs: Any
            ) -> Dict[str, Any]:
    """The work of ``fn(*args, **kwargs)``: ``flops``, ``bytes``,
    ``coll_bytes_by_op``, ``coll_counts``, ``wire_bytes`` and
    ``unresolved_whiles`` (the reference's keys), with ``matmul_flops``,
    ``kernels``, ``ops`` and ``peak_bytes`` beside them."""
    return count(fn, *args, **kwargs)[1]


__all__ = ["COLLECTIVES", "Counter", "active", "analyze", "count",
           "counted_as", "like_bodies", "nbytes", "recomputing",
           "report_collective",
           "report_kernel", "stand_in", "uncounted", "wire_factor"]
