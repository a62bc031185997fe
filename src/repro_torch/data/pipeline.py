"""Data pipeline: sources, packing (as MaRe map stages), host prefetch with
straggler mitigation.

The paper's ingestion story (HDFS / Swift / S3, Fig. 5) maps to pluggable
``Source`` iterators behind one contract; its locality story maps to the
tokenize/pack stage running as a ``MaRe.map`` ContainerOp (partition-local,
zero shuffle).  Host-side prefetch wraps generation in a worker thread
with a deadline: tasks that exceed it are speculatively re-dispatched —
the Spark speculative-execution analogue.

Sources and batches are numpy, drawn from numpy seeds exactly as the
reference draws them, so both packages feed the same tokens.  A batch
producer that places tensors on a card (the wave runner's ingest) picks
its device and stream inside the producing call: the ``Prefetcher`` runs
it on threads of its own, where the caller's current device and stream
do not apply.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.obs import METRICS, instant


# ---------------------------------------------------------------------------
# Sources (the heterogeneous-storage abstraction)
# ---------------------------------------------------------------------------

class Source:
    """Iterator of raw record arrays.  Subclasses emulate storage backends
    with different latency profiles."""

    name = "base"

    def __iter__(self) -> Iterator[np.ndarray]:  # pragma: no cover
        raise NotImplementedError


class SyntheticText(Source):
    """Zipf-distributed token documents (deterministic per seed)."""

    name = "synthetic"

    def __init__(self, vocab_size: int, doc_len: int = 1024,
                 num_docs: int = 1 << 30, seed: int = 0,
                 latency_s: float = 0.0, jitter_s: float = 0.0):
        self.vocab_size = vocab_size
        self.doc_len = doc_len
        self.num_docs = num_docs
        self.seed = seed
        self.latency_s = latency_s
        self.jitter_s = jitter_s

    def __iter__(self):
        for i in range(self.num_docs):
            rng = np.random.default_rng(self.seed + i)
            if self.latency_s or self.jitter_s:
                time.sleep(self.latency_s +
                           rng.exponential(self.jitter_s))
            ranks = rng.zipf(1.3, size=self.doc_len)
            yield (ranks % self.vocab_size).astype(np.int32)


# ---------------------------------------------------------------------------
# Batch builder
# ---------------------------------------------------------------------------

def lm_batches(source: Source, batch: int, seq: int,
               vocab_size: int, extra: Optional[Dict[str, Callable]] = None
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Pack documents into [batch, seq+1] windows -> tokens/labels."""
    it = iter(source)
    buf = np.zeros((0,), np.int32)
    while True:
        need = batch * (seq + 1)
        while buf.shape[0] < need:
            buf = np.concatenate([buf, next(it)])
        window = buf[:need].reshape(batch, seq + 1)
        buf = buf[need:]
        out = {"tokens": window[:, :-1].copy(),
               "labels": window[:, 1:].copy()}
        if extra:
            for k, fn in extra.items():
                out[k] = fn(batch, seq)
        yield out


# ---------------------------------------------------------------------------
# Prefetcher with straggler re-dispatch
# ---------------------------------------------------------------------------

class Prefetcher:
    """Background batch production with speculative re-execution.

    A producer thread fills a bounded queue.  If producing one batch takes
    longer than ``deadline_s``, a backup producer is dispatched for the
    same batch index on a FRESH iterator and the first result wins (both
    are deterministic, so duplicates are identical — Spark
    speculative-execution semantics).  The loser's batch is dropped where
    it is produced, so a duplicate wave's tensors are freed as soon as
    its producer returns."""

    def __init__(self, make_iter: Callable[[], Iterator],
                 capacity: int = 4, deadline_s: Optional[float] = None):
        self.make_iter = make_iter
        self.q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self.deadline_s = deadline_s
        self.stats = {"produced": 0, "respawned": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        it = iter(self.make_iter())
        idx = 0
        while not self._stop.is_set():
            result: Dict[str, Any] = {}
            lock = threading.Lock()
            done = threading.Event()

            def produce(slot_it):
                try:
                    batch = next(slot_it)
                    with lock:
                        if not result:
                            result["batch"] = batch
                            result["it"] = slot_it
                except StopIteration:
                    with lock:
                        if not result:   # a winner's batch beats a loser's
                            result["stop"] = True      # exhaustion
                finally:
                    done.set()

            worker = threading.Thread(target=produce, args=(it,), daemon=True)
            worker.start()
            timeout = self.deadline_s
            finished = done.wait(timeout) if timeout else done.wait()
            if not finished:
                # straggler: speculatively re-dispatch on a FRESH iterator
                # fast-forwarded to idx (deterministic source); first result
                # wins, and the winning iterator becomes the active one
                self.stats["respawned"] += 1
                instant("prefetch.speculative_redispatch", batch=idx,
                        deadline_s=self.deadline_s)
                METRICS.counter("prefetch.respawned").inc()
                backup_it = iter(self.make_iter())
                try:
                    for _ in range(idx):
                        next(backup_it)
                except StopIteration:
                    backup_it = None   # replay shorter than idx: no backup
                if backup_it is not None:
                    threading.Thread(target=produce, args=(backup_it,),
                                     daemon=True).start()
                done.wait()

            if result.get("stop"):
                break
            it = result["it"]
            batch = result.pop("batch")
            self.q.put(batch)
            del batch
            self.stats["produced"] += 1
            idx += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        """Stop producing; batches already queued are dropped, so a
        producer blocked on a full queue wakes, sees the stop and exits
        without holding a batch."""
        self._stop.set()
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break


# ---------------------------------------------------------------------------
# MaRe-stage tokenizer (the paper-faithful pre-processing path)
# ---------------------------------------------------------------------------

def register_tokenizer_image():
    """A 'tokenizer' container image: maps raw byte records to token ids
    partition-locally (MaRe.map — single stage, no shuffle)."""
    from repro_torch.core import tree
    from repro_torch.core.container import (DEFAULT_REGISTRY, Partition,
                                            container_op, make_partition)
    from repro_torch.kernels.exchange.ref import _MASK32, _mul32
    if "tools/tokenizer:latest" in DEFAULT_REGISTRY.images():
        return

    @container_op("tools/tokenizer", registry=DEFAULT_REGISTRY)
    def tokenizer(part: Partition, command: str = "", vocab_size: int = 256,
                  **kw) -> Partition:
        (raw,) = tree.leaves(part.records)
        # (uint32(raw) * 2654435761 mod 2**32) % vocab, as the reference
        x = raw.to(torch.int64) & _MASK32
        toks = (_mul32(x, 2654435761) % vocab_size).to(torch.int32)
        return make_partition((toks,), part.count)

    return tokenizer
