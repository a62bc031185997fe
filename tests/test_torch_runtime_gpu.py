"""On the card: the port's interactive and out-of-core runtime on
``cuda`` — a persisted prefix spilled to the host tier and restored to
its own device, async actions in FIFO order equal to synchronous ones,
an action's device wait that does not wait for another thread's stream,
the wave runner's memory bound, and the result gather into pinned host
memory that the answer owns, bit-equal to the old device-cat path.

Every test here needs a CUDA device: it is marked ``gpu`` and skips
without one.  This file imports no JAX, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_runtime_gpu.py
"""
import os
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs
from repro_torch.core import MaRe, PlanCache, collect, collect_shard, \
    from_host, from_numpy, tree
from repro_torch.core import dataset as ds_lib
from repro_torch.io import WaveRunner, fasta_source, plan_waves
from repro_torch.io.ingest import ingest
from repro_torch.io.splits import assign_splits
from repro_torch.io.waves import RESIDENT_WAVES
from repro_torch.obs import METRICS
from repro_torch.runtime import Executor, MaterializationCache, \
    estimate_nbytes

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _executor(**cache_kw) -> Executor:
    return Executor(mat_cache=MaterializationCache(**cache_kw))


def _key_first(recs):
    return recs[0]


def _val_second(recs):
    return (recs[1],)


def _keyed(data, num_shards, device, executor):
    return MaRe(data, num_shards=num_shards, device=device,
                plan_cache=PlanCache(), executor=executor)


def _table(out, num_keys):
    keys, (vals,), _ = out
    t = np.zeros(num_keys, np.int64)
    t[keys] = vals
    return t


def _keys_vals(seed, n, num_keys):
    """int32 keys and values: integer sums are exact in any order, so
    tables of two runs compare bit for bit (the kernel's float sums are
    not ordered)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, num_keys, n).astype(np.int32),
            rng.integers(0, 1000, n).astype(np.int32))


def test_persist_spill_and_restore_to_own_device(cuda):
    """A persisted map prefix on every visible card: spilled to CPU
    tensors by a device budget below its estimate, then a query's
    host-tier hit copies it back to THAT card (not the current one) and
    gives the uncached query's table."""
    keys, vals = _keys_vals(0, 4096, 97)
    for idx in range(torch.cuda.device_count()):
        dev = torch.device("cuda", idx)
        with torch.cuda.device(0):          # current device != dev
            ex = _executor(device_budget_bytes=1)
            base = _keyed((keys, vals), 4, dev, ex)
            base.map(image="toolbox/concat").persist()
            entry = next(iter(ex.mat_cache._entries.values()))
            assert entry.tier == "host" and entry.dataset is None
            assert all(not t.is_cuda for t in entry.host_records)
            assert entry.device == dev
            q = base.map(image="toolbox/concat").reduce_by_key(
                _key_first, value_by=_val_second, op="sum", num_keys=97)
            out = q.dataset
            assert q.report().cached_stages == 1
            assert q.report().cache_tier == "host"
            assert out.device == dev
            assert all(t.device == dev for t in
                       [out.counts, out.records[0], *out.records[1]])
            got = _table(q.collect(), 97)
            cold = _keyed((keys, vals), 4, dev, _executor()).reduce_by_key(
                _key_first, value_by=_val_second, op="sum", num_keys=97)
            np.testing.assert_array_equal(got, _table(cold.collect(), 97))
            assert ex.mat_cache.stats()["host_hits"] == 1


def test_async_fifo_equals_sync(cuda):
    """Five async keyed queries over one persisted prefix resolve in
    submit order, each equal to the same query run synchronously, each
    starting from the cached prefix."""
    keys, vals = _keys_vals(1, 20000, 50)
    ex = _executor()
    base = _keyed((keys, vals), 8, cuda, ex)
    base.map(image="toolbox/concat").persist()

    def query(nk):
        return base.map(image="toolbox/concat").reduce_by_key(
            lambda r: r[0] % nk, value_by=_val_second, op="sum",
            num_keys=nk)

    sizes = [7, 11, 13, 17, 50]
    sync = [_table(query(nk).collect(), nk) for nk in sizes]
    handles = [query(nk).collect(asynchronous=True, label=f"q{nk}")
               for nk in sizes]
    got = [_table(h.result(timeout=120), nk)
           for h, nk in zip(handles, sizes)]
    for a, b in zip(got, sync):
        np.testing.assert_array_equal(a, b)
    labels = [r.label for r in ex.reports if r.label]
    assert labels == [f"q{nk}" for nk in sizes]
    ids = [h.report.action_id for h in handles]
    assert ids == sorted(ids)
    assert all(h.report.device.startswith("cuda") for h in handles)
    assert all(h.report.cached_stages == 1 for h in handles)


def test_device_wait_ignores_other_threads_stream(cuda):
    """Another thread keeps a side stream busy for about a second; an
    action on this thread's stream meanwhile waits only for its own
    kernels.  A device-wide synchronize would charge the whole sleep to
    the action's ``device_wait``."""
    keys, vals = _keys_vals(2, 1 << 16, 64)
    ds = from_host((keys, vals), 8, cuda)
    ex = _executor()
    m = MaRe(ds, plan_cache=PlanCache(), executor=ex).reduce_by_key(
        _key_first, value_by=_val_second, op="sum", num_keys=64)
    m.collect()                           # warm: build and allocate once
    side = torch.cuda.Stream(device=cuda)
    started = threading.Event()
    cycles = int(2e9)                     # ~1 s at the H100's ~2 GHz

    def busy():
        with torch.cuda.stream(side):
            torch.cuda._sleep(cycles)
        started.set()

    sleeper = threading.Thread(target=busy)
    sleeper.start()
    assert started.wait(30)
    m.collect()
    rep = m.report()
    side_done = side.query()
    side.synchronize()
    sleeper.join(timeout=30)
    assert not sleeper.is_alive()
    assert not side_done, "the side stream finished before the action"
    assert rep.phases["device_wait"] < 0.25, rep.phases
    assert rep.wall_s < 0.5, rep.wall_s


def test_wave_memory_bound(cuda):
    """At most RESIDENT_WAVES waves on the card: the wave run's peak of
    allocated bytes is one wave's own peak through the pipeline (its
    dataset and the map's temporaries: ``torch.isin`` sorts a shard) plus
    the next wave being ingested, short of half a wave more, where a
    third resident wave would add a whole one; it stays under the
    one-shot action's peak, and both GC counts are exact."""
    seq = cs.make_genome(800_000, seed=3)
    n = 8
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.fa")
        cs.write_fasta(path, seq)
        src = fasta_source(path, split_bytes=16 << 10)
        wave_bytes = n * (16 << 10)
        waves = plan_waves(src.splits(), wave_bytes)
        assert len(waves) >= 6
        cap = cs.wave_capacity(waves, n)
        want = int(np.count_nonzero((seq == ord("G")) | (seq == ord("C"))))

        def gc(m):
            return (m.map(image="ubuntu", command="grep-chars GC")
                    .reduce(image="ubuntu", command="awk-sum"))

        # one wave alone: its dataset's bytes and its peak through the
        # pipeline
        assert max(len(b) for b in assign_splits(waves[0], n)) == 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        one = ingest(src, n, device=cuda, capacity=cap, width=64,
                     splits=waves[0])
        wave_nbytes = estimate_nbytes(one)
        gc(MaRe(one, executor=_executor())).collect(shard=0)
        one_wave_peak = torch.cuda.max_memory_allocated(cuda) - base
        del one
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        (total,) = gc(MaRe.from_source(src, num_shards=n, device=cuda,
                                       executor=_executor())
                      ).collect(shard=0)
        one_shot_peak = torch.cuda.max_memory_allocated(cuda) - base
        assert int(total[0]) == want

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        runner = gc(WaveRunner(src, num_shards=n, device=cuda,
                               wave_bytes=wave_bytes, capacity=cap,
                               width=64, executor=_executor()))
        (total,) = runner.collect()
        wave_peak = torch.cuda.max_memory_allocated(cuda) - base
        assert int(total[0]) == want
        assert runner.stats["num_waves"] == len(waves)
        assert runner.stats["programs_compiled"] <= 2
        assert wave_peak < one_shot_peak, (wave_peak, one_shot_peak)
        bound = one_wave_peak + (RESIDENT_WAVES - 1) * wave_nbytes \
            + wave_nbytes // 2
        assert wave_peak < bound, (wave_peak, one_wave_peak, wave_nbytes)


# -- the result gather: pinned host memory the answer owns --------------------

def _old_gather(ds, shard=None):
    """The gather as it was before the answer owned pinned memory: the
    shards' valid slices concatenated on the card, then copied to
    pageable host memory."""
    counts = ds.counts.cpu().numpy()
    cap = ds.capacity
    shards = range(ds.num_shards) if shard is None else [shard]

    def one(leaf):
        return torch.cat([leaf[s * cap:s * cap + int(counts[s])]
                          for s in shards]).cpu().numpy()

    return tree.tree_map(one, ds.records)


def _kmer_like_table(cuda):
    """An 8-shard table shaped like the k-mer answer (int32 keys,
    occurrences and counts) over uneven valid counts: an empty shard, a
    full one, a shard of one row; ~1.2M rows a leaf."""
    cap = 1 << 18
    counts = np.array([cap // 2, 0, cap, 1, cap - 7, 3 * cap // 4, cap // 3,
                       cap], np.int32)
    rng = np.random.default_rng(5)
    recs = tuple(rng.integers(-2**31, 2**31, 8 * cap).astype(np.int32)
                 for _ in range(3))
    return from_numpy((recs[0], (recs[1],), recs[2]), counts, 8,
                      device=cuda)


def _same(a, b):
    fa, fb = tree.leaves(a), tree.leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.fixture(params=["per_slice", "concatenated"])
def copies(request, monkeypatch):
    """Both ways a leaf's valid slices reach the host: a copy a slice, or
    concatenated on the card first (``CAT_BELOW_BYTES``)."""
    monkeypatch.setattr(ds_lib, "CAT_BELOW_BYTES",
                        0 if request.param == "per_slice" else 1 << 62)


def test_gather_pinned_bit_equal_to_old_path(cuda, copies):
    """``collect`` and ``collect_shard`` on the card equal the old
    device-cat + pageable path bit for bit, for a k-mer-like 8-shard
    table (every shard, the empty one included), leaves with trailing
    dimensions and four dtypes; every non-empty leaf is pinned host
    memory, C-contiguous and writable; ``gather.pinned_bytes`` counts the
    answer's bytes and ``gather.pageable_bytes`` nothing."""
    ds = _kmer_like_table(cuda)
    rng = np.random.default_rng(6)
    cap = 1 << 10
    mixed = from_numpy(
        {"f": rng.standard_normal((4 * cap, 3, 2)).astype(np.float32),
         "i": rng.integers(-2**40, 2**40, (4 * cap, 2)),
         "b": rng.random(4 * cap) < 0.5},
        np.array([0, cap, 1, 17], np.int32), 4, device=cuda)
    for d in (ds, mixed):
        cases = [(None, collect(d))] + [
            (s, collect_shard(d, s)) for s in range(d.num_shards)]
        for shard, got in cases:
            _same(got, _old_gather(d, shard))
            for a in tree.leaves(got):
                assert a.flags.c_contiguous and a.flags.writeable
                if a.size:
                    assert torch.from_numpy(a).is_pinned()
    pinned = METRICS.counter("gather.pinned_bytes").value
    pageable = METRICS.counter("gather.pageable_bytes").value
    out = collect(ds)
    assert METRICS.counter("gather.pinned_bytes").value - pinned == sum(
        a.nbytes for a in tree.leaves(out))
    assert METRICS.counter("gather.pageable_bytes").value == pageable


def test_gather_kept_answer_survives_later_gathers(cuda, copies):
    """An answer kept while 20 more gathers run (each dropped, so their
    pinned blocks go back to the cache and are handed out again) keeps
    its values; no two answers share memory."""
    ds = _kmer_like_table(cuda)
    kept = collect(ds)
    want = [a.copy() for a in tree.leaves(kept)]
    for i in range(20):
        other = collect(ds) if i % 2 else collect_shard(ds, 2)
        for a in tree.leaves(other):
            assert not any(np.shares_memory(a, k)
                           for k in tree.leaves(kept))
            a[...] = -1
        del other
    for a, w in zip(tree.leaves(kept), want):
        assert a.tobytes() == w.tobytes()


def test_gather_async_equals_sync_pinned(cuda):
    """A keyed action's ``collect(asynchronous=True).result()`` and its
    ``collect(shard=0, ...)`` equal the synchronous answers and the old
    path on its dataset, in pinned memory."""
    keys, vals = _keys_vals(7, 1 << 20, 1 << 14)
    ex = _executor()
    q = _keyed((keys, vals), 8, cuda, ex).reduce_by_key(
        _key_first, value_by=_val_second, op="sum", num_keys=1 << 14)
    old = _old_gather(q.dataset)
    sync = q.collect()
    got = q.collect(asynchronous=True).result(timeout=120)
    _same(sync, old)
    _same(got, old)
    assert all(torch.from_numpy(a).is_pinned() for a in tree.leaves(got))
    _same(q.collect(shard=0, asynchronous=True).result(timeout=120),
          _old_gather(q.dataset, 0))
