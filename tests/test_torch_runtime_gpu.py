"""On the card: the port's interactive and out-of-core runtime on
``cuda`` — a persisted prefix spilled to the host tier and restored to
its own device, async actions in FIFO order equal to synchronous ones,
an action's device wait that does not wait for another thread's stream,
and the wave runner's memory bound.

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
from repro_torch.core import MaRe, PlanCache, from_host
from repro_torch.io import WaveRunner, fasta_source, plan_waves
from repro_torch.io.ingest import ingest
from repro_torch.io.splits import assign_splits
from repro_torch.io.waves import RESIDENT_WAVES
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
