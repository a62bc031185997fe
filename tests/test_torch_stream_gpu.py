"""On the card: the segment-reduce tuner, the incremental k-mer stream and
the query service on ``cuda`` — a sum on card tensors takes the kernel
without measuring and with no device-wide synchronize, a stream's folded
table equals a one-shot action's bit for bit, a stream's allocated bytes
stay within one generation as it grows, and two sessions' identical sum
queries share one dispatch of 16 segment-sum launches.

Every test here needs a CUDA device: it is marked ``gpu`` and skips
without one.  This file imports no JAX, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_stream_gpu.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs
from repro_torch.core import MaRe, PlanCache, from_host
from repro_torch.core.dataset import collect
from repro_torch.io import fasta_source
from repro_torch.kernels.segment_reduce import kernel as kmod
from repro_torch.kernels.segment_reduce import segment_reduce, tune
from repro_torch.runtime import Executor, estimate_nbytes
from repro_torch.serve import QueryService, ServiceConfig
from repro_torch.stream import ContinuousSource, IncrementalQuery

pytestmark = pytest.mark.gpu

K = 10
SHARDS = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _key(r):
    return r[0]


def _count(r):
    return (r[1],)


def _query(m):
    return (m.map(image="kmer-stats", k=K)
            .reduce_by_key(_key, value_by=_count, op="sum"))


def _files(tmp_path, n, bases):
    """``n`` FASTA files of whole lines of one random genome, staged
    beside the inbox; returns (inbox, staged paths, per-file tables)."""
    seq = cs.make_genome(n * bases, 5)
    per = bases // cs.LINE * cs.LINE
    staging, inbox = tmp_path / "staging", tmp_path / "inbox"
    staging.mkdir()
    inbox.mkdir()
    out = []
    for i in range(n):
        chunk = seq[i * per:(i + 1) * per]
        path = str(staging / f"part{i}.fa")
        cs.write_fasta(path, chunk)
        out.append((path, cs.kmer_bincount(chunk, K)))
    return str(inbox), out


def _drop(inbox, staged):
    os.replace(staged, os.path.join(inbox, os.path.basename(staged)))


def _dense(out):
    keys, (occ,), _ = out
    table = np.zeros(4 ** K, np.int64)
    table[keys] = occ
    return table


def _stream(inbox, cap):
    cont = ContinuousSource(fasta_source(inbox), num_shards=SHARDS,
                            device="cuda", capacity=cap)
    return IncrementalQuery(cont, _query, executor=Executor(),
                            plan_cache=PlanCache())


def test_cuda_sum_takes_the_kernel_unmeasured(cuda, monkeypatch):
    def no_device_sync(*args, **kwargs):
        raise AssertionError("the dispatch synchronized the whole device")

    tune.clear_cache()
    monkeypatch.delenv("REPRO_SEGMENT_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_SEGMENT_KERNEL", raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    n, nk = 1 << 20, 4 ** 12
    keys = torch.randint(0, nk, (n,), dtype=torch.int32, device=cuda)
    vals = (torch.ones(n, dtype=torch.int32, device=cuda),
            torch.ones(n, dtype=torch.int32, device=cuda))
    assert tune.pick_strategy("sum", n, nk, vals, device=cuda) == "kernel"
    kmod.reset_launches()
    got = segment_reduce(keys, vals, nk)
    # both int32 leaves fold in one launch of d = 2, on the binned route
    assert kmod.LAUNCHES == 1
    assert kmod.LAUNCHES_BY_ROUTE == {"binned": 1, "atomic": 0}
    assert tune.tune_report() == []
    want = torch.bincount(keys.long(), minlength=nk).to(torch.int32)
    assert torch.equal(got.counts, want)
    assert torch.equal(got.values[0], want) and torch.equal(got.values[1],
                                                            want)


def test_four_epoch_stream_equals_oneshot_in_int32(cuda, tmp_path):
    inbox, files = _files(tmp_path, 4, 200_000)
    cap = cs.wave_capacity([fasta_source(p).splits() for p, _ in files],
                           SHARDS)
    q = _stream(inbox, cap)
    want = np.zeros(4 ** K, np.int64)
    for i, (path, table) in enumerate(files):
        _drop(inbox, path)
        assert q.update().epoch == i
        want += table
        assert np.array_equal(_dense(collect(q.state)), want)
    got = collect(q.state)
    one = _query(MaRe.from_source(fasta_source(inbox),
                                  num_shards=SHARDS)).collect()
    for a, b in zip((got[0], got[1][0], got[2]), (one[0], one[1][0],
                                                 one[2])):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert q.fold_engine.compiles == 1 and q.fold_engine.folds == 3
    assert q.state.records[1][0].is_cuda


def test_allocated_bytes_stay_within_one_generation(cuda, tmp_path):
    inbox, files = _files(tmp_path, 8, 100_000)
    cap = cs.wave_capacity([fasta_source(p).splits() for p, _ in files],
                           SHARDS)
    q = _stream(inbox, cap)
    allocated = []
    for path, _ in files:
        _drop(inbox, path)
        q.update()
        allocated.append(torch.cuda.memory_allocated(cuda))
    generation = estimate_nbytes(q.state)
    assert allocated[7] - allocated[1] <= generation, (allocated,
                                                       generation)
    q.executor.mat_cache.clear()


def test_two_sessions_identical_sums_share_one_dispatch(cuda):
    rng = np.random.default_rng(4)
    reads = {"data": np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (4096, 64))],
        "len": np.full(4096, 64, np.int32)}
    ds = from_host(reads, SHARDS, device=cuda)
    with QueryService(executor=Executor(), config=ServiceConfig(
            batch_window_s=0.5)) as svc:
        a, b = svc.session("alice"), svc.session("bob")
        before = kmod.LAUNCHES
        ha = _query(a.mare(ds)).collect(asynchronous=True)
        hb = _query(b.mare(ds)).collect(asynchronous=True)
        va, vb = ha.result(timeout=120), hb.result(timeout=120)
        assert kmod.LAUNCHES - before == 2 * SHARDS
        assert ha.report.batch_size == hb.report.batch_size == 2
        assert ha.report.batch_leader == hb.report.batch_leader
        assert va is vb                      # one shared value
        one = _query(MaRe(ds, executor=Executor())).collect()
        for x, y in zip((va[0], va[1][0], va[2]), (one[0], one[1][0],
                                                   one[2])):
            np.testing.assert_array_equal(x, y)
