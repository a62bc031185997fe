"""On the card: the CUDA segment-sum kernel against its plain version,
and the k-mer path on ``cuda`` against the same path on the CPU.

Every test here needs a CUDA device: it is marked ``gpu`` and skips
without one.  This file imports no JAX, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import MaRe, collect_shard, from_host
from repro_torch.kernels.segment_reduce import kernel as kmod
from repro_torch.kernels.segment_reduce import (segment_reduce, segment_sum,
                                                segment_sum_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CASES = {
    "random": dict(n=5000, num_keys=37),
    "single_key": dict(n=2000, num_keys=1),
    "odd_num_keys": dict(n=4097, num_keys=1000003),
    "all_masked": dict(n=1280, num_keys=16, valid_frac=0.0),
    "hot_key": dict(n=40000, num_keys=50, hot=7),
    "empty": dict(n=0, num_keys=9),
}


def _case(seed, n, num_keys, hot=None, valid_frac=0.8):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-3, num_keys + 5, size=n).astype(np.int32)
    if hot is not None:
        keys[rng.random(n) < 0.9] = hot
    valid = rng.random(n) < valid_frac
    ints = rng.integers(-50, 100, size=(n, 3)).astype(np.int32)
    floats = rng.normal(size=(n, 2)).astype(np.float32)
    floats[~valid] = np.nan            # padding may hold NaN
    return keys, valid, ints, floats


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    c = CASES[name]
    keys, valid, ints, floats = _case(6, **c)
    k = torch.from_numpy(keys).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    before = kmod.LAUNCHES
    for vals in (ints, floats):
        vals = torch.from_numpy(vals).to(cuda)
        got = segment_sum(k, vals, c["num_keys"], v)
        torch.cuda.synchronize()
        want = segment_sum_ref(k, vals, c["num_keys"], v)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.device == b.device
        # counts and overflow are int32 in both cases: exact
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        if vals.dtype == torch.int32:
            assert torch.equal(got[0], want[0])
        else:
            # atomics add in another order: hold the table to the plain
            # version in float64, atol tied to the largest per-key count
            # and the largest valid value
            want64 = segment_sum_ref(k, vals.double(), c["num_keys"], v)[0]
            vmax = float(vals[v].abs().max()) if bool(v.any()) else 0.0
            atol = 1e-6 * int(want[1].max()) * vmax
            torch.testing.assert_close(got[0].double(), want64, rtol=1e-5,
                                       atol=atol)
    assert kmod.LAUNCHES - before == (2 if c["n"] else 0)


def test_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    from repro_torch.kernels.segment_reduce import ops
    monkeypatch.setattr(ops, "segment_reduce_ref", None)   # would crash
    keys, valid, ints, _ = _case(7, 300, 20)
    res = segment_reduce(torch.from_numpy(keys).to(cuda),
                         (torch.from_numpy(ints).to(cuda),), 20,
                         valid=torch.from_numpy(valid).to(cuda))
    assert res.counts.is_cuda


def test_kernel_rejects_other_dtypes_on_cuda(cuda):
    keys = torch.zeros(4, dtype=torch.int32, device=cuda)
    valid = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        segment_sum(keys, torch.zeros((4, 1), dtype=torch.int64,
                                      device=cuda), 3, valid)


def test_kmer_path_on_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(8)
    data = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8),
                      size=(3000, 64)).astype(np.uint8)
    lens = rng.integers(0, 65, 3000).astype(np.int32)
    results = []
    for dev in ("cpu", cuda):
        ds = from_host({"data": data, "len": lens}, num_shards=8, device=dev)
        before = kmod.LAUNCHES
        m = (MaRe(ds).map(image="kmer-stats", command="kmer-stats 7")
             .reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                            op="sum"))
        done = m.dataset
        launched = kmod.LAUNCHES - before
        assert (launched > 0) == (torch.device(dev).type == "cuda")
        results.append(([collect_shard(done, s) for s in range(8)],
                         m.report().diagnostics))
    (cpu_shards, cpu_diag), (gpu_shards, gpu_diag) = results
    assert cpu_diag == gpu_diag
    for a, b in zip(cpu_shards, gpu_shards):
        for x, y in zip((a[0], a[1][0], a[2]), (b[0], b[1][0], b[2])):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
