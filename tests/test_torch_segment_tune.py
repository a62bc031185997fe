"""The segment-reduce strategies and autotuner: the port against the
reference on the same inputs, and the port's own tuner contract.

The cases named as in the reference are its strategy and tuner cases of
``tests/test_kernels_segment.py``, each run through both packages on the
same inputs: integer tables bit for bit, float32 sums to rtol 1e-5 (the
fused path adds in another order than the scatter reference).

The port's own cases pin what differs from the reference's tuner: a
sum on CUDA takes the kernel on its own route without measuring (the
reference times its Pallas tilings on a TPU), so no plain strategy is
ever timed against it there; a kernel that raises propagates;
``REPRO_SEGMENT_AUTOTUNE=0`` gives the static choice; and no lock is held
while candidates run.  No CUDA device is needed: only the ``cuda``
device type is named.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segment_reduce as ref_segment_reduce
from repro.kernels import segment_reduce_ref as ref_oracle
from repro.kernels.segment_reduce import clear_cache as ref_clear_cache
from repro.kernels.segment_reduce import tune_report as ref_tune_report
from repro_torch.kernels.segment_reduce import kernel as kmod
from repro_torch.kernels.segment_reduce import ops, tune
from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                segment_reduce_ref)

RNG_SEED = 2


@pytest.fixture(autouse=True)
def _fresh_tuners(monkeypatch):
    """Each case tunes from scratch, with neither knob set."""
    monkeypatch.delenv("REPRO_SEGMENT_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_SEGMENT_KERNEL", raising=False)
    ref_clear_cache()
    tune.clear_cache()
    yield
    ref_clear_cache()
    tune.clear_cache()


def _case(rng, n, num_keys, d, dtype):
    keys = rng.integers(-3, num_keys + 5, size=n).astype(np.int32)
    shape = (n, d) if d else (n,)
    if np.issubdtype(dtype, np.floating):
        vals = rng.normal(size=shape).astype(dtype)
    else:
        vals = rng.integers(0, 100, size=shape).astype(dtype)
    valid = rng.random(n) < 0.8
    return keys, vals, valid


def _same(ref, got, float_rtol=None):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    if float_rtol is not None:
        np.testing.assert_allclose(got, ref, rtol=float_rtol)
    else:
        np.testing.assert_array_equal(got, ref)


# -- the reference's cases ----------------------------------------------------

@pytest.mark.parametrize("strategy", ["scatter", "fused", "sorted"])
def test_explicit_strategies_match_reference(strategy):
    keys, vals, valid = _case(np.random.default_rng(RNG_SEED), 777, 101, 2,
                              np.int32)
    ref = ref_segment_reduce(jnp.asarray(keys), (jnp.asarray(vals),), 101,
                             op="sum", valid=jnp.asarray(valid),
                             strategy=strategy)
    ref_want = ref_oracle(jnp.asarray(keys), (jnp.asarray(vals),), 101,
                          op="sum", valid=jnp.asarray(valid))
    got = segment_reduce(torch.from_numpy(keys), (torch.from_numpy(vals),),
                         101, op="sum", valid=torch.from_numpy(valid),
                         strategy=strategy)
    want = segment_reduce_ref(torch.from_numpy(keys),
                              (torch.from_numpy(vals),), 101, op="sum",
                              valid=torch.from_numpy(valid))
    for r, g in ((ref.values[0], got.values[0]), (ref.counts, got.counts),
                 (ref_want.values[0], want.values[0])):
        _same(r, g)
    assert int(got.overflow) == int(want.overflow) == int(ref.overflow)
    assert torch.equal(got.values[0], want.values[0])


def test_fused_strategy_mixed_dtypes_pytree():
    rng = np.random.default_rng(RNG_SEED)
    keys, _, valid = _case(rng, 300, 17, 1, np.float32)
    f = rng.normal(size=(300, 2)).astype(np.float32)
    i = rng.integers(0, 9, 300).astype(np.int32)
    ref = ref_segment_reduce(jnp.asarray(keys),
                             {"f": jnp.asarray(f), "i": jnp.asarray(i)}, 17,
                             op="sum", valid=jnp.asarray(valid),
                             strategy="fused")
    got = segment_reduce(torch.from_numpy(keys),
                         {"f": torch.from_numpy(f), "i": torch.from_numpy(i)},
                         17, op="sum", valid=torch.from_numpy(valid),
                         strategy="fused")
    want = segment_reduce_ref(torch.from_numpy(keys),
                              {"f": torch.from_numpy(f),
                               "i": torch.from_numpy(i)}, 17, op="sum",
                              valid=torch.from_numpy(valid))
    _same(ref.values["f"], got.values["f"], float_rtol=1e-5)
    _same(ref.values["i"], got.values["i"])
    _same(ref.counts, got.counts)
    assert torch.allclose(got.values["f"], want.values["f"], rtol=1e-5)
    assert torch.equal(got.values["i"], want.values["i"])


def test_tuned_default_matches_reference_and_reports():
    keys, vals, valid = _case(np.random.default_rng(RNG_SEED), 900, 50, 1,
                              np.int32)
    ref = ref_segment_reduce(jnp.asarray(keys), (jnp.asarray(vals),), 50,
                             op="sum", valid=jnp.asarray(valid))
    got = segment_reduce(torch.from_numpy(keys), (torch.from_numpy(vals),),
                         50, op="sum", valid=torch.from_numpy(valid))
    _same(ref.values[0], got.values[0])
    _same(ref.counts, got.counts)
    for report in (ref_tune_report(), tune.tune_report()):
        entries = [e for e in report if e["n"] == 900]
        assert entries, "autotuner should have recorded this shape"
        assert entries[0]["candidates"], "candidates should have been timed"
        assert entries[0]["chosen"] in {c["candidate"]
                                        for c in entries[0]["candidates"]}
    port = [e for e in tune.tune_report() if e["n"] == 900][0]
    # the CPU offers the reference's non-kernel candidates, no kernel
    assert sorted(c["candidate"] for c in port["candidates"]) \
        == ["fused", "scatter", "sorted"]
    assert port["device"] == "cpu"


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="unknown segment-reduce strategy"):
        ref_segment_reduce(jnp.zeros((4,), jnp.int32),
                           (jnp.zeros((4,), jnp.float32),), 2,
                           strategy="magic")
    with pytest.raises(ValueError, match="unknown segment-reduce strategy"):
        segment_reduce(torch.zeros((4,), dtype=torch.int32),
                       (torch.zeros((4,), dtype=torch.float32),), 2,
                       strategy="magic")


# -- the port's own tuner contract --------------------------------------------

I32 = (((), "int32"),)
CUDA = torch.device("cuda")


def test_candidates_are_the_plain_strategies():
    assert tune.candidates(I32) == ["fused", "scatter", "sorted"]
    # float leaves: no sorted candidate
    assert tune.candidates((((), "float32"),)) == ["fused", "scatter"]
    assert tune.candidates(I32 + (((2,), "float64"),)) == ["fused",
                                                          "scatter"]


@pytest.mark.parametrize("n,d,route", [
    # the k-mer combine (d = 1) and merge (two int32 leaves, d = 2)
    (5_383_104, 1, "binned"), (16_784_112, 2, "binned"),
    # d = 3 still bins; d = 4 is past the binned route's columns
    (5_383_104, 3, "binned"), (5_383_104, 4, "atomic"),
])
def test_cuda_sum_takes_the_kernel_without_measuring(monkeypatch, n, d,
                                                     route):
    def measure(*args):
        raise AssertionError("a sum on CUDA was measured")

    monkeypatch.setattr(tune, "_measure", measure)
    nk = 4 ** 12
    vals = (torch.zeros((1, d), dtype=torch.int32),)
    assert tune.pick_strategy("sum", n, nk, vals, device=CUDA) == "kernel"
    assert ops.resolve_strategy(None, "sum", n, nk, vals,
                                device=CUDA) == "kernel"
    assert tune.tune_report() == []
    # the kernel then picks its own route at this shape
    assert kmod.route(nk, d, n, CUDA) == route


def test_static_choice_without_measurement(monkeypatch):
    monkeypatch.setenv("REPRO_SEGMENT_AUTOTUNE", "0")
    vals = (torch.zeros(40, dtype=torch.int32),)
    assert tune.pick_strategy("sum", 40, 8, vals) == "fused"
    assert tune.pick_strategy("sum", 40, 8, vals, device=CUDA) == "kernel"
    assert tune.tune_report() == []           # nothing was measured
    assert tune.pick_strategy("max", 40, 8, vals) == "scatter"
    # a measured choice is cached per (device type, op, shape signature)
    monkeypatch.delenv("REPRO_SEGMENT_AUTOTUNE")
    chosen = tune.pick_strategy("sum", 40, 8, vals)
    assert chosen in tune.candidates(I32)
    (entry,) = tune.tune_report()
    assert entry["chosen"] == chosen and entry["device"] == "cpu"
    assert tune.pick_strategy("sum", 40, 8, vals) == chosen
    assert len(tune.tune_report()) == 1


def test_kernel_that_raises_propagates(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("segment_sum (binned): launch failed")

    monkeypatch.setattr(ops, "segment_sum", broken)
    keys = torch.arange(64, dtype=torch.int32) % 16
    vals = (torch.zeros(64, dtype=torch.int32),)
    with pytest.raises(RuntimeError, match="launch failed"):
        segment_reduce(keys, vals, 16, use_kernel=True)
    monkeypatch.setenv("REPRO_SEGMENT_KERNEL", "1")
    with pytest.raises(RuntimeError, match="launch failed"):
        segment_reduce(keys, vals, 16)
    # the CPU tuner times no kernel, so it tunes as before
    monkeypatch.delenv("REPRO_SEGMENT_KERNEL")
    got = segment_reduce(keys, vals, 16)
    assert got.counts.tolist() == [4] * 16


def test_plain_candidate_that_raises_is_skipped_and_recorded(monkeypatch):
    def broken(*args, **kwargs):
        raise MemoryError("fused table too large")

    monkeypatch.setattr(ops, "segment_reduce_fused", broken)
    vals = (torch.ones(200, dtype=torch.int32),)
    keys = torch.arange(200, dtype=torch.int32) % 7
    got = segment_reduce(keys, vals, 7)
    assert got.counts.tolist() == [29] * 4 + [28] * 3
    (entry,) = tune.tune_report()
    rows = {r["candidate"]: r for r in entry["candidates"]}
    assert rows["fused"]["ms"] is None
    assert "MemoryError: fused table too large" in rows["fused"]["skipped"]
    assert entry["chosen"] in ("scatter", "sorted")


def test_candidates_run_outside_the_lock(monkeypatch):
    """While one thread measures a new shape, another thread's cached
    lookup and the report answer at once."""
    started, release = threading.Event(), threading.Event()
    measure = tune._measure

    def slow(op, n, num_keys, leaf_sig):
        if n == 64:
            started.set()
            assert release.wait(30)
        return measure(op, n, num_keys, leaf_sig)

    monkeypatch.setattr(tune, "_measure", slow)
    vals = lambda n: (torch.ones(n, dtype=torch.int32),)
    first = tune.pick_strategy("sum", 32, 8, vals(32))
    out: dict = {}
    measuring = threading.Thread(target=lambda: out.setdefault(
        "new", tune.pick_strategy("sum", 64, 8, vals(64))))
    measuring.start()
    try:
        assert started.wait(30)
        lookup = threading.Thread(target=lambda: out.update(
            cached=tune.pick_strategy("sum", 32, 8, vals(32)),
            report=[e["n"] for e in tune.tune_report()]))
        lookup.start()
        lookup.join(10)
        assert not lookup.is_alive(), "the lookup waited on the measurement"
        assert out["cached"] == first and out["report"] == [32]
    finally:
        release.set()
        measuring.join(30)
    assert not measuring.is_alive()
    assert out["new"] in tune.candidates(I32)
    assert [e["n"] for e in tune.tune_report()] == [32, 64]
