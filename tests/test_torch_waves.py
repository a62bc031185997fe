"""The port's out-of-core wave execution (``repro_torch.io.waves``)
against the reference's (``repro.io.waves``): wave planning, folding,
end-to-end exactness over every storage backend, plan-cache
amortization, and the pipeline-spec checks.

The cases are the reference's ``tests/test_waves.py``, each run through
both packages on the same file; totals, records, wave counts and the
runners' ``stats`` are compared exactly.  The port takes
``device="cpu"`` here (``num_shards`` defaults to 1, the reference's
one-device mesh in this process).  The last case is the port's own: its
bound on resident waves.
"""
import gc
import weakref

import numpy as np
import pytest

import repro.core as R
import repro.io as RI
import repro_torch.core as T
import repro_torch.io as TI
from repro.io.splits import InputSplit as RSplit
from repro_torch.io.splits import InputSplit as TSplit

PKGS = {R: dict(io=RI, split=RSplit, kw={}),
        T: dict(io=TI, split=TSplit, kw={"device": "cpu"})}


def both(case):
    """case(mod, pkg) for the reference, then the port; returns both."""
    return case(R, PKGS[R]), case(T, PKGS[T])


def _mk_splits(split, lengths):
    out, off = [], 0
    for ln in lengths:
        out.append(split(path="f", start=off, stop=off + ln,
                         file_size=sum(lengths)))
        off += ln
    return out


def _spans(waves):
    return [[(s.start, s.stop) for s in w] for w in waves]


def test_plan_waves_respects_budget_and_order():
    def case(mod, pkg):
        plan_waves = pkg["io"].plan_waves
        splits = _mk_splits(pkg["split"], [100, 100, 100, 100, 100])
        waves = plan_waves(splits, wave_bytes=250)
        assert [s for w in waves for s in w] == splits   # order preserved
        assert plan_waves(splits, wave_bytes=None) == [splits]
        # oversized split still gets its own wave
        big = plan_waves(_mk_splits(pkg["split"], [500, 10]),
                         wave_bytes=100)
        return _spans(waves), _spans(big)
    ref, port = both(case)
    assert [len(w) for w in port[0]] == [2, 2, 1]
    assert [len(w) for w in port[1]] == [1, 1]
    assert ref == port


@pytest.fixture
def genome(tmp_path):
    rng = np.random.default_rng(7)
    seq = "".join(np.array(list("ATGC"))[rng.integers(0, 4, 6000)])
    p = tmp_path / "genome.fa"
    p.write_text(">chr1\n" + "\n".join(
        seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    return str(p), seq


def _gc_runner(mod, pkg, src, **kw):
    return (pkg["io"].WaveRunner(src, **pkg["kw"], **kw)
            .map(image="ubuntu", command="grep-chars GC")
            .reduce(image="ubuntu", command="awk-sum"))


@pytest.mark.parametrize("backend", ["local", "hdfs", "swift", "s3"])
def test_gc_count_out_of_core_matches_reference(genome, backend):
    """Listing-1 GC count over an on-disk FASTA, ingested via each storage
    backend and executed in >= 2 out-of-core waves, matches the numpy
    count exactly in both packages."""
    path, seq = genome

    def case(mod, pkg):
        io = pkg["io"]
        src = io.fasta_source(path, backend=io.make_backend(backend, path),
                              split_bytes=512)
        runner = _gc_runner(mod, pkg, src, wave_bytes=1 << 11,
                            plan_cache=mod.PlanCache())
        (total,) = runner.collect()
        return (int(total[0]), total.dtype.name, runner.stats,
                [r.label for r in runner.reports])
    ref, port = both(case)
    assert port[2]["num_waves"] >= 2
    assert port[0] == seq.count("G") + seq.count("C")
    assert ref == port


def test_map_only_waves_concatenate_all_records(tmp_path):
    lines = [f"line-{i:03d}" for i in range(100)]
    p = tmp_path / "d.txt"
    p.write_text("\n".join(lines) + "\n")

    def case(mod, pkg):
        io = pkg["io"]
        runner = io.WaveRunner(io.text_source(str(p), split_bytes=128),
                               wave_bytes=256, width=16, **pkg["kw"])
        out = runner.collect()
        got = sorted(r for r in io.unpack_records(out) if r)
        return got, runner.stats, {k: v.shape for k, v in out.items()}
    ref, port = both(case)
    assert port[1]["num_waves"] >= 2
    assert port[0] == sorted(ln.encode() for ln in lines)
    assert ref == port


def test_single_wave_equals_multi_wave(genome):
    path, _ = genome

    def case(mod, pkg):
        def run(wave_bytes):
            r = _gc_runner(mod, pkg,
                           pkg["io"].fasta_source(path, split_bytes=512),
                           wave_bytes=wave_bytes, prefetch=False)
            (t,) = r.collect()
            return int(t[0]), r.stats["num_waves"]
        one, n1 = run(None)
        many, nm = run(1 << 11)
        assert n1 == 1 and nm >= 2
        assert one == many
        return one, n1, nm
    ref, port = both(case)
    assert ref == port


def test_wave_pipeline_compile_amortizes_across_runs(genome):
    """The plan cache is keyed on (stage structure, shapes, shards):
    same-shaped waves share one program, and a second identical run
    builds nothing at all."""
    path, seq = genome

    def case(mod, pkg):
        cache = mod.PlanCache()

        def run():
            r = _gc_runner(mod, pkg,
                           pkg["io"].fasta_source(path, split_bytes=512),
                           wave_bytes=1 << 11, prefetch=False,
                           plan_cache=cache)
            (t,) = r.collect()
            assert int(t[0]) == seq.count("G") + seq.count("C")
            return r.stats

        s1 = run()
        assert s1["num_waves"] >= 2
        # same-shaped waves share a program within the first run
        assert s1["programs_compiled"] <= s1["num_waves"]
        assert s1["program_cache_hits"] >= 1
        s2 = run()
        assert s2["programs_compiled"] == 0        # fully amortized
        assert s2["program_cache_hits"] == s2["num_waves"] + 1  # + fold
        return s1, s2
    ref, port = both(case)
    assert ref == port


def test_wave_runner_rejects_map_after_reduce(genome):
    path, _ = genome

    def case(mod, pkg):
        io = pkg["io"]
        r = io.WaveRunner(io.fasta_source(path), **pkg["kw"]).reduce(
            image="ubuntu", command="awk-sum")
        with pytest.raises(ValueError) as e:
            r.map(image="ubuntu", command="grep-chars GC")
        with pytest.raises(ValueError) as e2:
            r.reduce(image="ubuntu", command="awk-sum")
        return str(e.value), str(e2.value)
    ref, port = both(case)
    assert ref == port


def test_at_most_two_waves_resident(genome, monkeypatch):
    """With the cyclic collector off, so only references keep a wave
    alive, at most RESIDENT_WAVES waves' datasets exist when a wave's
    ingest starts (the one computing and the one being ingested), and
    none once ``collect()`` returns."""
    import repro_torch.io.waves as waves_mod
    path, seq = genome
    alive = []
    most = [0]
    ingest = waves_mod.ingest

    def counting_ingest(*args, **kwargs):
        most[0] = max(most[0], 1 + sum(r() is not None for r in alive))
        ds = ingest(*args, **kwargs)
        alive.append(weakref.ref(ds.records["data"]))
        return ds

    monkeypatch.setattr(waves_mod, "ingest", counting_ingest)
    runner = _gc_runner(T, PKGS[T],
                        TI.fasta_source(path, split_bytes=256),
                        wave_bytes=512, capacity=16, width=64)
    was = gc.isenabled()
    gc.disable()
    try:
        (total,) = runner.collect()
        left = sum(r() is not None for r in alive)
    finally:
        if was:
            gc.enable()
    assert int(total[0]) == seq.count("G") + seq.count("C")
    assert runner.stats["num_waves"] >= 6
    assert most[0] <= waves_mod.RESIDENT_WAVES
    assert left == 0
