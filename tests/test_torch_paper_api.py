"""The paper's spellings through the port against the reference's.

The cases are the reference's ``tests/test_paper_api.py``, each run
through both packages and compared: Listing 1's camelCase mount kwargs
over ``TextFile``, Listing 3's ``BinaryFiles`` over byte records, the
``repartitionBy`` and ``reduceByKey`` aliases through ``collect()``,
snake_case and camelCase mounts giving one result, and a ``BinaryFiles``
mount naming a file the records lack, refused when the chain is built.
Every paper spelling is a deprecated shim in both packages; this module
opts out of the warnings' error filter because exercising them is its
job.
"""
import numpy as np
import pytest

import repro.core as R
import repro.io.formats as R_formats
import repro_torch.core as T
import repro_torch.io.formats as T_formats

pytestmark = [
    pytest.mark.filterwarnings(
        "always::repro.deprecations.MaReDeprecationWarning"),
    pytest.mark.filterwarnings(
        "always::repro_torch.deprecations.MaReDeprecationWarning"),
]

PKGS = {R: dict(formats=R_formats, kw={}),
        T: dict(formats=T_formats, kw={"device": "cpu"})}


def both(case):
    """case(core, formats, MaRe kwargs) for the reference, then the
    port."""
    return tuple(case(mod, p["formats"], p["kw"]) for mod, p in PKGS.items())


def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _key_mod3(recs):
    return recs[0] % 3


def test_listing1_textfile_mount_points_full_chain():
    """Listing 1 spelling: camelCase mount kwargs through map + reduce."""
    dna = np.random.default_rng(11).integers(0, 4, size=123).astype(np.int32)

    def case(mod, formats, kw):
        out = (mod.MaRe((dna,), plan_cache=mod.PlanCache(), **kw)
               .map(inputMountPoint=mod.TextFile("/dna", dtype=np.int32),
                    outputMountPoint=mod.TextFile("/count"),
                    image="ubuntu", command="grep-count 2 3")
               .reduce(inputMountPoint=mod.TextFile("/counts"),
                       outputMountPoint=mod.TextFile("/sum"),
                       image="ubuntu", command="awk-sum"))
        return int(_np(out.collect(shard=0)[0])[0])

    ref, port = both(case)
    assert ref == port == int(np.sum((dna == 2) | (dna == 3)))


def test_listing3_binaryfiles_mount_over_byte_records():
    """BinaryFiles (paper Listing 3): dict-of-named-arrays records flow
    through a byte-oriented container with the mount keys checked."""
    records = [b"GCGCAA", b"TTTT", b"CCG"]
    expected = sum(r.count(b"G") + r.count(b"C") for r in records)

    def case(mod, formats, kw):
        packed = formats.pack_records(records, capacity=8)
        out = (mod.MaRe(packed, plan_cache=mod.PlanCache(), **kw)
               .map(inputMountPoint=mod.BinaryFiles("/dna",
                                                    keys=("data", "len")),
                    outputMountPoint=mod.TextFile("/count"),
                    image="ubuntu", command="grep-chars GC")
               .reduce(image="ubuntu", command="awk-sum"))
        return int(_np(out.collect(shard=0)[0])[0])

    assert both(case) == (expected, expected)


def test_repartitionBy_alias_full_collect():
    data = np.arange(24, dtype=np.int32)

    def case(mod, formats, kw):
        m = mod.MaRe((data,), plan_cache=mod.PlanCache(), **kw).repartitionBy(
            _key_mod3)
        return _np(m.collect()[0])

    ref, port = both(case)
    np.testing.assert_array_equal(ref, port)
    assert sorted(port.tolist()) == data.tolist()


def test_reduceByKey_alias_full_collect():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 5, size=40).astype(np.int32)
    vals = rng.normal(size=40).astype(np.float32)

    def case(mod, formats, kw):
        m = mod.MaRe((keys, vals), plan_cache=mod.PlanCache(),
                     **kw).reduceByKey(lambda r: r[0],
                                       value_by=lambda r: (r[1],),
                                       op="sum", num_keys=5)
        out_keys, (out_sum,), out_cnt = m.collect()
        return _np(out_keys), _np(out_sum), _np(out_cnt)

    (rk, rs, rc), (pk, ps, pc) = both(case)
    np.testing.assert_array_equal(rk, pk)
    np.testing.assert_array_equal(rc, pc)
    # the sums to 1e-6: the folds add in another order (five keys of ~8
    # values, |sum| < 10)
    np.testing.assert_allclose(ps, rs, rtol=0, atol=1e-6)
    for k, s, c in zip(pk, ps, pc):
        sel = keys == int(k)
        assert int(c) == int(sel.sum())
        assert abs(float(s) - float(vals[sel].sum())) < 1e-4


def test_snake_case_and_camel_case_mounts_are_interchangeable():
    dna = np.arange(16, dtype=np.int32) % 4

    def case(mod, formats, kw):
        a = (mod.MaRe((dna,), plan_cache=mod.PlanCache(), **kw)
             .map(input_mount=mod.TextFile("/dna"),
                  output_mount=mod.TextFile("/c"),
                  image="ubuntu", command="grep-count 1"))
        b = (mod.MaRe((dna,), plan_cache=mod.PlanCache(), **kw)
             .map(inputMountPoint=mod.TextFile("/dna"),
                  outputMountPoint=mod.TextFile("/c"),
                  image="ubuntu", command="grep-count 1"))
        got = _np(a.collect()[0])
        np.testing.assert_array_equal(got, _np(b.collect()[0]))
        return got

    ref, port = both(case)
    np.testing.assert_array_equal(ref, port)


def test_binaryfiles_missing_key_fails_at_build():
    def case(mod, formats, kw):
        packed = formats.pack_records([b"ACGT"], capacity=4)
        with pytest.raises(mod.PlanTypeError, match="missing files") as err:
            mod.MaRe(packed, plan_cache=mod.PlanCache(), **kw).map(
                inputMountPoint=mod.BinaryFiles("/dna",
                                                keys=("data", "quality")),
                image="ubuntu", command="grep-chars GC")
        return str(err.value)

    ref, port = both(case)
    assert ref == port
