"""The port's data pipeline (``repro_torch.data``) against the reference's
(``repro.data``): sources, LM batch packing, the prefetcher with
speculative re-dispatch, and the tokenizer image.

The cases are the reference's ``tests/test_data.py``, each run through
both packages on the same seeds; batches, prefetched values and token
ids are compared exactly.
"""
import time

import numpy as np

import repro.core as R
import repro.data as RD
import repro_torch.core as T
import repro_torch.data as TD

PKGS = {R: dict(data=RD, kw={}), T: dict(data=TD, kw={"device": "cpu"})}


def both(case):
    """case(mod, pkg) for the reference, then the port; returns both."""
    return case(R, PKGS[R]), case(T, PKGS[T])


def test_lm_batches_shapes_and_shift():
    def case(mod, pkg):
        d = pkg["data"]
        src = d.SyntheticText(100, doc_len=64, seed=0)
        it = d.lm_batches(src, batch=3, seq=16, vocab_size=100)
        return [next(it) for _ in range(3)]
    ref, port = both(case)
    b = port[0]
    assert b["tokens"].shape == (3, 16)
    assert b["labels"].shape == (3, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    for rb, pb in zip(ref, port):
        assert sorted(rb) == sorted(pb)
        for k in rb:
            assert rb[k].dtype == pb[k].dtype
            np.testing.assert_array_equal(pb[k], rb[k])


def test_source_determinism():
    def case(mod, pkg):
        d = pkg["data"]
        a = next(iter(d.SyntheticText(50, doc_len=32, seed=7)))
        b = next(iter(d.SyntheticText(50, doc_len=32, seed=7)))
        np.testing.assert_array_equal(a, b)
        return a
    ref, port = both(case)
    np.testing.assert_array_equal(port, ref)


def test_prefetcher_produces():
    def case(mod, pkg):
        d = pkg["data"]
        src = d.SyntheticText(100, doc_len=64, seed=0)
        pf = d.Prefetcher(lambda: d.lm_batches(src, 2, 8, 100), capacity=2)
        batches = [next(pf) for _ in range(5)]
        assert pf.stats["produced"] >= 5
        pf.close()
        return [b["tokens"] for b in batches]
    ref, port = both(case)
    assert len(port) == 5
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p, r)


def test_prefetcher_straggler_respawn():
    """A slow batch triggers speculative re-dispatch (stats counted)."""
    def make_iter():
        def gen():
            i = 0
            while True:
                if i == 2:
                    time.sleep(0.4)       # straggler
                yield {"i": np.asarray([i])}
                i += 1
        return gen()

    def case(mod, pkg):
        pf = pkg["data"].Prefetcher(make_iter, capacity=2, deadline_s=0.1)
        got = [int(next(pf)["i"][0]) for _ in range(5)]
        assert pf.stats["respawned"] >= 1
        pf.close()
        return got
    ref, port = both(case)
    assert ref == port == [0, 1, 2, 3, 4]   # order + exactly-once output


def test_tokenizer_image_registered():
    vocab = 17

    def case(mod, pkg):
        pkg["data"].register_tokenizer_image()
        raw = np.concatenate([np.arange(40, dtype=np.int32),
                              np.array([-1, -7, 2 ** 31 - 1], np.int32)])
        out = mod.MaRe((raw,), **pkg["kw"]).map(
            image="tools/tokenizer", vocab_size=vocab).collect()
        assert out[0].shape == (43,)
        assert out[0].max() < vocab
        return out[0]
    ref, port = both(case)
    assert ref.dtype == port.dtype
    np.testing.assert_array_equal(port, ref)
