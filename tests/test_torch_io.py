"""Ingestion: the port's framing and packing are byte-equal to the
reference's on FASTA, line and SMILES inputs, and ``ingest`` places the
same records in the same shard blocks; and the reference's own cases of
``tests/test_io.py`` (backends, split planning, formats, the columnar
framing's properties, ingest) through both packages on the same files."""
import os
import tempfile
import time

import jax
import numpy as np
import pytest
import torch

import repro.core as R_core
import repro.io as R
import repro_torch.core as T_core
import repro_torch.io as T
from repro import compat
from repro.io import formats as ref_formats
from repro.io.ingest import ingest as ref_ingest
from repro.io import source as ref_source
from repro_torch.io import formats as port_formats
from repro_torch.io.ingest import ingest as port_ingest
from repro_torch.io import source as port_source

FASTA = (b">chr1 test\nACGTNNacgt\nGGCC  \n\n;comment\nTTTTAAAACCCCGGGG\n"
         b">chr2\r\nACGT\r\nA\n")
TEXT = b"alpha beta\n\n   \n  lead\ttab\ntrailing   \nlast-no-newline"
SMILES = b"CCO ethanol 1\n\nc1ccccc1\tbenzene\n  N#N  nitrogen\nC"


@pytest.mark.parametrize("name,payload", [
    ("fasta", FASTA), ("text", TEXT), ("smiles", SMILES), ("fasta", b""),
])
def test_frame_and_pack_byte_equal(name, payload):
    rb = ref_formats.FORMATS[name].frame(payload)
    pb = port_formats.FORMATS[name].frame(payload)
    for f in ("buf", "starts", "lens"):
        a, b = getattr(rb, f), getattr(pb, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert rb.to_list() == pb.to_list()
    for cap, width in ((None, None), (16, 24)):
        rp = ref_formats.pack_batches([rb, rb], capacity=cap, width=width)
        pp = port_formats.pack_batches([pb, pb], capacity=cap, width=width)
        for k in ("data", "len"):
            assert rp[k].dtype == pp[k].dtype
            assert rp[k].tobytes() == pp[k].tobytes()
    assert ref_formats.FORMATS[name].parse(payload) == \
        port_formats.FORMATS[name].parse(payload)


def test_pack_records_and_unpack_equal():
    recs = [b"ACGT", b"", b"GGGGCCCC", b"N"]
    rp = ref_formats.pack_records(recs, capacity=6)
    pp = port_formats.pack_records(recs, capacity=6)
    assert rp["data"].tobytes() == pp["data"].tobytes()
    assert port_formats.unpack_records(pp, 4) == recs


def _write_genome(tmp_path, n_lines=300, seed=0):
    rng = np.random.default_rng(seed)
    path = tmp_path / "g.fa"
    lines = [b">chr"] + [rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8),
                                    size=int(w)).tobytes()
                         for w in rng.integers(10, 61, n_lines)]
    path.write_bytes(b"\n".join(lines) + b"\n")
    return str(path)


@pytest.mark.parametrize("num_shards", [1, 4])
def test_ingest_places_the_same_records(tmp_path, num_shards):
    path = _write_genome(tmp_path)
    rsrc = ref_source.fasta_source(path, split_bytes=1 << 11)
    mesh = compat.make_mesh((1,), ("data",))
    if num_shards == 1:
        rds = ref_ingest(rsrc, mesh)
        want = jax.device_get(rds.records)
        want_counts = np.asarray(jax.device_get(rds.counts))
    else:
        # the reference needs one device per shard; emulate its layout:
        # the same split bins, packed to the common geometry
        from repro.io.splits import assign_splits
        fmt = rsrc.fmt
        bins = assign_splits(rsrc.splits(), num_shards)
        batches = [[fmt.frame(fmt.read_payload(rsrc.backend, sp))
                    for sp in b] for b in bins]
        counts = [sum(len(x) for x in bs) for bs in batches]
        cap = -(-max(counts) // 64) * 64
        width = -(-max(x.max_len for bs in batches for x in bs) // 16) * 16
        packs = [ref_formats.pack_batches(bs, cap, width) for bs in batches]
        want = {k: np.concatenate([p[k] for p in packs]) for k in packs[0]}
        want_counts = np.asarray(counts, np.int32)
    psrc = port_source.fasta_source(path, split_bytes=1 << 11)
    pds = port_ingest(psrc, num_shards, device="cpu")
    assert pds.counts.dtype == torch.int32
    np.testing.assert_array_equal(pds.counts.numpy(), want_counts)
    for k in ("data", "len"):
        got = pds.records[k].numpy()
        assert got.dtype == want[k].dtype
        assert got.tobytes() == np.asarray(want[k]).tobytes()
    assert pds.lineage is not None


# -- tests/test_io.py through both packages ----------------------------------

PKGS = pytest.mark.parametrize("io", [R, T], ids=["reference", "port"])


@pytest.fixture
def text_file(tmp_path):
    p = tmp_path / "data.txt"
    lines = [f"record-{i:04d}-{'x' * (i % 17)}" for i in range(200)]
    p.write_text("\n".join(lines) + "\n")
    return str(p), lines


def _ingest(io, source, **kw):
    """Each package's ingest onto one shard, collected to host numpy."""
    if io is R:
        out = R_core.collect(R.ingest(
            source, compat.make_mesh((1,), ("data",)), **kw))
    else:
        out = T_core.collect(T.ingest(source, 1, device="cpu", **kw))
    return {k: np.asarray(v) for k, v in out.items()}


@PKGS
def test_localfs_list_size_read_range_twin(io, text_file):
    path, _ = text_file
    be = io.LocalFS(path)
    assert be.list() == [path]
    raw = open(path, "rb").read()
    assert be.size(path) == len(raw)
    assert be.read_range(path, 5, 25) == raw[5:25]
    assert be.read_range(path, len(raw) - 3, len(raw) + 50) == raw[-3:]


@PKGS
def test_localfs_lists_directory_recursively_twin(io, tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.txt").write_text("aaa\n")
    (tmp_path / "sub" / "b.txt").write_text("bbb\n")
    names = [os.path.basename(p) for p in io.LocalFS(str(tmp_path)).list()]
    assert names == ["a.txt", "b.txt"]


@PKGS
def test_emulated_backends_return_identical_bytes_twin(io, text_file):
    path, _ = text_file
    raw = open(path, "rb").read()
    for kind in ("hdfs", "swift", "s3"):
        be = io.make_backend(kind, path)
        assert be.name == kind
        assert be.read_range(path, 0, len(raw)) == raw
        assert be.stats["requests"] >= 1
    assert set(io.BACKEND_PROFILES) == {"hdfs", "swift", "s3"}
    assert T.BACKEND_PROFILES == R.BACKEND_PROFILES


@PKGS
def test_emulated_backend_latency_is_paid_twin(io, text_file):
    path, _ = text_file
    be = io.EmulatedObjectStore(io.LocalFS(path), latency_s=0.02)
    t0 = time.monotonic()
    be.read_range(path, 0, 10)
    assert time.monotonic() - t0 >= 0.02


def _split_tuples(splits):
    return [(s.path, s.start, s.stop, s.length) for s in splits]


def test_plan_splits_cover_file_exactly_twin(text_file):
    path, _ = text_file
    for split_bytes in (17, 100):
        got = T.plan_splits(T.LocalFS(path), split_bytes=split_bytes)
        size = T.LocalFS(path).size(path)
        assert got[0].start == 0 and got[-1].stop == size
        for a, b in zip(got, got[1:]):
            assert a.stop == b.start      # contiguous, no gaps/overlap
        assert sum(s.length for s in got) == size
        assert _split_tuples(got) == _split_tuples(
            R.plan_splits(R.LocalFS(path), split_bytes=split_bytes))


def test_plan_splits_num_splits_override_twin(text_file):
    path, _ = text_file
    got = T.plan_splits(T.LocalFS(path), num_splits=7)
    assert 6 <= len(got) <= 8
    assert _split_tuples(got) == _split_tuples(
        R.plan_splits(R.LocalFS(path), num_splits=7))


def test_assign_splits_balances_and_preserves_order_twin(text_file):
    path, _ = text_file
    splits = T.plan_splits(T.LocalFS(path), split_bytes=64)
    bins = T.assign_splits(splits, 4)
    assert sum(len(b) for b in bins) == len(splits)
    loads = [sum(s.length for s in b) for b in bins]
    assert max(loads) - min(loads) <= 2 * 64
    for b in bins:   # plan order within a shard
        starts = [(s.path, s.start) for s in b]
        assert starts == sorted(starts)
    ref = R.assign_splits(R.plan_splits(R.LocalFS(path), split_bytes=64), 4)
    assert [_split_tuples(b) for b in bins] == \
        [_split_tuples(b) for b in ref]


@PKGS
def test_line_format_exactly_once_across_any_split_size_twin(io, text_file):
    """The InputFormat ownership rule: every record is read exactly once
    no matter how the file is carved."""
    path, lines = text_file
    be = io.LocalFS(path)
    fmt = io.LineFormat()
    expected = [ln.encode() for ln in lines]
    for split_bytes in (17, 64, 100, 999, 10 ** 9):
        splits = io.plan_splits(be, split_bytes=split_bytes)
        got = [r for sp in splits for r in fmt.read_split(be, sp)]
        assert got == expected, f"split_bytes={split_bytes}"


@PKGS
def test_fasta_format_drops_headers_twin(io, tmp_path):
    p = tmp_path / "g.fa"
    p.write_text(">chr1 desc\nATGC\nGGCC\n>chr2\nTTAA\n")
    be = io.LocalFS(str(p))
    (sp,) = io.plan_splits(be)
    assert io.FastaFormat().read_split(be, sp) == [b"ATGC", b"GGCC", b"TTAA"]


@PKGS
def test_smiles_format_first_token_twin(io, tmp_path):
    p = tmp_path / "m.smi"
    p.write_text("CCO ethanol 42\nc1ccccc1 benzene\n\nO water\n")
    be = io.LocalFS(str(p))
    (sp,) = io.plan_splits(be)
    assert io.SmilesFormat().read_split(be, sp) == [b"CCO", b"c1ccccc1",
                                                     b"O"]


@PKGS
def test_pack_unpack_roundtrip_twin(io):
    recs = [b"a", b"bb", b"", b"dddd"]
    packed = io.pack_records(recs, capacity=8, width=16)
    assert packed["data"].shape == (8, 16)
    assert packed["data"].dtype == np.uint8
    assert list(packed["len"][:4]) == [1, 2, 0, 4]
    assert io.unpack_records(packed, count=4) == recs
    with pytest.raises(ValueError):
        io.pack_records(recs, capacity=2)
    with pytest.raises(ValueError):
        io.pack_records(recs, width=2)


def _random_payload(fmt_name: str, rng: np.random.Generator) -> bytes:
    """The reference's adversarial payloads (``tests/test_io.py``): empty
    and whitespace-only lines, CR before LF, a last record without its
    newline, runs of FASTA headers, SMILES lines with several spaces and
    missing metadata."""
    lines = []
    for _ in range(int(rng.integers(0, 40))):
        kind = rng.random()
        body = "".join(rng.choice(list("ACGTacgt01xyz"),
                                  size=int(rng.integers(0, 12))))
        if kind < 0.12:
            lines.append("")
        elif kind < 0.2:
            lines.append(" \t " if fmt_name != "smiles" else "  ")
        elif kind < 0.35 and fmt_name == "fasta":
            lines.append(rng.choice([">", ";"]) + "hdr " + body)
        elif kind < 0.35 and fmt_name == "smiles":
            lines.append(body + rng.choice(["", " name 42", "\tmeta",
                                            "  two  spaces"]))
        elif kind < 0.45:
            lines.append(body + "\r")
        else:
            lines.append(body)
    payload = "\n".join(lines)
    if lines and rng.random() < 0.7:
        payload += "\n"
    return payload.encode()


def test_frame_matches_parse_on_adversarial_payloads_twin():
    """The port's columnar framing against its per-line parser and against
    the reference's framing, over the three formats, the hand-picked edge
    cases and 150 random payloads."""
    fixed = [b"", b"\n", b"\n\n\n", b"abc", b"abc\n", b"a\n\nb\n",
             b" \t\n x \n", b">only-header\n", b">h1\n>h2\n;h3\n",
             b"tok rest\n\ntok2\t\n", b"a\r\nb\r\n", b"x"]
    rng = np.random.default_rng(7)
    assert set(port_formats.FORMATS) == set(ref_formats.FORMATS)
    for name, fmt in port_formats.FORMATS.items():
        ref = ref_formats.FORMATS[name]
        payloads = fixed + [_random_payload(name, rng) for _ in range(50)]
        for payload in payloads:
            batch = fmt.frame(payload)
            assert batch.to_list() == fmt.parse(payload), (name, payload)
            rb = ref.frame(payload)
            for f in ("buf", "starts", "lens"):
                assert getattr(batch, f).tobytes() == \
                    getattr(rb, f).tobytes(), (name, payload, f)


def test_split_carving_exactly_once_property_twin():
    """The ownership rule as a property in the port: for random contents
    and random split boundaries the union of per-split records is the
    whole-file parse, exactly once and in order, on the per-line and the
    columnar read paths, and each split reads what the reference's does."""
    from repro_torch.io.splits import InputSplit
    from repro.io.splits import InputSplit as R_InputSplit
    rng = np.random.default_rng(11)
    for name, fmt in port_formats.FORMATS.items():
        ref = ref_formats.FORMATS[name]
        for trial in range(12):
            payload = _random_payload(name, rng)
            if not payload:
                continue
            expected = fmt.parse(payload)
            ncuts = int(rng.integers(0, 8))
            cuts = sorted({0, len(payload),
                           *rng.integers(1, max(len(payload), 2),
                                         size=ncuts).tolist()})
            with tempfile.NamedTemporaryFile(suffix=".dat") as f:
                f.write(payload)
                f.flush()
                be, rbe = T.LocalFS(f.name), R.LocalFS(f.name)
                splits = [InputSplit(f.name, a, b, len(payload))
                          for a, b in zip(cuts, cuts[1:])]
                per = [fmt.read_split(be, sp) for sp in splits]
                batched = [r for sp in splits
                           for r in fmt.read_split_batch(be, sp).to_list()]
                want = [ref.read_split(rbe, R_InputSplit(f.name, a, b,
                                                         len(payload)))
                        for a, b in zip(cuts, cuts[1:])]
            assert [r for p in per for r in p] == expected, (name, cuts)
            assert batched == expected, (name, trial, cuts, payload)
            assert per == want, (name, trial, cuts, payload)


def test_pack_batches_matches_pack_records_oracle_twin():
    """The port's bulk gather == its row-at-a-time packing == the
    reference's, over ragged, empty, zero-length and uniform batches."""
    rng = np.random.default_rng(3)
    cases = [[], [[]], [[b""], [b"", b""]], [[b"abc", b"de", b"", b"fghij"]],
             [[b"aaaa"] * 5], [[b"xy"], [], [b"z" * 30, b""], [b"q"] * 3]]
    for _ in range(10):
        cases.append([[bytes(rng.integers(0, 256, int(rng.integers(0, 9)),
                                          dtype=np.uint8).tobytes())
                       for _ in range(int(rng.integers(0, 7)))]
                      for _ in range(int(rng.integers(1, 4)))])
    for recs_per_batch in cases:
        flat = [r for recs in recs_per_batch for r in recs]
        cap = max(len(flat), 1) + int(rng.integers(0, 4))
        w = max(max((len(r) for r in flat), default=1)
                + int(rng.integers(0, 4)), 1)
        oracle = T.pack_records(flat, capacity=cap, width=w)
        got = T.pack_batches([T.RecordBatch.from_records(recs)
                              for recs in recs_per_batch],
                             capacity=cap, width=w)
        ref = R.pack_records(flat, capacity=cap, width=w)
        for k in ("data", "len"):
            np.testing.assert_array_equal(got[k], oracle[k])
            assert got[k].tobytes() == ref[k].tobytes()
    with pytest.raises(ValueError):
        T.pack_batches([T.RecordBatch.from_records([b"abc"])], width=2)
    with pytest.raises(ValueError):
        T.pack_batches([T.RecordBatch.from_records([b"a", b"b"])],
                       capacity=1)


def test_ingest_parser_parity_and_validation_twin(text_file):
    """The port's vectorized ingest == its legacy ingest == the
    reference's (the same bytes), pooled == serial, and an unknown parser
    name raises in both."""
    path, _ = text_file
    ref = _ingest(R, R.text_source(path, split_bytes=128), parser="legacy")
    legacy = _ingest(T, T.text_source(path, split_bytes=128),
                     parser="legacy")
    for workers in (1, 4):
        out = _ingest(T, T.text_source(path, split_bytes=128),
                      workers=workers)
        for k in ("data", "len"):
            np.testing.assert_array_equal(out[k], legacy[k])
            assert out[k].dtype == ref[k].dtype
            assert out[k].tobytes() == ref[k].tobytes()
    with pytest.raises(ValueError, match="parser"):
        T.ingest(T.text_source(path), 1, device="cpu", parser="simd")
    with pytest.raises(ValueError, match="parser"):
        R.ingest(R.text_source(path), compat.make_mesh((1,), ("data",)),
                 parser="simd")


@PKGS
def test_ingest_roundtrips_all_records_twin(io, text_file):
    path, lines = text_file
    out = _ingest(io, io.text_source(path, split_bytes=128))
    got = sorted(io.unpack_records(out, count=len(out["len"])))
    assert got == sorted(ln.encode() for ln in lines)


def test_ingest_through_emulated_backend_matches_local_twin(tmp_path):
    p = tmp_path / "g.fa"
    p.write_text(">h\n" + "\n".join(["ATGCGC"] * 50) + "\n")
    ref = _ingest(R, R.fasta_source(str(p), split_bytes=64))
    local = _ingest(T, T.fasta_source(str(p), split_bytes=64))
    for k in ("data", "len"):
        assert local[k].tobytes() == ref[k].tobytes()
    for kind in ("hdfs", "swift", "s3"):
        src = T.fasta_source(str(p), backend=T.make_backend(kind, str(p)),
                             split_bytes=64)
        out = _ingest(T, src)
        for k in ("data", "len"):
            np.testing.assert_array_equal(out[k], local[k])


@PKGS
def test_ingest_capacity_overflow_raises_twin(io, text_file):
    path, _ = text_file
    with pytest.raises(ValueError, match="capacity"):
        _ingest(io, io.text_source(path), capacity=4)


def test_mare_from_source_gc_pipeline_twin(tmp_path):
    p = tmp_path / "g.fa"
    rng = np.random.default_rng(0)
    seq = "".join(np.array(list("ATGC"))[rng.integers(0, 4, 3000)])
    p.write_text(">chr\n" + "\n".join(
        seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    got = []
    for io, core, kw in ((R, R_core, {}), (T, T_core, {"device": "cpu"})):
        total = (core.MaRe.from_source(io.fasta_source(str(p),
                                                       split_bytes=256),
                                       **kw)
                 .map(image="ubuntu", command="grep-chars GC")
                 .reduce(image="ubuntu", command="awk-sum")
                 .collect(shard=0))
        got.append(int(np.asarray(total[0])[0]))
    assert got == [seq.count("G") + seq.count("C")] * 2
