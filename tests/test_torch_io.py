"""Ingestion: the port's framing and packing are byte-equal to the
reference's on FASTA, line and SMILES inputs, and ``ingest`` places the
same records in the same shard blocks."""
import jax
import numpy as np
import pytest
import torch

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
