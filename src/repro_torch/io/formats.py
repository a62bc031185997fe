"""Record formats: framing + packing for byte-oriented datasets.

A :class:`RecordFormat` turns a byte-range split into complete records
(Hadoop RecordReader analogue) and :func:`pack_batches` packs the
variable-length records into the fixed-shape static-SPMD contract the rest
of the stack assumes:

    {"data": uint8 [capacity, width], "len": int32 [capacity]}

The hot path is **columnar**: :meth:`RecordFormat.read_split_batch`
returns a :class:`RecordBatch` — one contiguous ``uint8`` payload buffer
plus ``starts``/``lens`` int32 offset arrays — produced by vectorized
framing (``np.frombuffer`` the payload once, newline offsets via
``np.flatnonzero(buf == 0x0A)``, then a per-format offset-array
transform).  No per-record ``bytes`` objects are materialized between
storage and the packed device buffer; :func:`pack_batches` turns a list
of batches into the ``[cap, width]`` array with one masked
advanced-indexing gather per batch.  The legacy per-line path
(:meth:`RecordFormat.read_split` / :func:`pack_records`) is kept as the
parity oracle — ``tests/test_torch_io.py`` pins both paths byte-equal.

Split-boundary rule (classic InputFormat semantics): a record is owned by
the split containing its **first byte**.  A reader starting mid-file
discards the partial leading record (it belongs to the previous split) and
reads past its end offset to finish its last record, so every record is
read exactly once regardless of how files are carved.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.schema import Schema, bytes_record_schema
from repro_torch.io.backends import StorageBackend
from repro_torch.io.splits import InputSplit

_READAHEAD = 1 << 16

#: byte -> "is ASCII whitespace" lookup (the set ``bytes.strip()`` uses),
#: for whole-payload masks; per-row edge tests use :func:`_is_ws` on
#: gathered bytes instead (O(rows), not O(payload))
_WS_TABLE = np.zeros(256, np.bool_)
_WS_TABLE[[0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20]] = True

_EMPTY_U8 = np.empty(0, np.uint8)
_EMPTY_I32 = np.empty(0, np.int32)


def _is_ws(vals: np.ndarray) -> np.ndarray:
    """ASCII-whitespace test on gathered row-edge bytes (newlines never
    appear inside a framed row, but including 0x0A keeps this total)."""
    return ((vals == 0x20) | (vals == 0x09) | (vals == 0x0A)
            | (vals == 0x0D) | (vals == 0x0B) | (vals == 0x0C))


@dataclasses.dataclass(frozen=True)
class RecordBatch:
    """Columnar framed records: views into one contiguous payload buffer.

    ``buf`` is the split's raw payload (``np.frombuffer`` — zero-copy);
    record *i* is ``buf[starts[i] : starts[i] + lens[i]]``.  Framing and
    format selection are offset-array transforms, so a batch never owns
    per-record ``bytes`` objects.
    """

    buf: np.ndarray      # uint8 [payload_bytes]
    starts: np.ndarray   # int32 [n]
    lens: np.ndarray     # int32 [n]

    def __len__(self) -> int:
        return int(self.starts.shape[0])

    @property
    def max_len(self) -> int:
        """Longest record in the batch (0 for an empty batch)."""
        return int(self.lens.max()) if self.lens.size else 0

    @property
    def payload_bytes(self) -> int:
        return int(self.buf.size)

    def to_list(self) -> List[bytes]:
        """Materialize per-record ``bytes`` (tests/debugging only)."""
        return [bytes(self.buf[s:s + ln]) for s, ln in
                zip(self.starts.tolist(), self.lens.tolist())]

    @classmethod
    def empty(cls) -> "RecordBatch":
        return cls(_EMPTY_U8, _EMPTY_I32, _EMPTY_I32)

    @classmethod
    def from_records(cls, records: Sequence[bytes]) -> "RecordBatch":
        """Columnarize a record list (legacy-path bridge and tests)."""
        if not records:
            return cls.empty()
        lens = np.asarray([len(r) for r in records], np.int32)
        starts = np.zeros(len(records), np.int32)
        np.cumsum(lens[:-1], out=starts[1:])
        buf = np.frombuffer(b"".join(records), np.uint8)
        return cls(buf, starts, lens)


class RecordFormat:
    """Line-framed record reader; subclasses refine record extraction."""

    name = "base"

    @property
    def schema(self) -> Schema:
        """The record schema :func:`pack_batches` output satisfies — the
        same ``{"data": u8[W], "len": i32}`` contract byte-oriented image
        manifests declare as their input, so an ingested dataset
        type-checks against e.g. ``grep-chars``/``kmer-stats`` at plan
        time (``W`` binds to the packed width)."""
        return bytes_record_schema()

    # -- legacy per-line path (parity oracle) --------------------------------

    def records_from_lines(self, lines: List[bytes]) -> List[bytes]:
        """Map complete, newline-stripped lines to records."""
        raise NotImplementedError  # pragma: no cover - abstract

    def parse(self, payload: bytes) -> List[bytes]:
        """Records in a payload that starts and ends on record boundaries."""
        lines = [ln for ln in payload.split(b"\n")]
        if lines and lines[-1] == b"":
            lines.pop()
        return self.records_from_lines(lines)

    def read_split(self, backend: StorageBackend, split: InputSplit,
                   readahead: int = _READAHEAD) -> List[bytes]:
        """All records whose first byte lies in ``[split.start,
        split.stop)``, as a ``bytes`` list (legacy per-line path)."""
        payload = self.read_payload(backend, split, readahead)
        return self.parse(payload) if payload else []

    # -- columnar path -------------------------------------------------------

    def _select(self, buf: np.ndarray, starts: np.ndarray,
                ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Format-specific offset transform: framed line extents
        ``[starts, ends)`` -> record ``(starts, lens)``."""
        raise NotImplementedError  # pragma: no cover - abstract

    def frame(self, payload: bytes) -> RecordBatch:
        """Vectorized :meth:`parse`: one ``frombuffer``, newline offsets
        via ``flatnonzero``, then the per-format offset transform."""
        buf = np.frombuffer(payload, np.uint8)
        if buf.size == 0:
            return RecordBatch.empty()
        nl = np.flatnonzero(buf == 0x0A)
        # line i spans [starts[i], ends[i]); a trailing newline would
        # open a phantom zero-length line past the buffer — parse() pops
        # it, here it simply never gets an extent
        if buf[-1] == 0x0A:
            ends = nl
        else:
            ends = np.concatenate([nl, [buf.size]])
        starts = np.concatenate([[0], nl + 1])[:ends.size]
        rec_starts, rec_lens = self._select(buf, starts, ends)
        return RecordBatch(buf, rec_starts.astype(np.int32),
                           rec_lens.astype(np.int32))

    def read_split_batch(self, backend: StorageBackend, split: InputSplit,
                         readahead: int = _READAHEAD) -> RecordBatch:
        """Columnar :meth:`read_split`: the split's records as a
        :class:`RecordBatch` (the ingest hot path)."""
        return self.frame(self.read_payload(backend, split, readahead))

    # -- shared payload reader ----------------------------------------------

    def read_payload(self, backend: StorageBackend, split: InputSplit,
                     readahead: int = _READAHEAD) -> bytes:
        """The split's record-aligned payload: head-trimmed past the
        previous split's partial record, tail-extended through the final
        record's newline.  Shared by both parse paths."""
        size = split.file_size
        if split.start > 0:
            # peek one byte back: if byte start-1 is a newline, a record
            # begins exactly at `start` and is ours; otherwise we are
            # mid-record and the partial head belongs to the previous
            # split — skip through the first newline.
            data = backend.read_range(split.path, split.start - 1,
                                      split.stop)
            if data[:1] == b"\n":
                data = data[1:]
            else:
                nl = data.find(b"\n")
                if nl < 0:
                    # the record containing split.start extends past
                    # split.stop; it is owned by an earlier split.
                    return b""
                data = data[nl + 1:]
        else:
            data = backend.read_range(split.path, 0, split.stop)
        # empty after head-trim: the split's last byte was the terminating
        # newline of a record owned by an earlier split, and the next
        # record starts at `stop` — owned by the next split.
        if not data:
            return b""
        # extend past stop to finish the final record; chunks accumulate
        # in a list and join once (appending to `data` would recopy the
        # whole payload per readahead iteration — quadratic on records
        # spanning many readahead windows)
        chunks = [data]
        pos = split.stop
        while pos < size and not chunks[-1].endswith(b"\n"):
            extra = backend.read_range(split.path, pos,
                                       min(pos + readahead, size))
            if not extra:
                break
            nl = extra.find(b"\n")
            if nl >= 0:
                chunks.append(extra[:nl + 1])
                break
            chunks.append(extra)
            pos += len(extra)
        return b"".join(chunks) if len(chunks) > 1 else data


def _strip_extents(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whitespace-strip line extents (``bytes.strip`` semantics): trim
    whitespace off both row edges by iterated O(rows) edge-byte gathers
    (each pass advances every row that still has a whitespace edge, so
    iterations = longest edge run — 0 or 1 on clean data).  Returns
    ``(keep, starts, ends)``: the stripped-nonempty row mask plus the
    trimmed extents (unfiltered — index with ``keep`` as needed)."""
    s = starts.astype(np.int64, copy=True)
    e = ends.astype(np.int64, copy=True)
    top = max(buf.size - 1, 0)
    while True:
        m = (s < e) & _is_ws(buf[np.minimum(s, top)])
        if not m.any():
            break
        s[m] += 1
    while True:
        m = (e > s) & _is_ws(buf[np.maximum(e - 1, 0)])
        if not m.any():
            break
        e[m] -= 1
    return e > s, s, e


class LineFormat(RecordFormat):
    """Line-delimited text: every non-empty line is one record."""

    name = "text"

    def records_from_lines(self, lines: List[bytes]) -> List[bytes]:
        return [ln for ln in lines if ln.strip()]

    def _select(self, buf, starts, ends):
        # records keep the line UNSTRIPPED (parity with the oracle above:
        # strip() is only the blank-line test)
        keep, _, _ = _strip_extents(buf, starts, ends)
        return starts[keep], (ends - starts)[keep]


class FastaFormat(RecordFormat):
    """FASTA: header lines (``>``) are dropped; each sequence line is one
    record (a fixed-width-friendly chunking of the sequence — exact for
    any per-base statistic such as GC count)."""

    name = "fasta"

    def records_from_lines(self, lines: List[bytes]) -> List[bytes]:
        out = []
        for ln in lines:
            ln = ln.strip()
            if ln and not ln.startswith(b">") and not ln.startswith(b";"):
                out.append(ln)
        return out

    def _select(self, buf, starts, ends):
        keep, s, e = _strip_extents(buf, starts, ends)
        s, e = s[keep], e[keep]
        # header mask: one gather of each stripped row's first byte
        first = buf[s]
        body = (first != 0x3E) & (first != 0x3B)      # not '>' nor ';'
        return s[body], (e - s)[body]


class SmilesFormat(RecordFormat):
    """SMILES: the first whitespace-separated token of each line (the
    molecule string; trailing columns are ids/metadata)."""

    name = "smiles"

    def records_from_lines(self, lines: List[bytes]) -> List[bytes]:
        out = []
        for ln in lines:
            parts = ln.split()
            if parts:
                out.append(parts[0])
        return out

    def _select(self, buf, starts, ends):
        keep, s, e = _strip_extents(buf, starts, ends)
        s, e = s[keep], e[keep]
        # clamp each row's length at the first whitespace after the token
        # start: searchsorted into the whole-payload ws index list finds
        # it without touching row bytes (the row-terminating newline is
        # itself ws, so in-bounds hits are guaranteed except for a final
        # unterminated row — clamped by the row end)
        wz = np.flatnonzero(_WS_TABLE[buf])
        if wz.size == 0:                    # no whitespace anywhere
            return s, e - s
        cut = np.searchsorted(wz, s)
        tok_end = np.where(cut < wz.size,
                           wz[np.minimum(cut, wz.size - 1)],
                           buf.size)
        tok_end = np.minimum(tok_end, e)
        return s, tok_end - s


FORMATS = {f.name: f for f in (LineFormat(), FastaFormat(), SmilesFormat())}


def pack_batches(batches: Sequence[RecordBatch],
                 capacity: Optional[int] = None,
                 width: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pack record batches into ``{"data": [cap, width] u8, "len": [cap]
    i32}`` with one masked advanced-indexing gather per batch.

    The batches' records are laid out consecutively (batch order, record
    order within a batch).  ``capacity``/``width`` default to the total
    record count / longest record.  Records longer than ``width`` raise
    (truncation would corrupt data).  No intermediate per-record ``bytes``
    objects are created — bytes move straight from each batch's payload
    buffer into the packed array.
    """
    n = sum(len(b) for b in batches)
    cap = capacity if capacity is not None else max(n, 1)
    if n > cap:
        raise ValueError(f"{n} records exceed capacity {cap}")
    maxlen = max((b.max_len for b in batches), default=0)
    w = width if width is not None else max(maxlen, 1)
    if maxlen > w:
        raise ValueError(f"record length {maxlen} exceeds width {w}")
    data = np.zeros((cap, w), np.uint8)
    lens = np.zeros((cap,), np.int32)
    col = np.arange(w, dtype=np.int64)
    row = 0
    for b in batches:
        m = len(b)
        if m == 0:
            continue
        lens[row:row + m] = b.lens
        length0 = int(b.lens[0])
        # uniform-geometry fast path: fixed-width records at a constant
        # offset stride (wrapped FASTA, fixed-width text) are a strided
        # VIEW of the payload — one memcpy into the packed array, no
        # index arrays at all
        uniform = bool((b.lens == length0).all()) and (
            m == 1 or bool((np.diff(b.starts)
                            == int(b.starts[1] - b.starts[0])).all()))
        if b.buf.size == 0 or b.max_len == 0:
            pass                            # zero-length rows: lens only
        elif uniform:
            if m == 1:
                start0 = int(b.starts[0])
                data[row, :length0] = b.buf[start0:start0 + length0]
            else:
                stride = int(b.starts[1] - b.starts[0])
                view = np.lib.stride_tricks.as_strided(
                    b.buf[int(b.starts[0]):], shape=(m, length0),
                    strides=(stride, 1))
                data[row:row + m, :length0] = view
        else:
            # general path — one [m, w] masked gather: row i reads
            # buf[starts[i] : starts[i]+w], clamped in-bounds; the mask
            # zeroes the cols past lens[i]
            idx = b.starts[:, None].astype(np.int64) + col[None, :]
            np.minimum(idx, b.buf.size - 1, out=idx)
            mask = col[None, :] < b.lens[:, None]
            data[row:row + m] = np.where(mask, b.buf[idx], 0)
        row += m
    return {"data": data, "len": lens}


def pack_records(records: List[bytes], capacity: Optional[int] = None,
                 width: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pack byte records into ``{"data": [cap, width] u8, "len": [cap] i32}``.

    Legacy row-at-a-time packer, kept as :func:`pack_batches`' parity
    oracle.  ``capacity``/``width`` default to the record count / longest
    record; when ``width`` is passed explicitly (ingest already knows the
    max) the separate O(n) max-length pre-scan is skipped and overlong
    records are caught row-by-row.  Records longer than ``width`` raise
    (truncation would corrupt data).
    """
    n = len(records)
    cap = capacity if capacity is not None else max(n, 1)
    if n > cap:
        raise ValueError(f"{n} records exceed capacity {cap}")
    if width is None:
        w = max(max((len(r) for r in records), default=1), 1)
    else:
        w = width
    data = np.zeros((cap, w), np.uint8)
    lens = np.zeros((cap,), np.int32)
    for i, r in enumerate(records):
        if len(r) > w:
            raise ValueError(f"record length {len(r)} exceeds width {w}")
        buf = np.frombuffer(r, np.uint8)
        data[i, :buf.shape[0]] = buf
        lens[i] = buf.shape[0]
    return {"data": data, "len": lens}


def unpack_records(packed: Dict[str, Any], count: Optional[int] = None
                   ) -> List[bytes]:
    """Inverse of :func:`pack_batches` (host-side, for tests/debugging):
    one bulk copy out of the array, then per-record slices of that single
    ``bytes`` object (no per-row numpy indexing)."""
    data = np.ascontiguousarray(np.asarray(packed["data"]), dtype=np.uint8)
    lens = np.asarray(packed["len"])
    n = int(count if count is not None else data.shape[0])
    w = int(data.shape[1])
    raw = data[:n].tobytes()
    return [raw[i * w: i * w + ln]
            for i, ln in enumerate(lens[:n].astype(np.int64).tolist())]
