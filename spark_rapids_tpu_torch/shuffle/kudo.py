"""Kudo shuffle wire format — byte-compatible with the reference
(format spec: kudo/KudoSerializer.java:48-170 javadoc; writer:
KudoTableHeaderCalc + SlicedBufferSerializer; merge: KudoTableMerger).

Layout of one serialized table partition:

  header:  "KUD0" | rowOffset | numRows | validityLen | offsetLen |
           totalLen | numFlatCols   (all 4-byte big-endian)
           hasValidityBuffer bitset ((numFlatCols+7)/8 bytes, LSB-first,
           depth-first schema order, struct/list before children)
  body:    [validity buffers][offset buffers][data buffers]
           - validity: sloppy byte-slices of the packed null masks starting
             at rowOffset/8 (bit offset rowOffset%8 resolved at merge);
             section padded so header+validity is 4-byte aligned
             (padForValidityAlignment, KudoSerializer.java:497)
           - offsets: raw int32 offset values (NOT rebased), rowCount+1 per
             string/list column with rows
           - data: char/fixed-width payload slices; section padded to 4B

Writes are pure memcpy of host buffers; all bit realignment and offset
rebasing happens in merge_to_table (the read side), matching the
reference's write-cheap/merge-once design.  The writer reads each column
from the device once (prepare_host_columns); the merger builds the
table's columns on the device the caller names, "cuda" by default.

The merger parses its tables under split-and-retry
(robustness/retry.py), as the reference does.  While span tracing is
on, the writer prefixes each table with the KTRX trace extension and
the merge opens a ``kudo_merge`` span linked to every writer context
it consumed; the write and merge counters and the corruption and
resync records go to the observability spine, and a corrupt table
freezes a ``kudo_corrupt`` incident bundle when the flight recorder is
armed.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

import torch

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.shuffle.schema import Field

MAGIC = b"KUD0"
# Optional trace-context header extension: when span tracing is on, the
# writer prefixes a table with "KTRX" + big-endian u64
# trace_id + u64 span_id (20 bytes) so the read side can re-parent its
# merge spans under the writing task's span.  The extension precedes
# the standard "KUD0" header, so the byte-compatible format is
# untouched whenever tracing is off and readers need no look-ahead: the
# next 4 bytes of a stream are always EOF, "KUD0", or "KTRX".
TRACE_MAGIC = b"KTRX"
# Optional integrity trailer: when CRC mode is on, every table is
# FOLLOWED by "KCRC" + big-endian u32 CRC32 of (header bytes + body).
# The stream is byte-compatible when disabled (golden fixtures and the
# native engine see identical bytes); readers verify any trailer they
# encounter regardless of the local write-side setting, so a CRC'd
# stream is checked even by a process that writes without CRC.  The
# KTRX trace extension is NOT covered — corrupting it already fails
# loudly at magic dispatch.
CRC_MAGIC = b"KCRC"
CRC_TRAILER_LEN = 8

_CRC_ENABLED = [os.environ.get("SPARK_RAPIDS_TPU_KUDO_CRC", "")
                not in ("", "0")]


class KudoCorruptException(ValueError):
    """A kudo table failed integrity verification (CRC mismatch or a
    structurally impossible record).  Carries enough to drive a
    re-fetch or a resync: ``reason`` in {'crc', 'magic',
    'truncated'}.  ``deferred=True`` marks a NON-seekable stream's
    late-trailer verification failure: the corrupt table was already
    handed to the caller one read earlier, and the stream itself is
    positioned cleanly at the next record (see read_one_table).

    For SPILL FILES a stream offset alone is
    useless triage — the operator needs to know WHICH file on disk
    went bad and which spill generation wrote it, so re-reads of
    kudo spill files carry ``path`` + ``generation`` (None for wire
    streams, where the link peer/offset is the address)."""

    def __init__(self, msg: str, reason: str = "crc",
                 deferred: bool = False,
                 path: Optional[str] = None,
                 generation: Optional[int] = None):
        if path is not None:
            msg = (f"{msg} [spill file {path}"
                   + (f", generation {generation}"
                      if generation is not None else "") + "]")
        super().__init__(msg)
        self.reason = reason
        self.deferred = deferred
        self.path = path
        self.generation = generation


def annotate_spill_corruption(e: "KudoCorruptException", path: str,
                              generation: Optional[int] = None
                              ) -> "KudoCorruptException":
    """Rebuild a corruption error with the spill-file address (file
    path + spill generation) folded into the message — the read path
    only knows stream offsets; the spill store knows the file."""
    return KudoCorruptException(
        str(e.args[0]) if e.args else "kudo corruption",
        reason=e.reason, deferred=e.deferred, path=path,
        generation=generation)


def set_crc_enabled(enabled: bool) -> bool:
    """Flip CRC-trailer writing for this process; returns the prior
    setting.  Read-side verification is always on when a trailer is
    present."""
    prior = _CRC_ENABLED[0]
    _CRC_ENABLED[0] = bool(enabled)
    return prior


def crc_enabled() -> bool:
    return _CRC_ENABLED[0]


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _pad_validity(n: int, header_size: int) -> int:
    """Pad validity section so header+validity is 4-byte aligned."""
    return _pad4(n + header_size) - header_size


def _stream_read(stream, n: int) -> bytes:
    """stream.read honoring any pushback left by a trailer peek."""
    buf = getattr(stream, "_kudo_pushback", b"")
    if buf:
        take = buf[:n]
        stream._kudo_pushback = buf[n:]
        if len(take) < n:
            take += stream.read(n - len(take))
        return take
    return stream.read(n)


def _stream_unread(stream, data: bytes) -> None:
    """Give peeked bytes back: seek when possible, else stash them on
    the stream object (read_one_table must peek past a table to see
    whether a CRC trailer follows)."""
    if not data:
        return
    try:
        stream.seek(-len(data), 1)
        return
    except (OSError, ValueError, AttributeError):
        pass  # unseekable (or mid-pushback): fall through to the stash
    stream._kudo_pushback = data + getattr(stream, "_kudo_pushback", b"")


def _validity_slice(row_offset: int, num_rows: int) -> Tuple[int, int]:
    """(byte offset, byte length) of the sloppy validity slice."""
    begin_byte = row_offset // 8
    begin_bit = row_offset % 8
    nbytes = (begin_bit + num_rows + 7) // 8 if num_rows > 0 else 0
    return begin_byte, nbytes


@dataclass
class KudoTableHeader:
    offset: int
    num_rows: int
    validity_len: int
    offset_len: int
    total_len: int
    num_columns: int
    has_validity: bytes
    # (trace_id, span_id) carried by a "KTRX" extension, else None;
    # never serialized by `write` (the extension is the writer's
    # concern) so header bytes stay golden
    trace_ctx: Optional[Tuple[int, int]] = None

    @property
    def serialized_size(self) -> int:
        return 4 + 6 * 4 + len(self.has_validity)

    def has_validity_buffer(self, col_idx: int) -> bool:
        return (self.has_validity[col_idx // 8] >> (col_idx % 8)) & 1 != 0

    def to_bytes(self) -> bytes:
        """The exact wire bytes `write` emits — also what the KCRC
        trailer's checksum covers on both sides."""
        return (MAGIC
                + struct.pack(">iiiiii", self.offset, self.num_rows,
                              self.validity_len, self.offset_len,
                              self.total_len, self.num_columns)
                + self.has_validity)

    def write(self, out) -> int:
        out.write(self.to_bytes())
        return self.serialized_size

    @staticmethod
    def read(stream) -> Optional["KudoTableHeader"]:
        magic = _stream_read(stream, 4)
        while magic == CRC_MAGIC:
            # a trailer the previous read could not peek at (non-
            # seekable stream): verify it now against the checksum
            # read_one_table stashed for exactly this moment; without
            # a stash (C stream that refuses attributes) skip it
            raw = _stream_read(stream, 4)
            if len(raw) != 4:
                raise EOFError("truncated kudo crc trailer")
            pending = getattr(stream, "_kudo_pending_crc", None)
            if pending is not None:
                stream._kudo_pending_crc = None
                want = struct.unpack(">I", raw)[0]
                if want != pending:
                    _obs.record_kudo_corruption(
                        "crc", detail=f"deferred: want {want:08x} "
                                      f"got {pending:08x}")
                    _obs.trigger_incident(
                        "kudo_corrupt", reason="crc",
                        detail=f"deferred trailer mismatch want "
                               f"{want:08x} got {pending:08x}")
                    raise KudoCorruptException(
                        f"kudo crc mismatch (want {want:08x} got "
                        f"{pending:08x})", deferred=True)
            magic = _stream_read(stream, 4)
        if len(magic) == 0:
            return None  # clean EOF
        trace_ctx = None
        if magic == TRACE_MAGIC:
            raw = _stream_read(stream, 16)
            if len(raw) != 16:
                raise EOFError("truncated kudo trace extension")
            trace_ctx = struct.unpack(">QQ", raw)
            magic = _stream_read(stream, 4)
            if len(magic) == 0:
                raise EOFError("kudo trace extension without a table")
        if magic != MAGIC:
            raise ValueError(f"bad kudo magic {magic!r}")
        raw = _stream_read(stream, 24)
        if len(raw) != 24:
            raise EOFError("truncated kudo header")
        fields = struct.unpack(">iiiiii", raw)
        off, rows, vlen, olen, tlen, ncols = fields
        if (min(off, rows, vlen, olen, tlen, ncols) < 0
                or vlen + olen > tlen):
            _obs.trigger_incident(
                "kudo_corrupt", reason="magic",
                detail=f"impossible header rows={rows} "
                       f"total_len={tlen} cols={ncols}")
            raise KudoCorruptException(
                f"impossible kudo header (offset={off} rows={rows} "
                f"validity_len={vlen} offset_len={olen} "
                f"total_len={tlen} cols={ncols})", reason="magic")
        nbitset = (fields[5] + 7) // 8
        bitset = _stream_read(stream, nbitset)
        if len(bitset) != nbitset:
            raise EOFError("truncated kudo header bitset")
        return KudoTableHeader(*fields, bitset, trace_ctx)


@dataclass
class KudoTable:
    header: KudoTableHeader
    buffer: bytes  # body, length == header.total_len


# ------------------------------------------------------------------ write


class _Slice:
    __slots__ = ("offset", "row_count")

    def __init__(self, offset: int, row_count: int):
        self.offset = offset
        self.row_count = row_count


class HostColumnView:
    """Host-materialized view of one column (data buffer, packed
    validity, offsets), built ONCE so repeated partition writes don't
    re-sync the device buffers (shuffle_split calls the writer per
    partition): one device-to-host copy per buffer.  The data keeps the
    column's little-endian byte image (FLOAT64 as its IEEE-754 bytes,
    DECIMAL128 as (rows, 4) int32 limbs)."""

    __slots__ = ("dtype", "data", "validity", "offsets", "children")

    def __init__(self, col: Column):
        self.dtype = col.dtype
        self.children = [HostColumnView(ch) for ch in col.children]
        self.offsets = (col.offsets.cpu().numpy()
                        if col.offsets is not None else None)
        if col.validity is not None:
            bits = col.validity.cpu().numpy()
            self.validity = np.packbits(bits != 0, bitorder="little")
        else:
            self.validity = None
        if col.dtype.is_nested:
            self.data = None
        elif col.data is None:
            self.data = np.zeros(0, np.uint8)
        else:
            self.data = col.data.cpu().numpy()


def prepare_host_columns(columns: Sequence[Column]) -> List[HostColumnView]:
    """One-time device->host materialization for repeated kudo writes."""
    return [HostColumnView(c) for c in columns]


def _flat_count(views: Sequence[HostColumnView]) -> int:
    return sum(1 + _flat_count(v.children) for v in views)


def _walk_columns(cols: Sequence[HostColumnView], root: _Slice, visit):
    """Depth-first walk calling visit(view, slice) pre-order; list children
    get the child slice derived from raw offset values."""
    def rec(c: HostColumnView, sl: _Slice):
        visit(c, sl)
        if c.dtype.kind == Kind.LIST:
            if c.offsets is not None and sl.row_count > 0:
                start = int(c.offsets[sl.offset])
                end = int(c.offsets[sl.offset + sl.row_count])
                child = _Slice(start, end - start)
            else:
                child = _Slice(0, 0)
            rec(c.children[0], child)
        elif c.dtype.kind == Kind.STRUCT:
            for ch in c.children:
                rec(ch, sl)
    for c in cols:
        rec(c, root)


def write_to_stream(columns: Sequence[Column], out, row_offset: int,
                    num_rows: int, *,
                    crc: Optional[bool] = None) -> int:
    """Serialize rows [row_offset, row_offset+num_rows) of the columns as
    one kudo table (KudoSerializer.writeToStreamWithMetrics:249).  Returns
    bytes written (header + body).  ``crc`` overrides the process CRC
    setting for THIS table (the spill store forces trailers on so
    spilled bytes are always corruption-checked on read-back, without
    racing the global flag against concurrent shuffle writers)."""
    if num_rows < 0 or row_offset < 0:
        raise ValueError("row_offset/num_rows must be non-negative")
    ntrace = _write_trace_extension(out)
    views = list(columns)
    if views and isinstance(views[0], Column):
        views = prepare_host_columns(views)
    root = _Slice(row_offset, num_rows)
    nflat = _flat_count(views)
    bitset = bytearray((nflat + 7) // 8)

    validity_parts: List[bytes] = []
    offset_parts: List[bytes] = []
    data_parts: List[bytes] = []
    col_idx = [0]

    def visit(c: HostColumnView, sl: _Slice):
        i = col_idx[0]
        col_idx[0] += 1
        include_validity = c.validity is not None and sl.row_count > 0
        if include_validity:
            bitset[i // 8] |= 1 << (i % 8)
            bo, bl = _validity_slice(sl.offset, sl.row_count)
            sliced = c.validity[bo:bo + bl]
            if len(sliced) < bl:  # packed mask may be short; zero-extend
                sliced = np.concatenate(
                    [sliced, np.zeros(bl - len(sliced), np.uint8)])
            validity_parts.append(sliced.tobytes())
        kind = c.dtype.kind
        if kind in (Kind.STRING, Kind.LIST):
            if c.offsets is not None and sl.row_count > 0:
                offset_parts.append(
                    c.offsets[sl.offset: sl.offset + sl.row_count + 1]
                    .astype("<i4").tobytes())
                if kind == Kind.STRING:
                    start = int(c.offsets[sl.offset])
                    end = int(c.offsets[sl.offset + sl.row_count])
                    if end > start:
                        data_parts.append(c.data[start:end].tobytes())
        elif kind == Kind.STRUCT:
            pass
        else:  # fixed width (incl. decimal128 as (rows, 4) LE limbs)
            if sl.row_count > 0:
                data_parts.append(
                    c.data[sl.offset: sl.offset + sl.row_count].tobytes())

    _walk_columns(views, root, visit)

    validity = b"".join(validity_parts)
    offsets_b = b"".join(offset_parts)
    data_b = b"".join(data_parts)
    header_size = 4 + 24 + len(bitset)
    vlen = _pad_validity(len(validity), header_size)
    olen = _pad4(len(offsets_b))
    dlen = _pad4(len(data_b))
    header = KudoTableHeader(row_offset, num_rows, vlen, olen,
                             vlen + olen + dlen, nflat, bytes(bitset))
    hb = header.to_bytes()
    body = (validity, b"\0" * (vlen - len(validity)),
            offsets_b, b"\0" * (olen - len(offsets_b)),
            data_b, b"\0" * (dlen - len(data_b)))
    out.write(hb)
    for part in body:
        out.write(part)
    n = ntrace + header.serialized_size + header.total_len
    return n + _write_crc_trailer(out, hb, body, crc=crc)


def _write_crc_trailer(out, header_bytes: bytes, body_parts, *,
                       crc: Optional[bool] = None) -> int:
    """Append the KCRC trailer when CRC mode is on; returns the bytes
    written (0 when off — the stream stays reference
    byte-compatible).  ``crc`` overrides the process flag per table."""
    if not (_CRC_ENABLED[0] if crc is None else crc):
        return 0
    crc = zlib.crc32(header_bytes)
    for part in body_parts:
        crc = zlib.crc32(part, crc)
    out.write(CRC_MAGIC + struct.pack(">I", crc & 0xFFFFFFFF))
    return CRC_TRAILER_LEN


def crc_trailer(table_bytes) -> bytes:
    """The KCRC trailer over one table's wire bytes (header + body),
    given as any bytes-like object."""
    return CRC_MAGIC + struct.pack(">I", zlib.crc32(table_bytes) & 0xFFFFFFFF)


def checked_table_length(blob) -> int:
    """The byte length of the table in ``blob`` (any bytes-like object)
    when ``blob`` is exactly one kudo table and a KCRC trailer whose
    checksum matches, read in place; 0 otherwise (read_tables then
    parses it and raises what it finds)."""
    mv = memoryview(blob)
    if len(mv) < 28 + CRC_TRAILER_LEN or bytes(mv[:4]) != MAGIC:
        return 0
    total, ncols = struct.unpack(">ii", mv[20:28])
    n = 28 + (ncols + 7) // 8 + total
    if (min(total, ncols) < 0 or n + CRC_TRAILER_LEN != len(mv)
            or bytes(mv[n:]) != crc_trailer(mv[:n])):
        return 0
    return n


def _write_trace_extension(out) -> int:
    """Prefix the next table with the active trace context when span
    tracing is on (see TRACE_MAGIC).  Returns bytes written (0 when
    tracing is off or no span is open — the stream stays reference
    byte-compatible)."""
    tracer = _obs.TRACER
    if not tracer.enabled:
        return 0
    ctx = tracer.current_context()
    if ctx is None:
        return 0
    out.write(TRACE_MAGIC)
    out.write(struct.pack(">QQ", ctx.trace_id, ctx.span_id))
    return 20


def write_row_count_only(out, num_rows: int) -> int:
    """Degenerate zero-column table (KudoSerializer rows-only path)."""
    ntrace = _write_trace_extension(out)
    header = KudoTableHeader(0, num_rows, 0, 0, 0, 0, b"")
    hb = header.to_bytes()
    out.write(hb)
    return ntrace + header.serialized_size + _write_crc_trailer(
        out, hb, ())


def read_one_table(stream) -> Optional[KudoTable]:
    """Read one table; when a KCRC trailer follows it is consumed and
    VERIFIED (a mismatch raises :class:`KudoCorruptException`) —
    regardless of the local write-side CRC setting.  On a
    NON-seekable stream (a live socket/pipe) the trailer peek is
    skipped so an incremental reader never blocks waiting for bytes
    past the table; verification is DEFERRED instead — the table's
    checksum is stashed on the stream and checked when the next
    header read encounters the trailer (a C stream that refuses
    attribute stashes skips verification)."""
    header = KudoTableHeader.read(stream)
    if header is None:
        return None
    body = _stream_read(stream, header.total_len)
    if len(body) != header.total_len:
        raise EOFError("truncated kudo body")
    seekable = getattr(stream, "seekable", None)
    if seekable is not None and not seekable():
        try:
            stream._kudo_pending_crc = zlib.crc32(
                body, zlib.crc32(header.to_bytes())) & 0xFFFFFFFF
        except AttributeError:
            pass
        return KudoTable(header, body)
    peek = _stream_read(stream, 4)
    if peek == CRC_MAGIC:
        raw = _stream_read(stream, 4)
        if len(raw) != 4:
            raise EOFError("truncated kudo crc trailer")
        want = struct.unpack(">I", raw)[0]
        got = zlib.crc32(body, zlib.crc32(header.to_bytes())) \
            & 0xFFFFFFFF
        if got != want:
            _obs.record_kudo_corruption(
                "crc", detail=f"want {want:08x} got {got:08x} "
                              f"rows={header.num_rows}")
            _obs.trigger_incident(
                "kudo_corrupt", reason="crc",
                detail=f"trailer mismatch want {want:08x} got "
                       f"{got:08x} rows={header.num_rows}")
            raise KudoCorruptException(
                f"kudo crc mismatch (want {want:08x} got {got:08x})")
    else:
        _stream_unread(stream, peek)
    return KudoTable(header, body)


def stream_has_crc_trailers(blob: bytes) -> bool:
    """Structured scan of a concatenated table stream: walk records by
    their header lengths and report whether any KCRC trailer is
    present.  Payload bytes are never pattern-matched, so a payload
    that happens to contain b"KCRC" cannot false-positive (the shim
    uses this to decide whether the trailer-unaware native engine may
    parse the blob).  An unparseable structure returns False — the
    real reader will raise its precise error."""
    pos, n = 0, len(blob)
    while pos + 4 <= n:
        magic = blob[pos:pos + 4]
        if magic == CRC_MAGIC:
            return True
        if magic == TRACE_MAGIC:
            pos += 20
            continue
        if magic != MAGIC or pos + 28 > n:
            return False
        tlen = int.from_bytes(blob[pos + 20:pos + 24], "big",
                              signed=True)
        ncols = int.from_bytes(blob[pos + 24:pos + 28], "big",
                               signed=True)
        if tlen < 0 or ncols < 0:
            return False
        pos += 28 + (ncols + 7) // 8 + tlen
    return False


def _is_seekable(stream) -> bool:
    """Mirror read_one_table's convention: a stream without a
    ``seekable`` method is treated as seekable (plain BytesIO-likes)."""
    probe = getattr(stream, "seekable", None)
    return True if probe is None else bool(probe())


def resync_to_magic(stream, chunk_size: int = 1 << 16) -> int:
    """Scan forward to the next table magic ("KUD0"/"KTRX"), leaving
    the stream positioned AT it; returns the bytes skipped.  At EOF
    the stream is left there (the caller's next read sees a clean
    EOF).  On a seekable stream the scan rewinds with ``seek``; on a
    NON-seekable one (a live socket) the unconsumed tail is given back
    through the pushback stash, so resync works mid-stream without
    random access.  Chunked bytes.find scan (a 3-byte carry covers
    magics straddling chunk edges) — a multi-MB corrupt partition
    resyncs at memchr speed, not per-byte Python."""
    can_seek = _is_seekable(stream)
    carry = b""
    consumed = 0          # bytes read from the stream by this scan
    while True:
        chunk = _stream_read(stream, chunk_size)
        if not chunk:
            return consumed
        buf = carry + chunk
        consumed += len(chunk)
        hits = [p for p in (buf.find(MAGIC), buf.find(TRACE_MAGIC))
                if p >= 0]
        if hits:
            pos = min(hits)
            back = len(buf) - pos
            if can_seek:
                stream.seek(-back, 1)
            else:
                _stream_unread(stream, buf[pos:])
            return consumed - back
        carry = buf[-3:]


def read_tables(stream, *, resync: bool = False) -> List[KudoTable]:
    """Read every table in a stream.  With ``resync=False`` any
    detected corruption raises: CRC mismatch, bad magic, truncation,
    or a structurally impossible header — without CRC those
    magic/length/structure checks are the loud-failure floor, while
    payload bit-flips (the silent kind) need the CRC trailer.  With
    ``resync=True`` the reader skips to the next table magic after a
    corrupt record and keeps going — the multi-table salvage mode for
    streams whose remaining tables are still good.  Resync works on
    seekable streams (rewind + scan) AND on non-seekable socket
    streams: there a deferred late-trailer CRC failure drops the
    PREVIOUS table (the one the stashed checksum covered — the stream
    itself already sits cleanly at the next record), and a bad-magic
    failure scans forward through the pushback stash."""
    tables: List[KudoTable] = []
    can_seek = _is_seekable(stream)
    while True:
        start = stream.tell() if (resync and can_seek) else None
        try:
            kt = read_one_table(stream)
        except (ValueError, EOFError) as e:
            if not resync:
                raise
            if isinstance(e, KudoCorruptException):
                reason = e.reason
            elif isinstance(e, EOFError):
                reason = "truncated"
            else:
                reason = "magic"
            if getattr(e, "deferred", False):
                # non-seekable late-trailer verification: the corrupt
                # table is the LAST one handed back (its trailer
                # immediately follows it on the wire); drop it — the
                # stream needs no repositioning
                skipped = 0
                if tables:
                    bad = tables.pop()
                    skipped = (bad.header.serialized_size
                               + bad.header.total_len + CRC_TRAILER_LEN
                               + (20 if bad.header.trace_ctx is not None
                                  else 0))
                _obs.record_kudo_corruption(
                    "resync", skipped_bytes=skipped,
                    detail=f"{reason}(deferred): {e}")
                continue
            if not can_seek:
                if isinstance(e, EOFError):
                    # mid-record EOF on a live stream: nothing past it
                    # to salvage — return what survived
                    _obs.record_kudo_corruption(
                        "resync", skipped_bytes=0,
                        detail=f"{reason}: {e}")
                    return tables
                skipped = resync_to_magic(stream)
                _obs.record_kudo_corruption(
                    "resync", skipped_bytes=skipped,
                    detail=f"{reason}: {e}")
                continue
            if reason == "crc" and stream.tell() > start:
                # the record's full extent is known (header, body, and
                # trailer were all consumed before the mismatch):
                # resume AFTER it — rescanning the corrupt body could
                # resurrect a phantom table from payload bytes that
                # merely look like a kudo record
                skipped = stream.tell() - start
            else:
                # rewind to one past the failed record's start and
                # scan; progress is monotonic, so a corrupt tail
                # terminates at EOF instead of looping
                stream.seek(start + 1)
                skipped = 1 + resync_to_magic(stream)
            # one "resync" record per skip (the crc mismatch itself
            # was already counted at the verify site)
            _obs.record_kudo_corruption("resync", skipped_bytes=skipped,
                                        detail=f"{reason}: {e}")
            continue
        if kt is None:
            return tables
        tables.append(kt)


# ------------------------------------------------------------------ merge


class _HostCol:
    __slots__ = ("dtype", "rows", "mask", "data", "offsets", "children")

    def __init__(self, dtype, rows, mask=None, data=None, offsets=None,
                 children=()):
        self.dtype = dtype
        self.rows = rows
        self.mask = mask          # np bool array or None (all valid)
        self.data = data          # np array (values / chars / limb bytes)
        self.offsets = offsets    # np int32, rebased to 0
        self.children = list(children)


def _parse_table(kt: KudoTable, fields: Sequence[Field]) -> List[_HostCol]:
    """Decode one kudo body into logical host columns (bit offsets and raw
    offsets resolved here, as KudoTableMerger does)."""
    h = kt.header
    body = kt.buffer
    vcur = [0]
    ocur = [h.validity_len]
    dcur = [h.validity_len + h.offset_len]
    col_idx = [0]

    def read_validity(sl: _Slice) -> Optional[np.ndarray]:
        i = col_idx[0]
        has = h.has_validity_buffer(i)
        if not has or sl.row_count <= 0:
            return None
        begin_bit = sl.offset % 8
        nbytes = (begin_bit + sl.row_count + 7) // 8
        raw = np.frombuffer(body, np.uint8, nbytes, vcur[0])
        vcur[0] += nbytes
        bits = np.unpackbits(raw, bitorder="little")
        return bits[begin_bit: begin_bit + sl.row_count].astype(bool)

    def rec(f: Field, sl: _Slice) -> _HostCol:
        mask = read_validity(sl)
        col_idx[0] += 1
        kind = f.dtype.kind
        if kind in (Kind.STRING, Kind.LIST):
            if sl.row_count > 0:
                n = sl.row_count + 1
                raw = np.frombuffer(body, "<i4", n, ocur[0]).copy()
                ocur[0] += 4 * n
                child_sl = _Slice(int(raw[0]), int(raw[-1] - raw[0]))
                offsets = raw - raw[0]
            else:
                child_sl = _Slice(0, 0)
                offsets = np.zeros(1, np.int32)
            if kind == Kind.STRING:
                nchars = child_sl.row_count
                data = np.frombuffer(body, np.uint8, nchars, dcur[0]).copy()
                dcur[0] += nchars
                return _HostCol(f.dtype, sl.row_count, mask, data, offsets)
            child = rec(f.children[0], child_sl)
            return _HostCol(f.dtype, sl.row_count, mask, None, offsets,
                            [child])
        if kind == Kind.STRUCT:
            children = [rec(ch, sl) for ch in f.children]
            return _HostCol(f.dtype, sl.row_count, mask, None, None,
                            children)
        # fixed width
        item = 16 if kind == Kind.DECIMAL128 else f.dtype.size_bytes
        nbytes = sl.row_count * item
        raw = body[dcur[0]: dcur[0] + nbytes]
        dcur[0] += nbytes
        if kind == Kind.DECIMAL128:
            data = np.frombuffer(raw, "<i4").reshape(sl.row_count, 4).copy()
        else:
            data = np.frombuffer(raw, f.dtype.np_dtype).copy()
        return _HostCol(f.dtype, sl.row_count, mask, data, None)

    root = _Slice(h.offset, h.num_rows)
    return [rec(f, root) for f in fields]


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _merge_offsets(parts: List[_HostCol]) -> np.ndarray:
    """The parts' zero-based offsets, each rebased past the last."""
    offs = [np.zeros(1, np.int32)]
    base = 0
    for p in parts:
        offs.append((p.offsets[1:] + base).astype(np.int32))
        base += int(p.offsets[-1])
    return np.concatenate(offs)


def _concat_host_cols(parts: List[_HostCol], f: Field, device) -> Column:
    """One column of the parsed parts' rows, built on `device` (one
    host-to-device copy per buffer)."""
    rows = sum(p.rows for p in parts)
    validity = None
    if any(p.mask is not None for p in parts):
        validity = _to_device(np.concatenate([
            p.mask if p.mask is not None else np.ones(p.rows, bool)
            for p in parts]).astype(np.uint8), device)
    kind = f.dtype.kind
    if kind == Kind.STRING:
        data = (np.concatenate([p.data for p in parts]) if parts
                else np.zeros(0, np.uint8))
        return Column(f.dtype, rows, data=_to_device(data, device),
                      validity=validity,
                      offsets=_to_device(_merge_offsets(parts), device))
    if kind == Kind.LIST:
        child = _concat_host_cols([p.children[0] for p in parts],
                                  f.children[0], device)
        return Column(f.dtype, rows, validity=validity,
                      offsets=_to_device(_merge_offsets(parts), device),
                      children=(child,))
    if kind == Kind.STRUCT:
        children = tuple(
            _concat_host_cols([p.children[i] for p in parts], ch, device)
            for i, ch in enumerate(f.children))
        return Column(f.dtype, rows, validity=validity, children=children)
    if parts:
        data = np.concatenate([p.data for p in parts])
    elif kind == Kind.DECIMAL128:
        data = np.zeros((0, 4), np.int32)
    else:
        data = np.zeros(0, f.dtype.np_dtype)
    return Column(f.dtype, rows, data=_to_device(data, device),
                  validity=validity)


def merge_to_table(kudo_tables: Sequence[KudoTable],
                   fields: Sequence[Field], device="cuda") -> Table:
    """Concatenate N kudo tables into one Table on `device`
    (KudoSerializer.mergeToTable:407 / KudoTableMerger)."""
    table, _ = merge_to_table_with_metrics(kudo_tables, fields, device)
    return table


# ------------------------------------------------------- metrics & dump


@dataclass
class WriteMetrics:
    """KudoSerializer WriteMetrics analog: bytes written + copy time."""
    written_bytes: int = 0
    copy_time_ns: int = 0


@dataclass
class MergeMetrics:
    """KudoTableMerger MergeMetrics analog."""
    parse_time_ns: int = 0
    concat_time_ns: int = 0
    total_rows: int = 0


def write_to_stream_with_metrics(columns, out, row_offset: int,
                                 num_rows: int) -> "WriteMetrics":
    """writeToStreamWithMetrics (KudoSerializer.java:249).  Opens a
    shuffle_write span; its context is what the trace extension embeds
    in the wire bytes, so the read side links back to THIS write."""
    with _obs.TRACER.span("kudo_write", kind="shuffle_write",
                          attrs={"rows": num_rows}) as sp:
        t0 = time.monotonic_ns()
        n = write_to_stream(columns, out, row_offset, num_rows)
        dur = time.monotonic_ns() - t0
        sp.set_attr("bytes", n)
    # fold into the process metrics spine (shuffle byte counters +
    # per-task attribution + journal event); no-op when disabled
    _obs.record_shuffle_write(n, dur, num_rows)
    return WriteMetrics(written_bytes=n, copy_time_ns=dur)


def merge_to_table_with_metrics(kudo_tables, fields, device="cuda"):
    """merge_to_table with the parse and concat times.  The concat time
    ends when the last host-to-device copy is queued, not when it
    lands."""
    from spark_rapids_tpu_torch.robustness import retry as _retry
    span = _open_merge_span(kudo_tables)
    try:
        t0 = time.monotonic_ns()
        # split-and-retry over the TABLE LIST: a GpuSplitAndRetryOOM
        # mid-parse halves the batch and parses the halves (down to a
        # one-table floor); per-half results flatten back in order, so
        # the split merge is byte-identical to the unsplit one
        parsed = _retry.split_and_retry(
            lambda kts: [_parse_table(kt, fields) for kt in kts],
            list(kudo_tables),
            combine=lambda chunks: [p for chunk in chunks
                                    for p in chunk],
            name="kudo_merge")
        t1 = time.monotonic_ns()
        cols = [_concat_host_cols([p[i] for p in parsed], f, device)
                for i, f in enumerate(fields)]
        t2 = time.monotonic_ns()
        table = Table(cols)
        span.set_attr("rows", table.num_rows)
    finally:
        span.end()
    _obs.record_shuffle_merge(table.num_rows, t1 - t0, t2 - t1,
                              len(kudo_tables))
    return table, MergeMetrics(parse_time_ns=t1 - t0,
                               concat_time_ns=t2 - t1,
                               total_rows=table.num_rows)


def _open_merge_span(kudo_tables):
    """Open the shuffle_merge span with writer-side causality: every
    distinct trace context carried by the incoming tables' "KTRX"
    extensions becomes a span link, and when the merging thread has no
    open span of its own (a remote reader), the span is RE-PARENTED
    under the first writer's context so the read side joins the writing
    task's trace instead of starting an orphan one."""
    tracer = _obs.TRACER
    if not tracer.enabled:
        return _obs.NOOP_SPAN
    ctxs = []
    seen = set()
    for kt in kudo_tables:
        ctx = kt.header.trace_ctx
        if ctx is not None and ctx not in seen:
            seen.add(ctx)
            ctxs.append(_obs.SpanContext(*ctx))
    parent = None
    if ctxs and tracer.current_context() is None:
        parent = ctxs[0]
    span = tracer.start_span("kudo_merge", kind="shuffle_merge",
                             attrs={"tables": len(kudo_tables)},
                             parent=parent)
    for c in ctxs:
        span.add_link(c)
    return span


def dump_tables(kudo_tables, path_prefix: str) -> List[str]:
    """Debug dump of shuffle blocks to files (kudo/DumpOption.java /
    WriteInput dump support): one file per kudo table, header+body."""
    paths = []
    for i, kt in enumerate(kudo_tables):
        p = f"{path_prefix}{i:05d}.kudo"
        with open(p, "wb") as f:
            kt.header.write(f)
            f.write(kt.buffer)
        paths.append(p)
    return paths
