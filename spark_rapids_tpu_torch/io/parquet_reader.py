"""Columnar Parquet reader: pruned footer -> row-group walk -> page
decode -> device columns (reference: NativeParquetJni's L3 Parquet
kernels + ParquetFooter.readAndFilter; the storage half between object
storage and the TPC-DS pipelines).

Shape of the path:

  * the footer is parsed and PRUNED with ``parquet_footer`` — the
    projection pushdown IS the footer pruner, so the row groups walked
    below only contain the requested column chunks;
  * every column chunk is a range fetch on ONE opened
    ``fileio.RangeReader`` stream (no whole-file slurp, no per-chunk
    reopen);
  * pages decode on the host through ``page_decode`` (PLAIN,
    PLAIN_DICTIONARY / RLE_DICTIONARY, RLE/bit-packed definition
    levels) with per-run vectorized numpy — dictionary data pages are
    one index decode plus one take;
  * each assembled column then crosses to ``device`` once, one copy per
    buffer, in the port's column layout (``columns/column.py``):
    unpacked uint8 validity (None when every row is valid), uint8
    string chars + int32 offsets, FLOAT64 as native float64.

Supported: flat schemas (nullable everything) over BOOLEAN / INT32
(incl. date32, int8/16, decimal32) / INT64 (incl. timestamp-micros,
decimal64) / FLOAT / DOUBLE / BYTE_ARRAY (utf8 strings), v1 and v2
data pages, UNCOMPRESSED natively plus any codec pyarrow ships
(snappy/zstd/gzip/...).  Everything else raises the typed
``ParquetDecodeException`` / ``ParquetFooterException`` — which the
retry drivers treat as non-retryable.

A caller that passes ``stats=`` (a dict) to :func:`read_table` gets that
read's counts in it: bytes fetched, pages, rows, and the host decode
(decompression included and also timed alone) and the upload to the
device timed apart.  The dict is the caller's, so concurrent reads
never see each other's counts.
"""

from __future__ import annotations

import os
import struct
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.io import page_decode as pd
from spark_rapids_tpu_torch.io import parquet_footer as pf
from spark_rapids_tpu_torch.io.fileio import RangeReader, RapidsFileIO
from spark_rapids_tpu_torch.io.page_decode import ParquetDecodeException

# page types (parquet.thrift PageType)
_PAGE_DATA = 0
_PAGE_INDEX = 1
_PAGE_DICTIONARY = 2
_PAGE_DATA_V2 = 3

# codecs (parquet.thrift CompressionCodec) -> pyarrow codec names
_CODECS = {0: None, 1: "snappy", 2: "gzip", 4: "brotli", 5: "lz4",
           6: "zstd", 7: "lz4_raw"}

# legacy ConvertedType ids the dtype mapping consumes
_CT_UTF8 = 0
_CT_DECIMAL = 5
_CT_DATE = 6
_CT_TIMESTAMP_MILLIS = 9
_CT_TIMESTAMP_MICROS = 10
_CT_INT_8, _CT_INT_16 = 15, 16
_CT_UINT_8, _CT_UINT_16, _CT_UINT_32, _CT_UINT_64 = 11, 12, 13, 14


def _sval(sv, fid, default=None):
    return pf._sval(sv, fid, default)


def _parse_struct_at(buf: bytes, pos: int):
    """Parse one thrift-compact struct (page headers share the footer
    protocol) starting at ``pos``; returns (tree, next position)."""
    r = pf._Reader(buf)
    r.pos = pos
    try:
        tree = r.read_struct()
    except (IndexError, struct.error, ValueError, OverflowError,
            MemoryError) as e:
        raise ParquetDecodeException(
            f"truncated or corrupt page header at offset {pos}: "
            f"{e}") from e
    return tree, r.pos


def _decompress(data: bytes, codec: int, uncompressed_size: int) -> bytes:
    if codec == 0:
        return data
    name = _CODECS.get(codec)
    if name is None:
        raise ParquetDecodeException(f"unsupported codec id {codec}")
    try:
        import pyarrow as pa
        c = pa.Codec(name)
    except Exception as e:
        raise ParquetDecodeException(
            f"codec {name!r} unavailable on this image: {e}") from e
    try:
        out = c.decompress(data, uncompressed_size, asbytes=True)
    except Exception as e:
        raise ParquetDecodeException(
            f"{name} decompression failed: {e}") from e
    if len(out) != uncompressed_size:
        raise ParquetDecodeException(
            f"{name} page inflated to {len(out)} bytes, header "
            f"promised {uncompressed_size}")
    return out


# -------------------------------------------------------- dtype mapping


def _logical_field(leaf: pf.SchemaLeaf, fid: int):
    return _sval(leaf.logical, fid) if leaf.logical is not None else None


def _dtype_for_leaf(leaf: pf.SchemaLeaf) -> DType:
    """Column dtype for a flat leaf: physical type refined by the
    legacy ConvertedType (pyarrow still writes it for compat) with a
    LogicalType fallback."""
    phys, ct = leaf.physical_type, leaf.converted_type
    if phys == pf.PHYS_BOOLEAN:
        return dtypes.BOOL8
    if phys == pf.PHYS_INT32:
        if ct == _CT_DATE or _logical_field(leaf, 6) is not None:
            return dtypes.TIMESTAMP_DAYS
        if ct == _CT_DECIMAL:
            return dtypes.decimal32(-leaf.scale)
        if ct == _CT_INT_8:
            return dtypes.INT8
        if ct == _CT_INT_16:
            return dtypes.INT16
        if ct == _CT_UINT_8:
            return dtypes.UINT8
        if ct == _CT_UINT_16:
            return dtypes.UINT16
        if ct == _CT_UINT_32:
            return dtypes.UINT32
        return dtypes.INT32
    if phys == pf.PHYS_INT64:
        unit = _timestamp_unit(leaf)
        if ct == _CT_TIMESTAMP_MICROS or unit == "us":
            return dtypes.TIMESTAMP_MICROS
        if ct == _CT_TIMESTAMP_MILLIS or unit == "other":
            # silently returning raw millis/nanos as INT64 would be
            # off by 1000x against every TIMESTAMP_MICROS column —
            # refuse typed like the Arrow door does
            raise ParquetDecodeException(
                f"column {leaf.name!r}: only timestamp[us] is "
                f"supported (Spark timestamps are micros)")
        if ct == _CT_DECIMAL:
            return dtypes.decimal64(-leaf.scale)
        if ct == _CT_UINT_64:
            return dtypes.UINT64
        return dtypes.INT64
    if phys == pf.PHYS_FLOAT:
        return dtypes.FLOAT32
    if phys == pf.PHYS_DOUBLE:
        return dtypes.FLOAT64
    if phys == pf.PHYS_BYTE_ARRAY:
        return dtypes.STRING
    raise ParquetDecodeException(
        f"column {leaf.name!r}: physical type "
        f"{pf.PHYSICAL_TYPE_NAMES.get(phys, phys)} unsupported")


def _timestamp_unit(leaf: pf.SchemaLeaf) -> Optional[str]:
    """'us' for a micros LogicalType.TIMESTAMP, 'other' for any other
    unit (millis/nanos), None when the leaf has no timestamp logical
    type."""
    ts = _logical_field(leaf, 8)          # LogicalType.TIMESTAMP
    if ts is None:
        return None
    unit = _sval(ts, 2)                   # TimestampType.unit
    if unit is not None and _sval(unit, 2) is not None:  # MICROS
        return "us"
    return "other"


# ----------------------------------------------------- chunk metadata


class _ChunkMeta:
    __slots__ = ("codec", "num_values", "start", "nbytes", "path",
                 "decompress_ns")

    def __init__(self, cc, leaf_name: str, file_size: int):
        md = _sval(cc, 3)
        if md is None:
            raise ParquetDecodeException(
                f"column chunk of {leaf_name!r} has no metadata")
        try:
            self.codec = int(_sval(md, 4, 0))
            self.num_values = int(_sval(md, 5, 0))
            data_off = _sval(md, 9)
            dict_off = _sval(md, 11)
            if data_off is None:
                raise ParquetDecodeException(
                    f"column chunk of {leaf_name!r} has no data "
                    f"offset")
            self.start = int(data_off if dict_off is None
                             else min(data_off, dict_off))
            self.nbytes = int(_sval(md, 7, 0))
        except TypeError as e:
            # corrupt-but-parseable metadata: fields holding the
            # wrong thrift shapes must fail typed, not as TypeError
            raise ParquetDecodeException(
                f"malformed chunk metadata of {leaf_name!r}: "
                f"{e}") from e
        # bounds-check against the file BEFORE any fetch: corrupt
        # offsets must fail typed, not as fileio range/EOF errors
        if self.num_values < 0 or self.nbytes < 0 or self.start < 0 \
                or self.start + self.nbytes > file_size:
            raise ParquetDecodeException(
                f"column chunk of {leaf_name!r} lies outside the "
                f"file: [{self.start}, {self.start + self.nbytes}) "
                f"of {file_size} bytes")
        self.path = leaf_name
        self.decompress_ns = 0


def _inflate(data, meta: _ChunkMeta, uncompressed_size: int) -> bytes:
    """:func:`_decompress` of one page of ``meta``'s chunk, timed into
    ``meta.decompress_ns``."""
    if meta.codec == 0:
        return data
    t0 = time.perf_counter_ns()
    out = _decompress(data, meta.codec, uncompressed_size)
    meta.decompress_ns += time.perf_counter_ns() - t0
    return out


# ------------------------------------------------------- chunk decode


def _decode_chunk(buf: bytes, leaf: pf.SchemaLeaf, meta: _ChunkMeta):
    """Decode one column chunk's pages.  Returns
    (fixed_vals | (chars, lens), mask or None, pages_decoded) where
    vals/lens carry only the NON-NULL values in row order and mask is
    the per-row validity (None == all valid)."""
    is_str = leaf.physical_type == pf.PHYS_BYTE_ARRAY
    pos, end = 0, len(buf)
    dictionary: Optional[pd.Dictionary] = None
    fixed_parts: List[np.ndarray] = []
    chars_parts: List[np.ndarray] = []
    lens_parts: List[np.ndarray] = []
    mask_parts: List[Tuple[int, Optional[np.ndarray]]] = []
    seen = 0
    pages = 0
    while seen < meta.num_values:
        if pos >= end:
            raise ParquetDecodeException(
                f"column chunk of {meta.path!r} truncated: "
                f"{seen}/{meta.num_values} values decoded")
        header, pos = _parse_struct_at(buf, pos)
        ptype = int(_sval(header, 1, -1))
        usize = int(_sval(header, 2, 0))
        csize = int(_sval(header, 3, 0))
        if csize < 0 or pos + csize > end:
            raise ParquetDecodeException(
                f"page body of {meta.path!r} overruns chunk "
                f"({csize} bytes at {pos}, chunk ends {end})")
        # memoryview slice: free, and uncompressed pages decode in
        # place (frombuffer/unpack_from/Codec all take buffer views)
        raw = memoryview(buf)[pos:pos + csize]
        pos += csize
        pages += 1
        if ptype == _PAGE_DICTIONARY:
            dph = _sval(header, 7)
            nvals = int(_sval(dph, 1, 0))
            dictionary = pd.decode_dictionary_page(
                _inflate(raw, meta, usize),
                leaf.physical_type, nvals)
            continue
        if ptype == _PAGE_INDEX:
            continue
        if ptype == _PAGE_DATA:
            vals, mask, nvals = _decode_data_page_v1(
                raw, header, leaf, meta, dictionary)
        elif ptype == _PAGE_DATA_V2:
            vals, mask, nvals = _decode_data_page_v2(
                raw, header, leaf, meta, dictionary)
        else:
            raise ParquetDecodeException(
                f"unknown page type {ptype} in {meta.path!r}")
        if is_str:
            chars_parts.append(vals[0])
            lens_parts.append(vals[1])
        else:
            fixed_parts.append(vals)
        mask_parts.append((nvals, mask))
        seen += nvals
    if seen != meta.num_values:
        raise ParquetDecodeException(
            f"column chunk of {meta.path!r} decoded {seen} values, "
            f"metadata promised {meta.num_values}")
    mask = _merge_masks(mask_parts, seen)
    if is_str:
        chars = (np.concatenate(chars_parts) if chars_parts
                 else np.empty(0, np.uint8))
        lens = (np.concatenate(lens_parts) if lens_parts
                else np.empty(0, np.int32))
        return (chars, lens), mask, pages
    vals = (np.concatenate(fixed_parts) if fixed_parts
            else np.empty(0, np.uint8 if
                          leaf.physical_type == pf.PHYS_BOOLEAN
                          else pd._PLAIN_NP[leaf.physical_type]))
    return vals, mask, pages


def _stitch_masks(pairs, total: int) -> np.ndarray:
    """(count, mask-or-None) segments -> one bool mask (None segments
    are all-valid) — the one stitching loop shared by the page-level
    and row-group-level merges."""
    out = np.empty(total, np.bool_)
    at = 0
    for n, m in pairs:
        out[at:at + n] = True if m is None else m
        at += n
    return out


def _merge_masks(parts: List[Tuple[int, Optional[np.ndarray]]],
                 total: int) -> Optional[np.ndarray]:
    if all(m is None for _, m in parts):
        return None
    return _stitch_masks(parts, total)


def _decode_values(data: bytes, dpos: int, leaf: pf.SchemaLeaf,
                   meta: _ChunkMeta, dictionary, encoding: int,
                   nvalid: int):
    """Value section of a data page -> non-null values (np array for
    fixed width, (chars, lens) for strings)."""
    if encoding in (pd.ENC_RLE_DICTIONARY, pd.ENC_PLAIN_DICTIONARY):
        if dictionary is None:
            raise ParquetDecodeException(
                f"{meta.path!r}: dictionary-encoded data page before "
                f"any dictionary page")
        idx = pd.decode_dictionary_indices(data, dpos, len(data),
                                           nvalid)
        return pd.dictionary_take(dictionary, idx)
    if (encoding == pd.ENC_RLE
            and leaf.physical_type == pf.PHYS_BOOLEAN):
        # v2 booleans: RLE-of-bit-width-1 with a 4-byte length prefix
        if dpos + 4 > len(data):
            raise ParquetDecodeException(
                f"{meta.path!r}: truncated RLE boolean block")
        nbytes = int.from_bytes(data[dpos:dpos + 4], "little")
        vals, _ = pd.decode_hybrid(data, dpos + 4,
                                   min(dpos + 4 + nbytes, len(data)),
                                   1, nvalid)
        return vals.astype(np.uint8)
    if encoding != pd.ENC_PLAIN:
        raise ParquetDecodeException(
            f"{meta.path!r}: value encoding {encoding} unsupported "
            f"(PLAIN, RLE booleans, and RLE_DICTIONARY only)")
    if leaf.physical_type == pf.PHYS_BYTE_ARRAY:
        chars, lens, _ = pd.decode_plain_byte_array(
            data, dpos, len(data), nvalid)
        return chars, lens
    vals, _ = pd.decode_plain_fixed(data, dpos, len(data),
                                    leaf.physical_type, nvalid)
    return vals


def _decode_data_page_v1(raw: bytes, header, leaf: pf.SchemaLeaf,
                         meta: _ChunkMeta, dictionary):
    dph = _sval(header, 5)
    if dph is None:
        raise ParquetDecodeException(
            f"data page of {meta.path!r} missing its header")
    nvals = int(_sval(dph, 1, 0))
    encoding = int(_sval(dph, 2, 0))
    dl_enc = int(_sval(dph, 3, pd.ENC_RLE))
    data = _inflate(raw, meta, int(_sval(header, 2, 0)))
    levels, dpos = pd.decode_def_levels_v1(
        data, 0, len(data), leaf.max_def_level, nvals, dl_enc)
    if levels is None:
        mask, nvalid = None, nvals
    else:
        mask = levels == np.uint32(leaf.max_def_level)
        nvalid = int(mask.sum())
    vals = _decode_values(data, dpos, leaf, meta, dictionary,
                          encoding, nvalid)
    return vals, mask, nvals


def _decode_data_page_v2(raw: bytes, header, leaf: pf.SchemaLeaf,
                         meta: _ChunkMeta, dictionary):
    d2 = _sval(header, 8)
    if d2 is None:
        raise ParquetDecodeException(
            f"v2 data page of {meta.path!r} missing its header")
    nvals = int(_sval(d2, 1, 0))
    nnulls = int(_sval(d2, 2, 0))
    encoding = int(_sval(d2, 4, 0))
    dl_len = int(_sval(d2, 5, 0))
    rl_len = int(_sval(d2, 6, 0))
    compressed = bool(_sval(d2, 7, True))
    if rl_len:
        raise ParquetDecodeException(
            f"{meta.path!r}: repetition levels in a flat column")
    if dl_len > len(raw):
        raise ParquetDecodeException(
            f"{meta.path!r}: v2 level section overruns page")
    mask = None
    if leaf.max_def_level > 0:
        # v2 levels: hybrid runs with NO 4-byte prefix, never compressed
        levels, _ = pd.decode_hybrid(raw, 0, dl_len,
                                     leaf.max_def_level.bit_length(),
                                     nvals)
        mask = levels == np.uint32(leaf.max_def_level)
        # the header's num_nulls sizes the value decode below; if it
        # disagrees with the levels, assembly would scatter N values
        # into M slots — fail typed here instead of a numpy shape error
        if int(mask.sum()) != nvals - nnulls:
            raise ParquetDecodeException(
                f"{meta.path!r}: v2 page num_nulls={nnulls} disagrees "
                f"with its definition levels "
                f"({nvals - int(mask.sum())} nulls encoded)")
    elif nnulls:
        raise ParquetDecodeException(
            f"{meta.path!r}: v2 page claims {nnulls} nulls in a "
            f"REQUIRED column")
    body = raw[dl_len:]
    if compressed and meta.codec:
        body = _inflate(body, meta,
                        int(_sval(header, 2, 0)) - dl_len - rl_len)
    vals = _decode_values(body, 0, leaf, meta, dictionary, encoding,
                          nvals - nnulls)
    return vals, mask, nvals


# ----------------------------------------------------- column assembly


def _merge_group_masks(masks, group_rows, n) -> Optional[np.ndarray]:
    """Row-group masks -> one per-row bool mask, or None when every
    row is valid (an OPTIONAL column with zero nulls keeps the
    all-valid fast path: no validity buffer materializes)."""
    if all(m is None for m in masks):
        return None
    mask = _stitch_masks(zip(group_rows, masks), n)
    return None if mask.all() else mask


def _build_fixed_column(dtype: DType, parts: List[np.ndarray],
                        masks: List[Optional[np.ndarray]],
                        group_rows: List[int]):
    """Host buffers of a fixed-width column: (dtype, rows, values in
    the kind's numpy dtype, uint8 validity or None)."""
    n = sum(group_rows)
    mask = _merge_group_masks(masks, group_rows, n)
    vals = (np.concatenate(parts) if parts
            else np.empty(0, np.int64))
    validity = None
    if mask is not None:
        full = np.zeros(n, vals.dtype)
        full[mask] = vals
        vals = full
        validity = mask.astype(np.uint8)
    target = dtype.np_dtype
    if vals.dtype != target:
        vals = vals.astype(target)
    return dtype, n, vals, validity, None


def _build_string_column(parts: List[Tuple[np.ndarray, np.ndarray]],
                         masks: List[Optional[np.ndarray]],
                         group_rows: List[int]):
    """Host buffers of a STRING column: (dtype, rows, uint8 chars,
    uint8 validity or None, int32 offsets)."""
    n = sum(group_rows)
    chars = (np.concatenate([c for c, _ in parts]) if parts
             else np.empty(0, np.uint8))
    lens = (np.concatenate([ln for _, ln in parts]) if parts
            else np.empty(0, np.int32))
    mask = _merge_group_masks(masks, group_rows, n)
    validity = None
    if mask is not None:
        full = np.zeros(n, np.int64)
        full[mask] = lens
        lens = full
        validity = mask.astype(np.uint8)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    if offsets[-1] > np.iinfo(np.int32).max:
        raise ParquetDecodeException(
            f"string column exceeds int32 offsets "
            f"({int(offsets[-1])} chars)")
    return dtypes.STRING, n, chars, validity, offsets.astype(np.int32)


def _upload(host, device) -> Column:
    """One host column's buffers onto ``device``, one copy each."""
    dtype, n, data, validity, offsets = host

    def put(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return Column(dtype, n, data=put(data), validity=put(validity),
                  offsets=put(offsets))


# -------------------------------------------------------------- reader


def read_table(path: str, columns: Optional[Sequence[str]] = None,
               case_sensitive: bool = True,
               fileio: Optional[RapidsFileIO] = None,
               device="cuda", stats: Optional[dict] = None) -> Table:
    """Read a flat-schema parquet file into a named :class:`Table` on
    ``device``.  ``columns`` prunes the footer first (projection
    pushdown — unrequested chunks are never fetched); ``None`` reads
    everything.  ``stats``, when given, is filled with this read's
    counts (see the module docstring).  Emits an ``io_read`` span,
    per-fetch ``srt_io_read_*`` metrics, and one ``io_file`` journal
    record."""
    span = _obs.TRACER.span("io_read", kind="io",
                            attrs={"file": os.path.basename(path)})
    with span:
        # ONE opened stream serves the footer + every column-chunk fetch
        with RangeReader(path, fileio) as rr:
            size = rr.length
            t_all = time.perf_counter_ns()
            flen = pf.footer_tail_length(
                size, rr.read(size - 8, 8) if size >= 8 else b"")
            tree = pf.parse_footer(rr.read(size - 8 - flen, flen))
            if columns is not None:
                # dedup, order-preserving: a repeated request resolves to
                # one leaf, and the missing-list check below stays honest
                columns = list(dict.fromkeys(columns))
                tree = pf.prune_columns(tree, list(columns),
                                        case_sensitive=case_sensitive)
            leaves = pf.schema_leaves(tree)
            if columns is not None and len(leaves) != len(columns):
                have = {lf.name if case_sensitive else lf.name.lower()
                        for lf in leaves}
                missing = [c for c in columns
                           if (c if case_sensitive else c.lower())
                           not in have]
                raise pf.ParquetFooterException(
                    f"columns not in {os.path.basename(path)}: {missing}")
            col_dtypes = [_dtype_for_leaf(lf) for lf in leaves]
            try:
                rg_entry = tree[1].get(4)
                rgs = rg_entry[1][2] if rg_entry is not None else []
                group_rows = [int(_sval(rg, 3, 0)) for rg in rgs]
            except (TypeError, IndexError, KeyError, AttributeError) as e:
                raise pf.ParquetFooterException(
                    f"malformed row-group list: {e}") from e
            read_bytes = flen + 8
            decode_ns = 0
            decompress_ns = 0
            pages_total = 0
            parts = [[] for _ in leaves]
            masks = [[] for _ in leaves]
            for rg, rows in zip(rgs, group_rows):
                cols_entry = _sval(rg, 1)
                chunks = cols_entry[2] if cols_entry is not None else []
                if len(chunks) != len(leaves):
                    raise ParquetDecodeException(
                        f"row group has {len(chunks)} chunks for "
                        f"{len(leaves)} schema leaves")
                for j, (leaf, cc) in enumerate(zip(leaves, chunks)):
                    meta = _ChunkMeta(cc, leaf.name, size)
                    if meta.num_values != rows:
                        raise ParquetDecodeException(
                            f"chunk of {leaf.name!r} holds "
                            f"{meta.num_values} values in a {rows}-row "
                            f"group (nested data in a flat column?)")
                    buf = rr.read(meta.start, meta.nbytes)
                    read_bytes += meta.nbytes
                    t0 = time.perf_counter_ns()
                    vals, mask, pages = _decode_chunk(buf, leaf, meta)
                    decode_ns += time.perf_counter_ns() - t0
                    decompress_ns += meta.decompress_ns
                    pages_total += pages
                    parts[j].append(vals)
                    masks[j].append(mask)
        t0 = time.perf_counter_ns()
        host = [_build_string_column(p, m, group_rows) if dt.is_string
                else _build_fixed_column(dt, p, m, group_rows)
                for dt, p, m in zip(col_dtypes, parts, masks)]
        del parts, masks
        t1 = time.perf_counter_ns()
        decode_ns += t1 - t0
        out_cols = [_upload(h, device) for h in host]
        upload_ns = time.perf_counter_ns() - t1
        num_rows = sum(group_rows)
        if stats is not None:
            stats.update(path=path, rows=num_rows, columns=len(leaves),
                         pages=pages_total, read_bytes=read_bytes,
                         decode_ns=decode_ns, decompress_ns=decompress_ns,
                         upload_ns=upload_ns,
                         wall_ns=time.perf_counter_ns() - t_all)
        span.set_attr("rows", num_rows)
        span.set_attr("columns", len(leaves))
        span.set_attr("bytes", read_bytes)
        span.set_attr("pages", pages_total)
        span.set_attr("wall_ns", time.perf_counter_ns() - t_all)
        _obs.record_io_file(path, columns=len(leaves),
                            pages=pages_total, rows=num_rows,
                            read_bytes=read_bytes, decode_ns=decode_ns)
        # ingest-epoch door: a successful read notes the file with a
        # size+mtime fingerprint — the result cache's epoch for this
        # source bumps only when the bytes CHANGED, so re-reading an
        # unchanged file keeps warm results warm
        try:
            from spark_rapids_tpu_torch.perf.result_cache import (
                note_ingest)
            st = os.stat(path)
            note_ingest(path, f"{st.st_size}:{st.st_mtime_ns}")
        except OSError:
            pass   # epoch accounting must never fail a read
        # footer row count -> the stats plane's estimate side: a plan
        # scanning this source inherits the footer count as its
        # input-cardinality estimate
        if _obs.STATS.enabled:
            _obs.STATS.note_source_rows(path, num_rows,
                                        origin="parquet_footer")
        return Table(out_cols, names=[lf.name for lf in leaves])
