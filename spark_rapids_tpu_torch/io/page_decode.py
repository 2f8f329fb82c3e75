"""Parquet page decoders: PLAIN, PLAIN_DICTIONARY/RLE_DICTIONARY, and
the RLE/bit-packed hybrid for definition levels and dictionary indices
(reference: the L3 Parquet kernels behind NativeParquetJni — here the
host-side half that feeds the device column layout).

Vectorization contract: no fixed-width path loops per VALUE.  A hybrid
stream's values materialize per PAGE in a few numpy passes (all its
bit-packed bytes unpacked at once, one gather placing every run); only
its run headers are walked in Python one by one, and not even those at
bit width 1 (definition levels), where a pointer-doubling chain finds
them.  A dictionary data page decodes as one index decode plus one
``np.take``.  The only per-value walk left is the PLAIN ``BYTE_ARRAY``
length-prefix scan (an inherently sequential format);
dictionary-encoded strings — what Spark-shaped writers emit — take the
vectorized gather.  Every output (values, positions, errors) equals
the JAX package's decoders'.

Every malformed-input shape raises the typed
:class:`ParquetDecodeException`, which the retry drivers treat as
NON-retryable (a corrupt page never heals by recompute; registered
via ``robustness.retry.register_non_retryable`` at import).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

# parquet Encoding enum (parquet.thrift)
ENC_PLAIN = 0
ENC_PLAIN_DICTIONARY = 2
ENC_RLE = 3
ENC_BIT_PACKED = 4
ENC_RLE_DICTIONARY = 8

from spark_rapids_tpu_torch.io.parquet_footer import (  # noqa: E402
    PHYS_BOOLEAN, PHYS_BYTE_ARRAY, PHYS_DOUBLE, PHYS_FLOAT, PHYS_INT32,
    PHYS_INT64, PHYSICAL_TYPE_NAMES)

_U32 = struct.Struct("<I")
_PLAIN_NP = {
    PHYS_INT32: np.dtype("<i4"),
    PHYS_INT64: np.dtype("<i8"),
    PHYS_FLOAT: np.dtype("<f4"),
    PHYS_DOUBLE: np.dtype("<f8"),
}


from spark_rapids_tpu_torch.memory.exceptions import CudfException  # noqa: E402


class ParquetDecodeException(CudfException):
    """Typed, terminal page-decode failure (truncated page, impossible
    run lengths, unsupported encoding/physical type, dictionary index
    out of range).  Subclasses :class:`CudfException` — the reference
    surfaces decode failures as engine exceptions — which lands it in
    the retry drivers' RETRYABLE catch set, so it is REGISTERED
    non-retryable below and the drivers escalate on the first attempt:
    re-reading a corrupt page produces the same bytes forever."""


def _register_non_retryable() -> None:
    from spark_rapids_tpu_torch.robustness import retry as _retry
    _retry.register_non_retryable(ParquetDecodeException)


_register_non_retryable()


def _varint(buf: bytes, pos: int, end: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise ParquetDecodeException(
                "truncated varint in RLE/bit-packed run header")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ParquetDecodeException("runaway varint in run header")


def _walk_runs(buf, pos: int, end: int, bit_width: int, count: int):
    """The run headers in order, read one by one: (table, position
    after the last run), a table row per run: (1, first byte, values)
    for a bit-packed run, (0, the value, values) for an RLE run.  The
    last run may yield more values than ``count`` still needs.  Every
    malformed header raises here, in stream order."""
    byte_w = (bit_width + 7) // 8
    runs = []
    append = runs.append
    filled = 0
    while filled < count:
        if pos < end and buf[pos] < 0x80:   # one-byte header
            header = buf[pos]
            pos += 1
        else:
            header, pos = _varint(buf, pos, end)
        if header & 1:  # bit-packed run: (header >> 1) groups of 8
            ngroups = header >> 1
            nbytes = ngroups * bit_width
            if ngroups == 0 or pos + nbytes > end:
                raise ParquetDecodeException(
                    f"bit-packed run overruns page "
                    f"({nbytes} bytes at {pos}, page ends {end})")
            append((1, pos, ngroups * 8))
            pos += nbytes
            filled += ngroups * 8
        else:  # RLE run: one value repeated (header >> 1) times
            run = header >> 1
            if run == 0:
                raise ParquetDecodeException("zero-length RLE run")
            if pos + byte_w > end:
                raise ParquetDecodeException(
                    "RLE run value overruns page")
            append((0, int.from_bytes(buf[pos:pos + byte_w], "little"),
                    run))
            pos += byte_w
            filled += run
    return np.array(runs, np.int64), pos


def _chain_runs(buf, pos: int, end: int, count: int):
    """:func:`_walk_runs` for bit width 1 without a Python step a run:
    every byte is read as a possible header, each points to where the
    next header would start, and pointer doubling marks the headers
    reachable from the first.  Definition levels of a flat column are
    such a stream, with a short run around every null.  Returns None
    when a header on the chain is malformed or the runs fall short, so
    that the walk raises the exact error."""
    n = end - pos
    b = np.zeros(n + 5, np.int64)
    b[:n] = np.frombuffer(buf, np.uint8, n, pos)
    # varints of up to 5 bytes at every position (longer: the walk)
    more = (b >= 0x80)
    length = np.full(n, 6, np.int64)
    for k in range(4, -1, -1):
        length[~more[k:k + n]] = k + 1
    header = np.zeros(n, np.int64)
    for k in range(5):
        header |= np.where(k < length, (b[k:k + n] & 0x7F) << (7 * k), 0)
    at = np.arange(n, dtype=np.int64)
    body = at + length
    packed = (header & 1) == 1
    half = header >> 1
    nxt = body + np.where(packed, half, 1)
    bad = ((length > 5) | (half == 0) | (nxt > n))
    # reachable headers from position 0, by doubling jumps
    jump = np.append(np.minimum(nxt, n), n)
    reach = np.zeros(n + 1, np.bool_)
    reach[0] = True
    span = 1
    while span <= n:
        reach[jump[reach]] = True
        jump = jump[jump]
        span *= 2
    chain = np.nonzero(reach[:n])[0]
    values = np.where(packed[chain], half[chain] * 8, half[chain])
    filled = np.cumsum(values)
    last = int(np.searchsorted(filled, count))
    if last == len(chain) or bad[chain[:last + 1]].any():
        return None
    chain = chain[:last + 1]
    table = np.stack([packed[chain].astype(np.int64),
                      np.where(packed[chain], pos + body[chain],
                               b[body[chain]]),
                      values[:last + 1]], axis=1)
    return table, pos + int(nxt[chain[-1]])


def _unpack(raw: np.ndarray, bit_width: int) -> np.ndarray:
    """Bit-packed values, LSB first, ``bit_width`` (1-32) bits each, as
    uint32: every value one unaligned 8-byte load, a shift and a mask."""
    if bit_width == 1:
        return np.unpackbits(raw, bitorder="little").astype(np.uint32)
    padded = np.zeros(len(raw) + 8, np.uint8)
    padded[:len(raw)] = raw
    words = np.ndarray((len(raw),), np.dtype("<u8"), padded, 0, (1,))
    at = np.arange(len(raw) * 8 // bit_width, dtype=np.int64) * bit_width
    return ((words[at >> 3] >> (at & 7).astype(np.uint64))
            & np.uint64((1 << bit_width) - 1)).astype(np.uint32)


def decode_hybrid(buf: bytes, pos: int, end: int, bit_width: int,
                  count: int) -> Tuple[np.ndarray, int]:
    """RLE/bit-packed hybrid (parquet spec §RLE): ``count`` values of
    ``bit_width`` bits from ``buf[pos:end]``.  Returns (uint32 values,
    next position).  The run headers are found first (their positions
    depend on each other: :func:`_chain_runs` at bit width 1, else
    :func:`_walk_runs`); the values then materialize in a few
    whole-page numpy passes: every bit-packed run's bytes unpack
    together, and one gather places the runs' values."""
    out = np.empty(count, np.uint32)
    if count == 0:
        return out, pos
    if bit_width == 0:
        out[:] = 0
        return out, pos
    if bit_width > 32:
        raise ParquetDecodeException(
            f"hybrid bit width {bit_width} > 32")
    found = _chain_runs(buf, pos, end, count) if bit_width == 1 else None
    table, pos = found or _walk_runs(buf, pos, end, bit_width, count)
    packed = table[:, 0] == 1
    lengths = table[:, 2].copy()
    lengths[-1] -= int(lengths.sum()) - count   # the last run may overhang
    # the bit-packed runs' values, all runs' bytes unpacked at once
    groups = table[packed, 2]
    unpacked = _unpack(gather_ragged(np.frombuffer(buf, np.uint8),
                                     table[packed, 1],
                                     groups // 8 * bit_width), bit_width)
    if packed.all():
        out[:] = unpacked[:count]
        return out, pos
    # source = [unpacked values..., one slot per RLE run]; a packed
    # run's k-th value is its first slot + k, an RLE run's always its own
    rle_vals = table[~packed, 1].astype(np.uint32)
    source = np.concatenate([unpacked, rle_vals])
    first = np.empty(len(lengths), np.int64)
    first[packed] = np.cumsum(groups) - groups
    first[~packed] = len(unpacked) + np.arange(len(rle_vals))
    run_of = np.repeat(np.arange(len(lengths)), lengths)
    run_start = np.cumsum(lengths) - lengths
    step = np.arange(count, dtype=np.int64) - run_start[run_of]
    out[:] = source[first[run_of] + step * packed[run_of]]
    return out, pos


def decode_def_levels_v1(buf: bytes, pos: int, end: int,
                         max_level: int, num_values: int,
                         encoding: int
                         ) -> Tuple[Optional[np.ndarray], int]:
    """Definition levels of a v1 data page: 4-byte length prefix then
    an RLE/bit-packed hybrid of ``num_values`` levels.  Returns
    (levels or None when the column is REQUIRED, position past the
    level bytes)."""
    if max_level == 0:
        return None, pos
    if encoding not in (ENC_RLE, ENC_BIT_PACKED):
        raise ParquetDecodeException(
            f"definition-level encoding {encoding} unsupported")
    if encoding == ENC_BIT_PACKED:
        raise ParquetDecodeException(
            "legacy BIT_PACKED definition levels unsupported "
            "(write with a parquet-format >= 2.0 writer)")
    if pos + 4 > end:
        raise ParquetDecodeException("truncated definition-level block")
    (nbytes,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if pos + nbytes > end:
        raise ParquetDecodeException(
            f"definition levels ({nbytes} bytes) overrun page")
    levels, _ = decode_hybrid(buf, pos, pos + nbytes,
                              max_level.bit_length(), num_values)
    return levels, pos + nbytes


def decode_plain_fixed(buf: bytes, pos: int, end: int, phys: int,
                       count: int) -> Tuple[np.ndarray, int]:
    """PLAIN fixed-width values: one ``np.frombuffer``.  BOOLEAN is
    bit-packed LSB-first: one ``np.unpackbits``."""
    if phys == PHYS_BOOLEAN:
        nbytes = (count + 7) // 8
        if pos + nbytes > end:
            raise ParquetDecodeException("truncated PLAIN boolean run")
        bits = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes, pos),
                             bitorder="little")[:count]
        return bits.astype(np.uint8), pos + nbytes
    dt = _PLAIN_NP.get(phys)
    if dt is None:
        raise ParquetDecodeException(
            f"PLAIN decode of physical type "
            f"{PHYSICAL_TYPE_NAMES.get(phys, phys)} unsupported")
    nbytes = count * dt.itemsize
    if pos + nbytes > end:
        raise ParquetDecodeException(
            f"truncated PLAIN {PHYSICAL_TYPE_NAMES[phys]} values "
            f"(want {nbytes} bytes at {pos}, page ends {end})")
    return np.frombuffer(buf, dt, count, pos), pos + nbytes


def _scan_byte_array(buf: bytes, pos: int, end: int, count: int
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The sequential BYTE_ARRAY length-prefix walk shared by PLAIN
    data pages and dictionary pages: ``count`` (uint32-length, bytes)
    pairs -> (in-buffer starts, lengths, end position)."""
    starts, lens = [], []
    unpack = _U32.unpack_from
    p = pos
    for i in range(count):
        if p + 4 > end:
            raise ParquetDecodeException(
                f"truncated BYTE_ARRAY length prefix "
                f"(value {i} of {count})")
        (ln,) = unpack(buf, p)
        p += 4
        if p + ln > end:
            raise ParquetDecodeException(
                f"BYTE_ARRAY value {i} ({ln} bytes) overruns page")
        starts.append(p)
        lens.append(ln)
        p += ln
    return np.array(starts, np.int64), np.array(lens, np.int64), p


def decode_plain_byte_array(buf: bytes, pos: int, end: int, count: int
                            ) -> Tuple[np.ndarray, np.ndarray, int]:
    """PLAIN BYTE_ARRAY: the length-prefix walk is sequential by
    format; the character copy is one vectorized gather.  Returns
    (chars uint8, lengths int32, position)."""
    starts, lens, p = _scan_byte_array(buf, pos, end, count)
    chars = gather_ragged(np.frombuffer(buf, np.uint8), starts, lens)
    return chars, lens.astype(np.int32), p


def gather_ragged(src_u8: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray) -> np.ndarray:
    """Concatenate ``src_u8[starts[i]:starts[i]+lens[i]]`` for every i
    as ONE fancy-index gather (no per-value python)."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.uint8)
    out_off = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=out_off[1:])
    flat = (np.repeat(starts - out_off, lens)
            + np.arange(total, dtype=np.int64))
    return src_u8[flat]


class Dictionary:
    """Decoded dictionary page: fixed-width values as one np array, or
    byte-array values as (chars, starts, lens)."""

    __slots__ = ("phys", "values", "chars", "starts", "lens")

    def __init__(self, phys: int, values=None, chars=None, starts=None,
                 lens=None):
        self.phys = phys
        self.values = values
        self.chars = chars
        self.starts = starts
        self.lens = lens

    @property
    def size(self) -> int:
        return (len(self.values) if self.values is not None
                else len(self.lens))


def decode_dictionary_page(data: bytes, phys: int,
                           num_values: int) -> Dictionary:
    """Dictionary pages are PLAIN-encoded values of the column's
    physical type (PLAIN_DICTIONARY in old headers means the same)."""
    if phys == PHYS_BYTE_ARRAY:
        # keep the in-buffer starts for the gather path (chars here is
        # the packed dictionary, starts/lens index into it)
        starts, lens, _ = _scan_byte_array(data, 0, len(data),
                                           num_values)
        return Dictionary(phys, chars=np.frombuffer(data, np.uint8),
                          starts=starts, lens=lens)
    vals, _ = decode_plain_fixed(data, 0, len(data), phys, num_values)
    return Dictionary(phys, values=vals)


def decode_dictionary_indices(data: bytes, pos: int, end: int,
                              count: int) -> np.ndarray:
    """RLE_DICTIONARY data-page payload: one bit-width byte then a
    hybrid run of ``count`` dictionary indices."""
    if count == 0:
        return np.empty(0, np.uint32)
    if pos >= end:
        raise ParquetDecodeException(
            "dictionary-index block missing its bit-width byte")
    bit_width = data[pos]
    idx, _ = decode_hybrid(data, pos + 1, end, int(bit_width), count)
    return idx


def dictionary_take(dic: Dictionary, idx: np.ndarray):
    """Gather dictionary values at ``idx`` — the one-take hot path.
    Fixed width returns an np array; BYTE_ARRAY returns
    (chars, lens)."""
    if dic.size and int(idx.max(initial=0)) >= dic.size:
        raise ParquetDecodeException(
            f"dictionary index {int(idx.max())} out of range "
            f"(dictionary holds {dic.size} values)")
    if dic.values is not None:
        if dic.size == 0 and len(idx):
            raise ParquetDecodeException(
                "data page references an empty dictionary")
        return dic.values[idx]
    if dic.size == 0 and len(idx):
        raise ParquetDecodeException(
            "data page references an empty dictionary")
    lens = dic.lens[idx]
    chars = gather_ragged(dic.chars, dic.starts[idx], lens)
    return chars, lens.astype(np.int32)
