"""Assorted string/conversion ops: number_converter conv(), GBK charset
decode, list_slice, the regex fast path literal_range_pattern
(reference number_converter.cu, charset_decode.cu, list_slice.cu,
regex_rewrite_utils.cu).

conv(), list_slice and literal_range_pattern are host loops, as in the
JAX package; each returns its column on its input column's device.  The
GBK decode runs on the column's device.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.ops.exceptions import ExceptionWithRowIndex

_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"


# ------------------------------------------------------- number_converter

def parse_base_prefix(t: str, base: int) -> Tuple[int, bool]:
    """Optional '-' then the longest valid-digit prefix of t in `base`,
    accumulated as unsigned 64-bit: overflow clamps to 2^64-1 (and stays
    clamped under negation), negatives wrap.  Shared by conv()
    (number_converter.cu) and CastStrings.toIntegersWithBase."""
    neg = t[:1] == "-"
    if neg:
        t = t[1:]
    val = 0
    overflow = False
    for ch in t:
        d = _DIGITS.find(ch.lower())
        if d < 0 or d >= base:
            break
        if not overflow:
            val = val * base + d
            if val >= 1 << 64:
                overflow = True
    if overflow:
        val = (1 << 64) - 1
    elif neg:
        val = ((1 << 64) - val) & ((1 << 64) - 1)
    return val, overflow


def _conv_one(s: Optional[str], from_base: int, to_base: int
              ) -> Tuple[Optional[str], bool]:
    """Spark conv() single value; returns (result, overflowed).
    Semantics (number_converter.cu / Spark NumberConverter): ASCII spaces
    trimmed (only 0x20), optional '-', longest valid-digit prefix parsed
    as UNSIGNED 64-bit; zero digits still render "0"; overflow clamps to
    2^64-1 (stays clamped under negation); from_base must be 2..36
    (positive only); to_base<0 renders signed."""
    if s is None:
        return None, False
    if not (2 <= from_base <= 36 and 2 <= abs(to_base) <= 36):
        return None, False
    t = s.strip(" ")
    if not t:
        return None, False
    val, overflow = parse_base_prefix(t, from_base)
    tb = abs(to_base)
    if to_base < 0:
        # signed rendering
        sval = val - (1 << 64) if val >= (1 << 63) else val
        sign = "-" if sval < 0 else ""
        mag = abs(sval)
    else:
        sign = ""
        mag = val
    if mag == 0:
        return "0", overflow
    out = []
    while mag:
        out.append(_DIGITS[mag % tb].upper())
        mag //= tb
    return sign + "".join(reversed(out)), overflow


def _conv_inputs(col_or_str, rows, device):
    """(host values, output device) of conv()'s column-or-scalar input;
    a scalar repeats `rows` times onto `device`."""
    if isinstance(col_or_str, Column):
        return col_or_str.to_pylist(), col_or_str.device
    return [col_or_str] * (rows if rows is not None else 1), device


def convert(col_or_str: Union[Column, str], from_base: int, to_base: int,
            rows: Optional[int] = None, device="cuda") -> Column:
    """Spark conv() (NumberConverter.java convert*)."""
    vals, device = _conv_inputs(col_or_str, rows, device)
    return Column.from_strings(
        [_conv_one(v, from_base, to_base)[0] for v in vals], device)


def is_convert_overflow(col_or_str: Union[Column, str], from_base: int,
                        to_base: int, rows: Optional[int] = None,
                        device="cuda") -> Column:
    """BOOL8: conv() would overflow uint64 (ANSI pre-check,
    number_converter.hpp is_convert_overflow)."""
    vals, device = _conv_inputs(col_or_str, rows, device)
    res = [_conv_one(v, from_base, to_base) for v in vals]
    return Column.from_pylist(
        [ovf if v0 is not None else None
         for (_, ovf), v0 in zip(res, vals)],
        dtypes.BOOL8, device)


# --------------------------------------------------------- charset decode

REPLACE = "REPLACE"
REPORT = "REPORT"


_GBK_SENTINEL = 0x110000


@functools.lru_cache(maxsize=1)
def _gbk_table() -> np.ndarray:
    """64K GBK-code -> Unicode-codepoint table, generated from the
    stdlib codec (the reference vendors a codegen'd
    gbk_to_unicode_table.inc -- charset_decode.cu:51-141; here the table
    is regenerated at first use, same idea).  Unmapped codes hold a
    sentinel."""
    t = np.full(65536, _GBK_SENTINEL, np.int32)
    t[:0x80] = np.arange(0x80)          # single-byte ASCII plane
    for lead in range(0x81, 0xFF):
        row = bytes(b"".join(bytes([lead, tr])
                             for tr in range(0x40, 0xFF)))
        for tr in range(0x40, 0xFF):
            pair = row[2 * (tr - 0x40): 2 * (tr - 0x40) + 2]
            try:
                u = pair.decode("gbk")
            except UnicodeDecodeError:
                continue
            if len(u) == 1:
                t[(lead << 8) | tr] = ord(u)
    return t


def decode_to_utf8(col: Column, charset: str = "GBK",
                   on_error: str = REPLACE) -> Column:
    """GBK -> UTF-8 decode (charset_decode.cu two-pass table decode;
    CharsetDecode.java:55-79).  REPLACE substitutes U+FFFD; REPORT
    raises with the first malformed row.

    Two passes, as the reference kernel: a char-step loop advances every
    row's cursor at once (1 byte for ASCII, 2 for a mapped pair, 1 +
    U+FFFD otherwise -- the stdlib codec's error-consumption rule), then
    one UTF-8 byte-emission pass builds the output buffer.  No per-row
    Python."""
    assert col.dtype.is_string
    if charset.upper() != "GBK":
        raise ValueError("only GBK is supported")
    rows = col.length
    dev = col.offsets.device
    if rows == 0:
        return Column.from_strings([], dev)
    table = torch.from_numpy(_gbk_table()).to(dev)
    chars, lens = col.to_padded_chars()
    lens = lens.to(torch.int64)
    mask = col.valid_mask()
    lens = torch.where(mask, lens, 0)
    R, L = chars.shape

    cur = torch.zeros(R, dtype=torch.int64, device=dev)
    outn = torch.zeros(R, dtype=torch.int64, device=dev)
    out_cp = torch.zeros((R, max(L, 1)), dtype=torch.int32, device=dev)
    malformed = torch.zeros(R, dtype=torch.bool, device=dev)
    rows_idx = torch.arange(R, device=dev)
    while True:
        active = cur < lens
        if not bool(active.any()):
            break
        b = chars[rows_idx, torch.clamp(cur, max=L - 1)].to(torch.int64)
        t = chars[rows_idx, torch.clamp(cur + 1, max=L - 1)].to(
            torch.int64)
        has_t = cur + 1 < lens
        is_ascii = b < 0x80
        code = torch.where(has_t, (b << 8) | t, 0)
        u = table[code]
        pair_ok = ~is_ascii & has_t & (u != _GBK_SENTINEL)
        emit = torch.where(is_ascii, b.to(torch.int32),
                           torch.where(pair_ok, u, 0xFFFD))
        bad = active & ~is_ascii & ~pair_ok
        malformed |= bad
        act_i = torch.nonzero(active).squeeze(1)
        out_cp[act_i, outn[act_i]] = emit[act_i]
        outn += active
        cur += torch.where(active, torch.where(pair_ok, 2, 1), 0)

    bad_rows = torch.nonzero(malformed & mask).squeeze(1)
    if on_error == REPORT and bad_rows.shape[0]:
        raise ExceptionWithRowIndex(int(bad_rows[0]), "malformed GBK bytes")

    # pass 2: UTF-8 emission (GBK maps inside the BMP: <= 3 bytes)
    keep = (torch.arange(out_cp.shape[1], device=dev)[None, :]
            < outn[:, None])
    flat = out_cp[keep].to(torch.int64)            # row-major order
    nb = torch.where(flat < 0x80, 1, torch.where(flat < 0x800, 2, 3))
    boff = torch.zeros(flat.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(nb, 0, out=boff[1:])
    total = int(boff[-1])
    buf = torch.zeros(total, dtype=torch.uint8, device=dev)
    b0 = torch.where(nb == 1, flat,
                     torch.where(nb == 2, 0xC0 | (flat >> 6),
                                 0xE0 | (flat >> 12)))
    buf[boff[:-1]] = b0.to(torch.uint8)
    m2 = nb >= 2
    buf[boff[:-1][m2] + 1] = torch.where(
        nb[m2] == 2, 0x80 | (flat[m2] & 0x3F),
        0x80 | ((flat[m2] >> 6) & 0x3F)).to(torch.uint8)
    m3 = nb == 3
    buf[boff[:-1][m3] + 2] = (0x80 | (flat[m3] & 0x3F)).to(torch.uint8)

    cp_row = torch.repeat_interleave(rows_idx, outn,
                                     output_size=flat.shape[0])
    row_bytes = torch.zeros(R, dtype=torch.int64, device=dev)
    row_bytes.index_add_(0, cp_row, nb)
    offs = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    torch.cumsum(row_bytes, 0, out=offs[1:])
    return Column(
        dtypes.STRING, rows, data=buf,
        validity=None if bool(mask.all()) else mask.to(torch.uint8),
        offsets=offs.to(torch.int32))


# -------------------------------------------------------------- list_slice

def list_slice(col: Column, start: Union[int, Column],
               length: Union[int, Column, None] = None,
               check_start_length: bool = True) -> Column:
    """Spark slice(list, start, length) -- 1-based start, negative counts
    from the end (list_slice.hpp 4 overloads via scalar/column combos).
    A host loop over the rows' bounds; the child elements are gathered
    on the column's device."""
    from spark_rapids_tpu_torch.ops.copying import gather

    assert col.dtype.kind == Kind.LIST
    rows = col.length
    dev = col.offsets.device
    offs = col.offsets.cpu().numpy()
    starts = (start.to_pylist() if isinstance(start, Column)
              else [start] * rows)
    length_is_col = isinstance(length, Column)
    lens = (length.to_pylist() if length_is_col else [length] * rows)
    mask = col.valid_mask().cpu().numpy()
    child = col.children[0]
    take: List[int] = []
    new_offs = np.zeros(rows + 1, np.int32)
    out_valid = np.zeros(rows, np.uint8)
    for i in range(rows):
        # a null entry in a start/length COLUMN nulls the row
        # (list_slice.cu:100-101); a scalar length of None means
        # "slice to the end"
        null_len = length_is_col and lens[i] is None
        if not mask[i] or starts[i] is None or null_len:
            new_offs[i + 1] = len(take)
            continue
        st = int(starts[i])
        if check_start_length and st == 0:
            raise ExceptionWithRowIndex(
                i, "Unexpected value for start in function slice: SQL "
                   "array indices start at 1.")
        ln_req = lens[i]
        if ln_req is not None and int(ln_req) < 0 and check_start_length:
            raise ExceptionWithRowIndex(
                i, "Unexpected value for length in function slice: "
                   "length must be greater than or equal to 0.")
        n = int(offs[i + 1] - offs[i])
        if st > 0:
            begin = st - 1
        else:
            begin = n + st
        if begin < 0 or begin >= n:
            sliced: List[int] = []
        else:
            count = n - begin if ln_req is None else min(int(ln_req),
                                                         n - begin)
            sliced = list(range(int(offs[i]) + begin,
                                int(offs[i]) + begin + count))
        take.extend(sliced)
        new_offs[i + 1] = len(take)
        out_valid[i] = 1
    new_child = gather(child, torch.tensor(take, dtype=torch.int64,
                                           device=dev))
    validity = (None if out_valid.all()
                else torch.from_numpy(out_valid).to(dev))
    return Column(dtypes.LIST, rows, validity=validity,
                  offsets=torch.from_numpy(new_offs).to(dev),
                  children=(new_child,))


# ------------------------------------------------- regex fast-path search

def literal_range_pattern(col: Column, literal: str, range_len: int,
                          start: int, end: int) -> Column:
    """BOOL8: row contains `literal` followed by `range_len` codepoints
    each within [start, end] (regex_rewrite_utils.cu literal_range
    fast path for trivial regexes like 'lit[a-b]{n}')."""
    assert col.dtype.is_string
    vals = col.to_pylist()
    out: List[Optional[bool]] = []
    for s in vals:
        if s is None:
            out.append(None)
            continue
        found = False
        m = len(literal)
        for i in range(len(s) - m - range_len + 1):
            if s[i:i + m] != literal:
                continue
            ok = all(start <= ord(s[i + m + j]) <= end
                     for j in range(range_len))
            if ok:
                found = True
                break
        out.append(found)
    return Column.from_pylist(out, dtypes.BOOL8, col.offsets.device)
