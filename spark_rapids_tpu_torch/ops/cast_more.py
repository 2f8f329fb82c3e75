"""Remaining cast/format kernels (reference cast_string.hpp:36-72,
cast_decimal_to_string.cu, cast_long_to_binary_string.cu, hex.cu,
format_float.cu, cast_string_to_datetime.cu /
parse_timestamp_with_format): bin(), hex(), decimal->string,
format_number(), and Spark string->date/timestamp parsing.

bin() runs on the column's device.  The others are host loops, as in
the reference's JAX port: the column's values go to the host once and
the result comes back to the column's device."""

from __future__ import annotations

import datetime
import re
from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.columns.strbuild import _segments
from spark_rapids_tpu_torch.ops.datetime_ops import civil_days_scalar \
    as _days_from_civil
from spark_rapids_tpu_torch.ops.exceptions import CastException
from spark_rapids_tpu_torch.utils.u64math import clz64


def long_to_binary_string(col: Column) -> Column:
    """Spark bin(): unsigned 64-bit binary, no leading zeros
    (cast_string.hpp long_to_binary_string), on the column's device:
    each row's digit count from its leading zeros, then one byte per
    output char, read from the row's bits."""
    assert col.dtype.kind == Kind.INT64
    u = col.data
    device = u.device
    nbits = (64 - clz64(u).to(torch.int64)).clamp(min=1)  # 0 -> "0"
    lens = torch.where(col.valid_mask(), nbits, 0)
    offsets = torch.zeros(col.length + 1, dtype=torch.int64, device=device)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1]) if col.length else 0
    row, pos = _segments(lens, total)
    bit = (u[row] >> (nbits[row] - 1 - pos)) & 1
    data = (bit + 48).to(torch.uint8)
    return Column(dtypes.STRING, col.length, data=data,
                  validity=col.validity, offsets=offsets.to(torch.int32))


def bytes_to_hex(col: Column) -> Column:
    """hex() of a binary (LIST<UINT8>) or string column: two uppercase
    hex digits per byte (cast_string.hpp bytes_to_hex)."""
    if col.dtype.kind == Kind.LIST:
        chars = col.children[0].data.cpu().numpy()
    elif col.dtype.is_string:
        chars = (col.data.cpu().numpy() if col.data is not None
                 else np.zeros(0, np.uint8))
    else:
        raise ValueError("binary or string column required")
    offs = col.offsets.cpu().numpy()
    mask = col.valid_mask().cpu().numpy()
    blob = chars.tobytes()
    return Column.from_strings(
        [blob[offs[i]:offs[i + 1]].hex().upper() if mask[i] else None
         for i in range(col.length)], col.device)


def long_to_hex_string(col: Column) -> Column:
    """hex() of an INT64 column (unsigned, no leading zeros)."""
    assert col.dtype.kind == Kind.INT64
    host = col.data.cpu().numpy().astype(np.uint64)
    mask = col.valid_mask().cpu().numpy()
    return Column.from_strings(
        [format(int(host[i]), "X") if mask[i] else None
         for i in range(col.length)], col.device)


def decimal_to_non_ansi_string(col: Column) -> Column:
    """decimal -> string, non-ANSI Spark formatting
    (cast_decimal_to_string.cu): scale digits after the point, leading
    0 for |v| < 1, no trailing-zero trimming."""
    if not col.dtype.is_decimal:
        raise ValueError("decimal column required")
    scale = -col.dtype.scale  # digits after the point
    out: List[Optional[str]] = []
    for v in col.to_pylist():
        if v is None:
            out.append(None)
            continue
        v = int(v)
        digits = str(abs(v))
        if scale <= 0:
            body = digits + "0" * (-scale)
        else:
            digits = digits.rjust(scale + 1, "0")
            body = f"{digits[:-scale]}.{digits[-scale:]}"
        out.append(("-" if v < 0 else "") + body)
    return Column.from_strings(out, col.device)


def format_number(col: Column, digits: int) -> Column:
    """Spark format_number(x, d): thousands separators + d decimal places
    HALF_EVEN (format_float.cu / cast_string.hpp format_float)."""
    is_float = col.dtype.kind in (Kind.FLOAT32, Kind.FLOAT64)
    mask = col.valid_mask().cpu().numpy()
    host = col.data.cpu().numpy()
    out: List[Optional[str]] = []
    for i in range(col.length):
        if not mask[i]:
            out.append(None)
            continue
        v = float(host[i]) if is_float else int(host[i])
        if is_float and (np.isnan(v) or np.isinf(v)):
            out.append("NaN" if np.isnan(v) else
                       ("∞" if v > 0 else "-∞"))
            continue
        out.append(f"{v:,.{max(digits, 0)}f}")
    return Column.from_strings(out, col.device)


# ------------------------------------------------ string -> date/timestamp

_DATE_RE = re.compile(
    r"^\s*([+-]?\d{1,7})(?:-(\d{1,2})(?:-(\d{1,2})(.*))?)?\s*$")
_TIME_RE = re.compile(
    r"^[T ](\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:\.(\d{1,9}))?)?"
    r"(Z|[+-]\d{1,2}(?::\d{1,2})?)?\s*$")


def _valid_ymd(y, m, d) -> bool:
    if not (1 <= m <= 12 and 1 <= d <= 31):
        return False
    if 1 <= y <= 9999:
        try:
            datetime.date(y, m, d)
            return True
        except ValueError:
            return False
    # proleptic years outside datetime.date's range: manual day-in-month
    dim = [31, 29 if (y % 4 == 0 and (y % 100 != 0 or y % 400 == 0))
           else 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m - 1]
    return d <= dim


def _finish(col: Column, vals, out: np.ndarray, valid: np.ndarray,
            dtype, ansi_mode: bool) -> Column:
    """The parsed column on the input's device: ANSI raises at the
    first valid row that did not parse, else such rows become null."""
    base_valid = col.valid_mask().cpu().numpy()
    if ansi_mode:
        bad = base_valid & ~valid
        if bad.any():
            row = int(np.argmax(bad))
            raise CastException(row, vals[row])
        validity = col.validity
    else:
        validity = torch.from_numpy(
            (valid & base_valid).astype(np.uint8)).to(col.device)
    return Column(dtype, col.length,
                  data=torch.from_numpy(out).to(col.device),
                  validity=validity)


def parse_strings_to_date(col: Column, ansi_mode: bool = False) -> Column:
    """Spark CAST(string AS DATE) (cast_string.hpp parse_strings_to_date):
    accepts yyyy, yyyy-[M]M, yyyy-[M]M-[d]d (trailing time part ignored
    when it starts with T or space)."""
    assert col.dtype.is_string
    vals = col.to_pylist()
    out = np.zeros(col.length, np.int32)
    valid = np.zeros(col.length, bool)
    for i, s in enumerate(vals):
        if s is None:
            continue
        m = _DATE_RE.match(s)
        if not m:
            continue
        y = int(m.group(1))
        mo = int(m.group(2)) if m.group(2) else 1
        d = int(m.group(3)) if m.group(3) else 1
        rest = m.group(4) or ""
        if rest and not (rest.startswith("T") or rest.startswith(" ")):
            continue
        if not _valid_ymd(y, mo, d):
            continue
        out[i] = _days_from_civil(y, mo, d)
        valid[i] = True
    return _finish(col, vals, out, valid, dtypes.TIMESTAMP_DAYS, ansi_mode)


def parse_timestamp_strings(col: Column, default_tz_offset_sec: int = 0,
                            ansi_mode: bool = False) -> Column:
    """Spark CAST(string AS TIMESTAMP) (cast_string.hpp
    parse_timestamp_strings): date part + optional time-of-day with
    fractional seconds and optional Z/±hh[:mm] zone; zoneless values use
    default_tz_offset_sec."""
    assert col.dtype.is_string
    vals = col.to_pylist()
    out = np.zeros(col.length, np.int64)
    valid = np.zeros(col.length, bool)
    for i, s in enumerate(vals):
        if s is None:
            continue
        m = _DATE_RE.match(s)
        if not m:
            continue
        y = int(m.group(1))
        mo = int(m.group(2)) if m.group(2) else 1
        d = int(m.group(3)) if m.group(3) else 1
        if not _valid_ymd(y, mo, d):
            continue
        rest = m.group(4) or ""
        hh = mm = ss = frac_us = 0
        off = default_tz_offset_sec
        if rest:
            t = _TIME_RE.match(rest)
            if not t:
                continue
            hh = int(t.group(1))
            mm = int(t.group(2))
            ss = int(t.group(3)) if t.group(3) else 0
            if t.group(4):
                frac_us = int(t.group(4)[:6].ljust(6, "0"))
            if t.group(5):
                z = t.group(5)
                if z == "Z":
                    off = 0
                else:
                    sign = -1 if z[0] == "-" else 1
                    parts = z[1:].split(":")
                    off = sign * (int(parts[0]) * 3600
                                  + (int(parts[1]) * 60
                                     if len(parts) > 1 else 0))
            if not (hh < 24 and mm < 60 and ss < 60):
                continue
        days = _days_from_civil(y, mo, d)
        out[i] = ((days * 86400 + hh * 3600 + mm * 60 + ss - off)
                  * 1_000_000 + frac_us)
        valid[i] = True
    return _finish(col, vals, out, valid, dtypes.TIMESTAMP_MICROS,
                   ansi_mode)


_FORMAT_TOKENS = [
    ("yyyy", r"(?P<y>\d{4})"), ("MM", r"(?P<M>\d{2})"),
    ("dd", r"(?P<d>\d{2})"), ("HH", r"(?P<H>\d{2})"),
    ("mm", r"(?P<m>\d{2})"), ("ss", r"(?P<s>\d{2})"),
    ("SSSSSS", r"(?P<f6>\d{6})"), ("SSS", r"(?P<f3>\d{3})"),
]


def parse_timestamp_strings_with_format(col: Column, fmt: str,
                                        ansi_mode: bool = False) -> Column:
    """to_timestamp(str, fmt) with the common Java SimpleDateFormat tokens
    (cast_string.hpp parse_timestamp_strings_with_format)."""
    assert col.dtype.is_string
    pattern = ""
    i = 0
    while i < len(fmt):
        for tok, rx in _FORMAT_TOKENS:
            if fmt.startswith(tok, i):
                pattern += rx
                i += len(tok)
                break
        else:
            pattern += re.escape(fmt[i])
            i += 1
    rx = re.compile("^" + pattern + "$")
    vals = col.to_pylist()
    out = np.zeros(col.length, np.int64)
    valid = np.zeros(col.length, bool)
    for i, s in enumerate(vals):
        if s is None:
            continue
        m = rx.match(s.strip())
        if not m:
            continue
        g = m.groupdict()
        y = int(g.get("y") or 1970)
        mo = int(g.get("M") or 1)
        d = int(g.get("d") or 1)
        if not _valid_ymd(y, mo, d):
            continue
        hh = int(g.get("H") or 0)
        mm = int(g.get("m") or 0)
        ss = int(g.get("s") or 0)
        if not (hh < 24 and mm < 60 and ss < 60):
            continue
        frac = int(g.get("f6") or 0) + int(g.get("f3") or 0) * 1000
        days = _days_from_civil(y, mo, d)
        out[i] = (days * 86400 + hh * 3600 + mm * 60 + ss) * 1_000_000 \
            + frac
        valid[i] = True
    return _finish(col, vals, out, valid, dtypes.TIMESTAMP_MICROS,
                   ansi_mode)
