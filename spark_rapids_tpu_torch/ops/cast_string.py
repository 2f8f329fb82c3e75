"""CAST(string AS int/long/float/double/decimal) and back, with Spark
semantics.

Reference: src/main/cpp/src/cast_string.cu (string_to_integer_kernel
:163-250 -- whitespace/C0 stripping, optional +/- sign, digits with
per-step overflow detection, non-ANSI truncation at '.', trailing
whitespace tolerance) and cast_string_to_float.cu (sign, digits, decimal
point, e/E exponent, case-insensitive inf/infinity/nan).

The per-row character march is a DFA run for every row at once: one
loop over the padded char axis carrying (state, value, sign, ...) lanes
on the column's device.  ANSI mode surfaces the first failing row as
CastException (exception_with_row_index.hpp analog), fetching only that
row's bytes.

string_to_float and float_to_string route columns of at least
SPARK_RAPIDS_TPU_STOD_MIN_ROWS / _FTOS_MIN_ROWS rows (32) to their device
engines (ops/stod_device.py, ops/ftos_device.py); the host loops here
are the differential oracles (SPARK_RAPIDS_TPU_STOD=host|device and
SPARK_RAPIDS_TPU_FTOS=host|device override).  string_to_decimal and the
base conversions are host loops, as in the JAX package.  Every function
returns its column on its input column's device.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType, Kind
from spark_rapids_tpu_torch.columns.strbuild import host_row_bytes
from spark_rapids_tpu_torch.ops.exceptions import CastException

# DFA states for integer parsing
_S_LEAD = 0      # skipping leading whitespace / expecting sign or digit
_S_DIGITS = 1    # consuming digits
_S_TRUNC = 2     # after '.', consuming (and ignoring) fraction digits
_S_TRAIL = 3     # consuming trailing whitespace
_S_INVALID = 4


def _is_ws(c):
    return (c <= 0x1F) | (c == 0x20)


def _int_limits(dt: DType) -> Tuple[int, int]:
    info = np.iinfo(dt.np_dtype)
    return int(info.min), int(info.max)


def raise_first_bad(col: Column, bad: torch.Tensor) -> None:
    """CastException at the first True row of `bad`, carrying that row's
    string (only its bytes are copied to the host)."""
    rows = torch.nonzero(bad).squeeze(1)
    if rows.shape[0]:
        row = rows[:1]
        raise CastException(int(row[0]), host_row_bytes(col, row)[0]
                            .decode("utf-8", errors="replace"))


def string_to_integer(col: Column, dtype: DType, ansi_mode: bool = False,
                      strip: bool = True) -> Column:
    """Spark CAST(string AS integral) (CastStrings.toInteger:39)."""
    assert col.dtype.is_string
    rows = col.length
    dev = col.device
    if rows == 0:
        return Column(dtype, 0, data=torch.zeros(0, dtype=dtype.torch_dtype,
                                                 device=dev))
    chars, lens = col.to_padded_chars()
    p = chars.shape[1]
    chars_t = chars.t().contiguous()          # one contiguous row a step
    minval, maxval = _int_limits(dtype)
    signed_target = np.dtype(dtype.np_dtype).kind == "i"

    state = torch.where(lens > 0, _S_LEAD, _S_INVALID).to(torch.int32)
    value = torch.zeros(rows, dtype=torch.int64, device=dev)
    sign = torch.ones(rows, dtype=torch.int64, device=dev)
    seen_digit = torch.zeros(rows, dtype=torch.bool, device=dev)
    false = torch.zeros(rows, dtype=torch.bool, device=dev)

    for i in range(p):
        c = chars_t[i]
        in_range = i < lens
        ws = _is_ws(c)
        digit = (c >= 48) & (c <= 57)
        dval = (c - 48).to(torch.int64)       # uint8 wraps, as in the JAX

        # --- LEAD: optional whitespace*, then sign?, then first digit.
        # "sign consumed" is encoded by switching to DIGITS with
        # seen_digit=False; ending there (bare sign) is invalid.
        lead = state == _S_LEAD
        if signed_target:
            is_sign = (c == 43) | (c == 45)
        else:  # reference consumes signs only for signed types
            is_sign = false
        dot = c == 46
        stay_ws = (lead & ws) if strip else false
        take_sign = lead & is_sign
        new_sign = torch.where(take_sign & (c == 45), -1, sign)
        next_state = state
        next_state = torch.where(lead & stay_ws, _S_LEAD, next_state)
        next_state = torch.where(take_sign, _S_DIGITS, next_state)
        next_state = torch.where(lead & digit, _S_DIGITS, next_state)
        # '.' as the first body char truncates to 0 in non-ANSI mode
        # (cast_string.cu: the char loop treats '.' identically wherever
        # it appears, so "." / "+.5" are VALID zeros)
        next_state = torch.where(lead & dot & ~stay_ws,
                                 _S_INVALID if ansi_mode else _S_TRUNC,
                                 next_state)
        next_state = torch.where(
            lead & ~stay_ws & ~take_sign & ~digit & ~dot, _S_INVALID,
            next_state)

        # --- DIGITS
        in_digits = (state == _S_DIGITS) | (lead & digit)
        adding = new_sign > 0
        # value accumulation with overflow checks (cast_string.cu:122-150)
        ovf_mul = torch.where(adding, value > maxval // 10,
                              value < -((-minval) // 10))
        val10 = value * 10
        first = ~seen_digit
        base = torch.where(first, 0, val10)
        ovf_mul = torch.where(first, False, ovf_mul)
        ovf_add = torch.where(adding, base > maxval - dval,
                              base < minval + dval)
        new_value = torch.where(adding, base + dval, base - dval)
        overflow = in_digits & digit & in_range & (ovf_mul | ovf_add)

        take_digit = in_digits & digit & in_range
        value = torch.where(take_digit, new_value, value)
        seen_digit = seen_digit | take_digit

        next_state = torch.where(in_digits & digit, _S_DIGITS, next_state)
        # '.' truncates in non-ANSI mode; in ANSI mode it is invalid
        next_state = torch.where((state == _S_DIGITS) & dot,
                                 _S_INVALID if ansi_mode else _S_TRUNC,
                                 next_state)
        trail_ok = seen_digit if strip else false
        next_state = torch.where(
            (state == _S_DIGITS) & ws & trail_ok, _S_TRAIL, next_state)
        next_state = torch.where(
            (state == _S_DIGITS) & ~digit & ~dot & ~(ws & trail_ok),
            _S_INVALID, next_state)

        # --- TRUNC: digits ignored; whitespace moves to TRAIL (strip);
        # anything else invalid
        in_trunc = state == _S_TRUNC
        next_state = torch.where(in_trunc & digit, _S_TRUNC, next_state)
        if strip:
            next_state = torch.where(in_trunc & ws, _S_TRAIL, next_state)
        next_state = torch.where(in_trunc & ~digit & ~ws, _S_INVALID,
                                 next_state)
        if not strip:
            next_state = torch.where(in_trunc & ws, _S_INVALID, next_state)

        # --- TRAIL: only whitespace allowed
        in_trail = state == _S_TRAIL
        next_state = torch.where(in_trail & ~ws, _S_INVALID, next_state)

        next_state = torch.where(overflow, _S_INVALID, next_state)
        state = torch.where(in_range, next_state, state)
        sign = torch.where(in_range, new_sign, sign)

    # valid end states: digits seen, or truncated-at-dot (possibly with
    # trailing ws); LEAD (only ws/sign) and INVALID are not
    valid = (((state == _S_DIGITS) & seen_digit)
             | (state == _S_TRUNC) | (state == _S_TRAIL))
    base_valid = col.valid_mask()
    result = value.to(dtype.torch_dtype)

    if ansi_mode:
        raise_first_bad(col, base_valid & ~valid)
        return Column(dtype, rows, data=result, validity=col.validity)
    return Column(dtype, rows, data=result,
                  validity=(base_valid & valid).to(torch.uint8))


# ----------------------------------------------------------------- float


_STRIP = (b" \t\r\n\x0b\x0c\x00\x01\x02\x03\x04\x05\x06\x07\x08"
          b"\x0e\x0f\x10\x11\x12\x13\x14\x15\x16\x17\x18\x19"
          b"\x1a\x1b\x1c\x1d\x1e\x1f")


def _float_parse_one(s: bytes, np_dt):
    """(value, ok) for one stripped-input row -- the libc-exact oracle
    shared by the host loop and the device path's fallback rows."""
    t = s.strip(_STRIP)
    if not t:
        return 0.0, False
    body = t
    sign = 1.0
    had_sign = body[:1] in (b"+", b"-")
    if had_sign:
        if body[:1] == b"-":
            sign = -1.0
        body = body[1:]
    low = body.lower()
    if low in (b"inf", b"infinity"):
        return sign * np.inf, True
    if low == b"nan":
        # Spark rejects signed NaN ("+naN"/"-nAn" -> null,
        # castToFloatNanTest) but accepts signed Infinity
        return (np.nan, True) if not had_sign else (0.0, False)
    if b"_" in t:  # python float() extension Java/Spark don't have
        return 0.0, False
    try:
        v = float(t)
    except ValueError:
        return 0.0, False
    return np_dt(v), True


def _float_host_rows(raw_rows, is_f32: bool):
    """(bits int64 -- a float32's as its u32 value --, ok bool) for the
    given rows' bytes via the host oracle (ops/stod_device.py's fallback
    rows)."""
    np_dt = np.float32 if is_f32 else np.float64
    parsed = [_float_parse_one(s, np_dt) for s in raw_rows]
    ok = np.array([good for _, good in parsed], bool)
    vals = np.array([v if good else 0.0 for v, good in parsed], np_dt)
    if is_f32:
        return vals.view(np.uint32).astype(np.int64), ok
    return vals.view(np.int64), ok


def string_to_float(col: Column, dtype: DType = dtypes.FLOAT64,
                    ansi_mode: bool = False) -> Column:
    """Spark CAST(string AS float/double) (CastStrings.toFloat:66,
    cast_string_to_float.cu).  Columns above the routing threshold run
    the Eisel-Lemire device path (ops/stod_device.py) with per-row host
    fallback; this host loop is the differential oracle
    (SPARK_RAPIDS_TPU_STOD=host|device overrides)."""
    assert col.dtype.is_string
    from spark_rapids_tpu_torch.ops import stod_device

    if stod_device.use_device(col):
        return stod_device.string_to_float_device(col, dtype, ansi_mode)
    rows = col.length
    dev = col.device
    is_f32 = dtype.kind == Kind.FLOAT32
    np_dt = np.float32 if is_f32 else np.float64
    if rows == 0:
        return Column(dtype, 0, data=torch.zeros(
            0, dtype=dtype.torch_dtype, device=dev))

    chars_host = col.data.cpu().numpy().tobytes()
    offs = col.offsets.cpu().numpy()
    base_valid = col.valid_mask().cpu().numpy()
    out = np.zeros(rows, np_dt)
    valid = np.zeros(rows, bool)
    for i in range(rows):
        if not base_valid[i]:
            continue
        v, ok = _float_parse_one(chars_host[offs[i]:offs[i + 1]], np_dt)
        if ok:
            out[i] = v
            valid[i] = True

    if ansi_mode:
        raise_first_bad(col, torch.from_numpy(base_valid & ~valid))
        validity = col.validity
    else:
        validity = torch.from_numpy(valid.astype(np.uint8)).to(dev)
    return Column(dtype, rows, data=torch.from_numpy(out).to(dev),
                  validity=validity)


# ----------------------------------------------------------- float -> str


def _java_double_repr(v: float, is_f32: bool) -> str:
    """Java Double.toString / Float.toString formatting: shortest decimal
    that round-trips, plain notation for 1e-3 <= |v| < 1e7, otherwise
    E-notation with one leading digit (ftos_converter.cuh semantics)."""
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == 0.0:
        return "-0.0" if np.signbit(v) else "0.0"
    neg = v < 0
    a = -v if neg else v
    if is_f32:
        digits = np.format_float_scientific(
            np.float32(a), unique=True, trim="-").replace("e+0", "e+") \
            .replace("e-0", "e-")
    else:
        digits = np.format_float_scientific(a, unique=True, trim="-")
    # parse "d.ddde[+-]xx"
    mant, _, exp_s = digits.partition("e")
    exp = int(exp_s)
    mant = mant.replace(".", "")
    if -3 <= exp < 7:
        if exp >= 0:
            int_part = mant[:exp + 1].ljust(exp + 1, "0")
            frac = mant[exp + 1:] or "0"
            body = f"{int_part}.{frac}"
        else:
            body = "0." + "0" * (-exp - 1) + mant
    else:
        frac = mant[1:] or "0"
        body = f"{mant[0]}.{frac}E{exp}"
    return ("-" if neg else "") + body


def float_to_string(col: Column) -> Column:
    """Spark-compatible float->string (CastStrings.fromFloat:103).
    Columns above the routing threshold run the device Ryu digit engine
    (ops/ftos_device.py, the ftos_converter.cuh analog); this host path
    is the differential oracle (SPARK_RAPIDS_TPU_FTOS=host|device
    overrides)."""
    assert col.dtype.kind in (Kind.FLOAT32, Kind.FLOAT64)
    from spark_rapids_tpu_torch.ops import ftos_device

    if ftos_device.use_device(col):
        return ftos_device.float_to_string_device(col)
    host = col.data.cpu().numpy()
    is_f32 = col.dtype.kind == Kind.FLOAT32
    mask = col.valid_mask().cpu().numpy()
    vals = [
        _java_double_repr(float(host[i]), is_f32) if mask[i] else None
        for i in range(col.length)
    ]
    return Column.from_strings(vals, col.device)


# ------------------------------------------------------ string -> decimal

_DEC_RE_STRIP = re.compile(
    r"^[\x00-\x1f ]*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?"
    r"[\x00-\x1f ]*$")
_DEC_RE_NOSTRIP = re.compile(
    r"^([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?$")


def string_to_decimal(col: Column, precision: int, scale: int,
                      ansi_mode: bool = False,
                      strip: bool = True) -> Column:
    """Spark CAST(string AS DECIMAL(precision, scale))
    (cast_string.hpp:97 string_to_decimal; CastStrings.toDecimal):
    optional sign/decimal point/exponent, HALF_UP rounding to the target
    scale, null (or ANSI row error) when invalid or when the value does
    not fit `precision` digits.  Output type by precision: decimal32
    (<=9), decimal64 (<=18), else decimal128 -- cudf scale convention
    (negative = fractional digits)."""
    assert col.dtype.is_string
    vals = col.to_pylist()
    rx = _DEC_RE_STRIP if strip else _DEC_RE_NOSTRIP
    out = []
    for s in vals:
        if s is None:
            out.append(None)
            continue
        m = rx.match(s)
        if not m:
            out.append(None)
            continue
        sign_s, ipart, fpart, exp_s = m.groups()
        ipart = ipart or ""
        fpart = fpart or ""
        if not ipart and not fpart:
            out.append(None)
            continue
        digits = int((ipart + fpart) or "0")
        exp10 = (int(exp_s) if exp_s else 0) - len(fpart)
        # unscaled at target scale: value * 10^{-scale}
        shift = exp10 - scale
        # bound the power before computing it exactly: a hostile
        # exponent ("1e2147483647") must not allocate a gigabyte int
        ndig = len(str(abs(digits))) if digits else 0
        if digits == 0:
            shift = 0
        elif shift > precision:
            out.append(None)  # unscaled >= 10^shift > 10^precision
            continue
        elif shift < -(ndig + 1):
            digits, shift = 0, 0  # |value| < 0.1 -> rounds to 0
        if shift >= 0:
            unscaled = digits * 10**shift
        else:
            d = 10 ** (-shift)
            unscaled = (2 * digits + d) // (2 * d)  # HALF_UP (positive)
        if sign_s == "-":
            unscaled = -unscaled
        if abs(unscaled) >= 10**precision:
            out.append(None)  # doesn't fit the requested precision
            continue
        out.append(unscaled)
    base_valid = col.valid_mask().cpu().numpy()
    computed = np.array([v is not None for v in out], bool)
    if ansi_mode:
        bad = base_valid & ~computed
        if bad.any():
            row = int(np.argmax(bad))
            raise CastException(row, vals[row])
    if precision <= 9:
        dt = dtypes.decimal32(scale)
    elif precision <= 18:
        dt = dtypes.decimal64(scale)
    else:
        dt = dtypes.decimal128(scale)
    return Column.from_pylist(out, dt, col.device)


# ------------------------------------------- integer <-> string with base

def string_to_integers_with_base(col: Column, base: int,
                                 ansi_mode: bool = False,
                                 dtype: DType = dtypes.UINT64) -> Column:
    """CastStrings.toIntegersWithBase(:134) -- the string leg of Spark
    conv(): trim ASCII spaces, optional '-', longest valid-digit prefix
    in `base`; no digits -> 0 (still a valid row), negatives wrap to
    unsigned, overflow clamps to 2^64-1.  Matches baseDec2Hex/baseHex2Dec
    test vectors (CastStringsTest.java:430-560)."""
    from spark_rapids_tpu_torch.ops.strings_misc import parse_base_prefix

    assert col.dtype.is_string
    if not (2 <= base <= 36):
        raise ValueError(f"unsupported base {base}")
    np_dt = np.dtype(dtype.np_dtype)
    bits = np_dt.itemsize * 8
    signed = np_dt.kind == "i"
    out = []
    for s in col.to_pylist():
        if s is None:
            out.append(None)
            continue
        t = s.lstrip(" \t\n\r\f\v")
        if not t:
            # rows matching ^\s*$ are NULL (CastStringJni.cpp:234-240),
            # unlike no-digit junk which yields 0
            out.append(None)
            continue
        val, overflow = parse_base_prefix(t, base)
        if overflow and ansi_mode:
            raise CastException(len(out), s)
        val &= (1 << bits) - 1
        if signed and val >= 1 << (bits - 1):
            val -= 1 << bits
        out.append(val)
    return Column.from_pylist(out, dtype, col.device)


def integers_with_base_to_string(col: Column, base: int) -> Column:
    """CastStrings.fromIntegersWithBase(:158): base 10 renders the value
    as-is (signed for signed dtypes); base 16 renders the two's-complement
    bits of the column's width, uppercase, no leading zeros
    ([123,-1] int32 -> ['7B','FFFFFFFF'])."""
    if base not in (10, 16):
        raise ValueError("only base 10 and 16 are supported")
    np_dt = np.dtype(col.dtype.np_dtype)
    bits = np_dt.itemsize * 8
    out = []
    for v in col.to_pylist():
        if v is None:
            out.append(None)
        elif base == 10:
            out.append(str(v))
        else:
            out.append(format(int(v) & ((1 << bits) - 1), "X"))
    return Column.from_strings(out, col.device)
