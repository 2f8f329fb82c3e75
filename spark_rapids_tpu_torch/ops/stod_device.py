"""Device string->float conversion (reference cast_string_to_float.cu:
57-235 -- device correctly-rounded strtod).

Two stages on the column's device, with a per-row host fallback for the
rare rows they cannot decide:

  1. a DFA loop over the padded char axis parses sign, mantissa (first
     19 significant digits into one u64 lane), decimal point, exponent,
     and the Spark validity rules; inf/nan keywords are matched by
     direct compares at each row's bounds.
  2. the Eisel-Lemire algorithm converts (w, q) -> IEEE bits in pure u64
     integer ops: normalize w, one 64x64->128 multiply with a
     128-bit-truncated power-of-ten significand (table generated at
     import with exact big-int arithmetic), exponent bookkeeping, and
     round-half-even with explicit ambiguity detection.

A u64 rides in the int64 with the same bits (utils/u64math.py): a
19-digit mantissa past 2^63 reads as negative there, so every right
shift of a value that can have its top bit set is a logical one.

Fallback rows (truncated >19-digit mantissas, results in the subnormal
range, products whose low bits make rounding ambiguous, possible
round-even ties) are found with one `nonzero`; only their bytes go to the
host libc path, bit-exact by construction, and only their bits come back.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType, Kind
from spark_rapids_tpu_torch.columns.strbuild import host_row_bytes
from spark_rapids_tpu_torch.utils.u64math import clz64, shr, umul128

DEVICE_MIN_ROWS = int(os.environ.get("SPARK_RAPIDS_TPU_STOD_MIN_ROWS",
                                     32))

Q_MIN, Q_MAX = -342, 308

# the last string_to_float_device call: its padded width, the DFA steps
# it ran and the rows it sent to the host parse
LAST_CALL = {"width": 0, "scan_steps": 0, "fallback_rows": 0}


def use_device(col: Column) -> bool:
    mode = os.environ.get("SPARK_RAPIDS_TPU_STOD", "auto")
    if mode == "host":
        return False
    return mode == "device" or col.length >= DEVICE_MIN_ROWS


def _gen_pow10_hi() -> np.ndarray:
    """Top 64 bits of the normalized 128-bit significand of 10^q for
    q in [Q_MIN, Q_MAX] (truncated, as Eisel-Lemire expects), as the
    int64s with the same bits."""
    out = np.zeros(Q_MAX - Q_MIN + 1, np.uint64)
    for q in range(Q_MIN, Q_MAX + 1):
        if q >= 0:
            v = 10 ** q
            shift = v.bit_length() - 128
            t = v >> shift if shift >= 0 else v << -shift
        else:
            # floor(2^k / 10^-q) normalized to 128 bits
            d = 10 ** (-q)
            k = d.bit_length() + 127
            t = (1 << k) // d
            if t.bit_length() == 129:   # can land one bit high
                t >>= 1
        assert t.bit_length() == 128
        out[q - Q_MIN] = t >> 64
    return out.view(np.int64)


_POW10_HI = _gen_pow10_hi()
_TABLES = {}


def _pow10_hi(device) -> torch.Tensor:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(_POW10_HI).to(device)
    return _TABLES[key]


def _eisel_lemire(w, q, is_f32: bool):
    """(bits u64 without sign, ok bool).  ok=False rows need the host
    fallback; w==0 handled by the caller."""
    mant_bits = 23 if is_f32 else 52
    kept = mant_bits + 2                     # mantissa + round bit
    drop = 64 - kept - 1                     # shift when upperbit==0
    exp_bias = 127 if is_f32 else 1023
    exp_max = 255 if is_f32 else 2047

    in_range = (q >= Q_MIN) & (q <= Q_MAX)
    qc = q.clamp(Q_MIN, Q_MAX)
    t_hi = _pow10_hi(w.device)[(qc - Q_MIN).to(torch.int64)]
    l = clz64(w)
    wn = w << (l.to(torch.int64) & 63)
    lo, hi = umul128(wn, t_hi)
    upper = shr(hi, 63).to(torch.int32)
    s = shr(hi, (upper + drop).to(torch.int64))  # kept+1 bits incl. round
    # floor(q*log2(10)): exact for |q| <= 1650; +63 accounts for the
    # [2^63, 2^64) normalization of both operands
    powq = ((217706 * qc) >> 16) + 63
    e = powq + upper - l + exp_bias
    m = (s + (s & 1)) >> 1                   # round half up (ties fixed
    #                                          below / via fallback)
    carried = (m >> (mant_bits + 1)) != 0
    m = torch.where(carried, m >> 1, m)
    e = e + carried.to(torch.int32)

    # bits strictly below the round bit: drop of them when upperbit=0,
    # drop+1 when upperbit=1.  All-ones -> the truncated table may hide
    # a carry (ambiguous); all-zeros with round=1, kept-lsb=0 and a zero
    # low product word -> possible exact half (tie).  Both fall back.
    low_mask = (torch.ones_like(hi) << (drop + upper).to(torch.int64)) - 1
    ambiguous = (hi & low_mask) == low_mask
    tie = ((s & 3) == 1) & (lo == 0) & ((hi & low_mask) == 0)
    subnormal = e <= 0
    overflow = e >= exp_max
    ok = in_range & ~ambiguous & ~tie & ~subnormal & ~overflow
    bits = (m & ((1 << mant_bits) - 1)) \
        | (e.clamp(0, exp_max).to(torch.int64) << mant_bits)
    # out-of-range exponents resolve exactly: q too small -> 0,
    # q too large -> inf
    bits = torch.where(q < Q_MIN, 0, bits)
    bits = torch.where(q > Q_MAX, exp_max << mant_bits, bits)
    ok = ok | (q < Q_MIN) | (q > Q_MAX)
    return bits, ok


# ------------------------------------------------------------- parsing


def _is_ws(c):
    return (c <= 0x1F) | (c == 0x20)


def _lower(c):
    return torch.where((c >= 65) & (c <= 90), c + 32, c)


def _parse_scan(chars, start, end, steps):
    """Numeric grammar DFA over the first `steps` chars (python float
    grammar minus '_': [sign] (d+[.d*] | .d+) [eE [sign] d+]).  Returns
    mantissa/exponent lanes + flags."""
    rows = chars.shape[0]
    S_SIGN, S_INT, S_FRAC, S_ESIGN, S_EXP, S_BAD = 0, 1, 2, 3, 4, 5
    dev = chars.device
    chars_t = chars.t().contiguous()
    zi = torch.zeros(rows, dtype=torch.int32, device=dev)
    zb = torch.zeros(rows, dtype=torch.bool, device=dev)
    st, nsig, frac_kept, int_drop, exp = zi, zi, zi, zi, zi
    mant = torch.zeros(rows, dtype=torch.int64, device=dev)
    dropped_nz, eneg, neg, saw_digit, saw_edigit = zb, zb, zb, zb, zb
    for j in range(steps):
        c = chars_t[j]
        active = (j >= start) & (j < end)
        digit = (c >= 48) & (c <= 57)
        d = (c - 48).to(torch.int64)          # uint8 wraps, as in the JAX
        is_dot = c == 46
        is_e = _lower(c) == 101
        is_sign = (c == 43) | (c == 45)

        # transitions
        ns = st
        ns = torch.where((st == S_SIGN) & is_sign, S_INT, ns)
        ns = torch.where((st == S_SIGN) & digit, S_INT, ns)
        ns = torch.where((st == S_SIGN) & is_dot, S_FRAC, ns)
        ns = torch.where((st == S_INT) & is_dot, S_FRAC, ns)
        ns = torch.where((st == S_INT) & is_e & saw_digit, S_ESIGN, ns)
        ns = torch.where((st == S_FRAC) & is_e & saw_digit, S_ESIGN, ns)
        ns = torch.where((st == S_ESIGN) & (is_sign | digit), S_EXP, ns)
        bad = ((st == S_SIGN) & ~(is_sign | digit | is_dot)) \
            | ((st == S_INT) & ~(digit | is_dot | (is_e & saw_digit))) \
            | ((st == S_FRAC) & ~(digit | (is_e & saw_digit))) \
            | ((st == S_ESIGN) & ~(is_sign | digit)) \
            | ((st == S_EXP) & ~digit)
        ns = torch.where(bad, S_BAD, ns)
        ns = torch.where(active, ns, st)

        in_mant = active & digit & ((st == S_SIGN) | (st == S_INT)
                                    | (st == S_FRAC))
        sig = in_mant & ((mant != 0) | (d != 0))
        keep = sig & (nsig < 19)
        mant = torch.where(keep, mant * 10 + d, mant)   # wraps as u64
        nsig = nsig + sig.to(torch.int32)
        frac_kept = frac_kept + (keep & (st == S_FRAC)).to(torch.int32)
        int_drop = int_drop + (sig & ~keep
                               & (st != S_FRAC)).to(torch.int32)
        dropped_nz = dropped_nz | (sig & ~keep & (d != 0))
        # leading zeros in the fraction scale the exponent even though
        # they are not significant
        frac_kept = frac_kept + ((st == S_FRAC) & in_mant & ~sig
                                 ).to(torch.int32)
        saw_digit = saw_digit | in_mant
        neg = neg | (active & (st == S_SIGN) & (c == 45))
        eneg = eneg | (active & (st == S_ESIGN) & (c == 45))
        in_exp = active & digit & ((st == S_ESIGN) | (st == S_EXP))
        exp = torch.where(in_exp,
                          torch.clamp(exp * 10 + d.to(torch.int32),
                                      max=100000),
                          exp)
        saw_edigit = saw_edigit | in_exp
        st = ns
    # terminal validity: digits seen, not stuck in a bad/e-dangling state
    valid = saw_digit & (st != S_BAD) \
        & ~((st == S_ESIGN) | ((st == S_EXP) & ~saw_edigit))
    q = torch.where(eneg, -exp, exp) + int_drop - frac_kept
    return mant, q, neg, valid, nsig, dropped_nz


def _first_true(m):
    """Index of the first True in each row of a bool matrix (0 where
    none): argmax over uint8, which has a CUDA kernel and keeps the
    first of ties."""
    return torch.argmax(m.to(torch.uint8), dim=1).to(torch.int32)


def _strip_bounds(chars, lens):
    rows, L = chars.shape
    j = torch.arange(L, dtype=torch.int32, device=chars.device)[None, :]
    inrow = j < lens[:, None]
    nonws = ~(_is_ws(chars) | ~inrow)
    any_nonws = nonws.any(dim=1)
    start = _first_true(nonws)
    end = L - _first_true(nonws.flip(1))
    return torch.where(any_nonws, start, 0), \
        torch.where(any_nonws, end, 0)


def _keyword_scan(chars, start, end):
    """(is_inf, is_nan, kw_neg, kw_signed) after optional sign at
    start: 'inf'/'infinity'/'nan' case-insensitive."""
    rows, L = chars.shape
    ridx = torch.arange(rows, device=chars.device)

    def char_at(pos):
        return _lower(chars[ridx, pos.clamp(0, L - 1).to(torch.int64)])

    c0 = char_at(start)
    signed = (c0 == 43) | (c0 == 45)
    kw_neg = c0 == 45
    s = start + signed.to(torch.int32)
    n = end - s

    def matches(word: bytes):
        m = n == len(word)
        for k, ch in enumerate(word):
            m = m & (char_at(s + k) == ch)
        return m

    is_inf = matches(b"inf") | matches(b"infinity")
    is_nan = matches(b"nan")
    return is_inf, is_nan, kw_neg, signed


def _narrow_to_f32(bits64):
    """f64 bits -> f32 bits, round-half-even, in exact integer ops
    (the same narrowing the host path applies after its f64 parse, so
    both paths double-round identically).  Subnormal f32 results are
    flagged for the host fallback."""
    exp64 = (shr(bits64, 52) & 0x7FF).to(torch.int32)
    mant = bits64 & ((1 << 52) - 1)
    sign = shr(bits64, 63) << 31
    is_special = exp64 == 0x7FF                    # inf / nan
    e32 = exp64 - 1023 + 127
    m53 = mant | (1 << 52)
    dropped = m53 & ((1 << 29) - 1)
    m24 = m53 >> 29
    half = 1 << 28
    round_up = (dropped > half) | ((dropped == half) & ((m24 & 1) == 1))
    m24 = m24 + round_up.to(torch.int64)
    carried = (m24 >> 24) != 0
    m24 = torch.where(carried, m24 >> 1, m24)
    e32 = e32 + carried.to(torch.int32)
    overflow = (e32 >= 255) & ~is_special
    # f32-subnormal results AND f64-subnormal inputs go to the fallback:
    # the clip-to-1 + forced hidden bit below would fabricate a normal f32
    # for an exp64==0 input, so such rows must never take the device value.
    need_fb = ((e32 <= 0) & (exp64 != 0)) | ((exp64 == 0) & (mant != 0))
    out = (m24 & ((1 << 23) - 1)) \
        | (e32.clamp(1, 254).to(torch.int64) << 23)
    out = torch.where(overflow, 0xFF << 23, out)
    out = torch.where(is_special,
                      (0xFF << 23) | torch.where(mant != 0, 1 << 22, 0),
                      out)
    out = torch.where((exp64 == 0) & (mant == 0), 0, out)
    need_fb = need_fb & ~is_special
    return out | sign, need_fb


def string_to_float_device(col: Column, dtype: DType,
                           ansi_mode: bool = False) -> Column:
    """Device path of cast_string.string_to_float (same output)."""
    from spark_rapids_tpu_torch.ops.cast_string import (
        _float_host_rows, raise_first_bad)

    assert col.dtype.is_string
    rows = col.length
    is_f32 = dtype.kind == Kind.FLOAT32
    chars, lens = col.to_padded_chars()
    start, end = _strip_bounds(chars, lens)
    empty = end <= start
    is_inf, is_nan, kw_neg, kw_signed = _keyword_scan(chars, start, end)
    # steps past the last row's stripped end change no lane
    width = chars.shape[1]
    steps = min(width, int(end.max())) if rows else 0
    mant, q, neg, valid, nsig, dropped_nz = _parse_scan(chars, start, end,
                                                        steps)
    del chars

    bits, ok = _eisel_lemire(mant, q, False)
    need_fb = valid & ~ok & (mant != 0)
    need_fb = need_fb | (valid & dropped_nz)

    bits = torch.where(mant == 0, 0, bits)
    inf_bits = 0x7FF << 52
    nan_bits = inf_bits | (1 << 51)
    bits = torch.where(is_inf, inf_bits, bits)
    # Spark rejects signed NaN but accepts signed Infinity
    bits = torch.where(is_nan & ~kw_signed, nan_bits, bits)
    out_valid = (valid | is_inf | (is_nan & ~kw_signed)) & ~empty
    bits = bits | ((neg | (is_inf & kw_neg)).to(torch.int64) << 63)
    if is_f32:
        bits, narrow_fb = _narrow_to_f32(bits)
        need_fb = need_fb | (valid & narrow_fb)

    valid_out = out_valid & col.valid_mask()
    fb_idx = torch.nonzero(need_fb & valid_out).squeeze(1)
    LAST_CALL.update(width=width, scan_steps=steps,
                     fallback_rows=int(fb_idx.shape[0]))
    if fb_idx.shape[0]:
        host_bits, host_ok = _float_host_rows(
            host_row_bytes(col, fb_idx), is_f32)
        bits[fb_idx] = torch.from_numpy(host_bits).to(bits.device)
        valid_out[fb_idx] = torch.from_numpy(host_ok).to(bits.device)

    if is_f32:
        data = (bits & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    else:
        data = bits.view(torch.float64)
    if ansi_mode:
        raise_first_bad(col, col.valid_mask() & ~valid_out)
        validity = col.validity
    else:
        validity = valid_out.to(torch.uint8)
    return Column(dtype, rows, data=data, validity=validity)
