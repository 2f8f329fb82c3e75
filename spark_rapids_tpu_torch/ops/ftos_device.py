"""Device float->string digit engine (reference: ftos_converter.cuh,
1,493 LoC of device Ryu; CastStrings.fromFloat:103).

Shortest-round-trip decimal conversion (the published Ryu algorithm) in
lane-per-row u64 arithmetic on the column's device:

  * the float decomposes into (mantissa, exponent); three scaled
    candidates vm < vr < vp bracket the value's rounding interval
  * one 128-bit multiply per candidate by a precomputed power-of-5
    (or inverse) table entry converts to the decimal domain; the table
    is generated at import with exact Python big-int arithmetic
  * a masked fixed-trip loop strips digits while the whole interval
    agrees, with the tie/trailing-zero refinements that make the result
    exactly the shortest representation that round-trips
  * digits + decimal exponent render into Java's Double.toString /
    Float.toString layout (plain for 1e-3 <= |v| < 1e7, else E-notation),
    one output byte position at a time over all rows, then one masked
    select into the chars buffer and a device cumsum for the offsets.

A u64 rides in the int64 with the same bits (utils/u64math.py).  The
candidates, digits and strip-loop operands of a finite nonzero value stay
below 2^63 (the decimal candidates are under 100 * 2^55), so their
compares, `// 10` and `% 5` are the signed ones; the 128-bit products
inside _mul_shift64 use the unsigned helpers.  Rows whose bytes are not
rendered from digits (zeros, NaN, infinities, nulls) may compute other
digits in their lanes than the reference's u64 lanes; their output is a
constant or nothing, as in the reference.

The host path (cast_string._java_double_repr) is the differential oracle.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.utils.u64math import M32, shr, ult, umul128

DEVICE_MIN_ROWS = int(os.environ.get("SPARK_RAPIDS_TPU_FTOS_MIN_ROWS",
                                     32))


def use_device(col: Column) -> bool:
    mode = os.environ.get("SPARK_RAPIDS_TPU_FTOS", "auto")
    if mode == "host":
        return False
    return mode == "device" or col.length >= DEVICE_MIN_ROWS


# ------------------------------------------------------------- tables
# Exact big-int generation (ryu d2s_full_table shapes): for e2 >= 0 the
# inverse table INV[q] ~ 2^j / 5^q rounded up; for e2 < 0 the table
# P5[i] = top bits of 5^i.  125-bit significands, split into lo/hi u64
# (held as the int64s with the same bits).

_B_INV = 125   # bits kept of 2^j/5^q  (double)
_B_POW = 125   # bits kept of 5^i      (double)
_FB_INV = 59   # float tables are single u64 entries
_FB_POW = 61


def _pow5bits(e):
    return ((e * 1217359) >> 19) + 1


def _gen_double_tables():
    inv = np.zeros((292, 2), np.uint64)
    for q in range(292):
        j = _pow5bits(q) - 1 + _B_INV
        v = (1 << j) // (5 ** q) + 1
        inv[q, 0] = v & ((1 << 64) - 1)
        inv[q, 1] = v >> 64
    p5 = np.zeros((326, 2), np.uint64)
    for i in range(326):
        shift = _pow5bits(i) - _B_POW
        v = (5 ** i) >> shift if shift >= 0 else (5 ** i) << -shift
        p5[i, 0] = v & ((1 << 64) - 1)
        p5[i, 1] = v >> 64
    return inv.view(np.int64), p5.view(np.int64)


def _gen_float_tables():
    inv = np.zeros(31, np.uint64)
    for q in range(31):
        j = _pow5bits(q) - 1 + _FB_INV
        inv[q] = (1 << j) // (5 ** q) + 1
    # i = -e2 - q reaches 48 at the deepest f32 subnormal (e2 = -151,
    # with the corrected q = log10Pow5(151) - 1)
    p5 = np.zeros(49, np.uint64)
    for i in range(49):
        shift = _pow5bits(i) - _FB_POW
        p5[i] = (5 ** i) >> shift if shift >= 0 else (5 ** i) << -shift
    return inv.view(np.int64), p5.view(np.int64)


_D_INV, _D_POW5 = _gen_double_tables()
_F_INV, _F_POW5 = _gen_float_tables()

# 10^0 .. 10^19; 10^19 is past 2^63, so digit counts compare unsigned
_POW10_U64 = np.array([10 ** k for k in range(20)], np.uint64) \
    .view(np.int64)

_TABLES = {}


def _table(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(globals()[name]).to(device)
    return _TABLES[key]


def _log10_pow2(e):
    # floor(log10(2^e)) for 0 <= e <= 1650
    return (e * 78913) >> 18


def _log10_pow5(e):
    # floor(log10(5^e)) for 0 <= e <= 2620
    return (e * 732923) >> 20


# --------------------------------------------------- 128-bit primitives


def _mul_shift64(m, mul_lo, mul_hi, j):
    """floor((m * (mul_hi:mul_lo)) / 2^j) for 64 < j < 128+64, result
    fitting u64 (ryu mulShift64)."""
    b0_lo, b0_hi = umul128(m, mul_lo)
    b2_lo, b2_hi = umul128(m, mul_hi)
    s_mid = b0_hi + b2_lo
    carry = ult(s_mid, b0_hi).to(torch.int64)
    s_hi = b2_hi + carry
    jj = (j - 64) & 63
    # j - 64 in (0, 64): combine mid and hi
    return shr(s_mid, jj) | torch.where(jj == 0, 0,
                                        s_hi << ((64 - jj) & 63))


def _pow5_factor_ge(value, p):
    """value divisible by 5^p?  (p <= 23 suffices for doubles)."""
    v = value
    count = torch.zeros_like(value, dtype=torch.int32)
    for _ in range(24):
        div = v // 5
        is_mult = div * 5 == v
        take = is_mult & (count < 24)
        v = torch.where(take, div, v)
        count = count + take.to(torch.int32)
    return count >= p


def _multiple_of_pow2(value, p):
    mask = torch.where(p >= 64, -1, (1 << (p & 63)) - 1)
    return (value & mask) == 0


def _strip(vr, vp, vm, vm_trail, vr_trail, trips):
    """Ryu's digit-stripping loops, masked to a fixed trip count:
    (vr, vm, last, removed, vr_trail) after removing the digits the
    whole interval agrees on, and the trailing zeros of vm where vm
    is exact."""
    last = torch.zeros_like(vr)
    removed = torch.zeros_like(vr, dtype=torch.int32)
    for _ in range(trips):
        cond = (vp // 10) > (vm // 10)
        vm_trail = torch.where(cond, vm_trail & ((vm % 10) == 0),
                               vm_trail)
        vr_trail = torch.where(cond, vr_trail & (last == 0), vr_trail)
        last = torch.where(cond, vr % 10, last)
        vr = torch.where(cond, vr // 10, vr)
        vp = torch.where(cond, vp // 10, vp)
        vm = torch.where(cond, vm // 10, vm)
        removed = removed + cond.to(torch.int32)

    vr2, vm2, last2, removed2, vr_trail2 = vr, vm, last, removed, vr_trail
    for _ in range(trips):
        cond = (vm2 % 10) == 0
        vr_trail2 = torch.where(cond, vr_trail2 & (last2 == 0), vr_trail2)
        last2 = torch.where(cond, vr2 % 10, last2)
        vr2 = torch.where(cond, vr2 // 10, vr2)
        vm2 = torch.where(cond, vm2 // 10, vm2)
        removed2 = removed2 + cond.to(torch.int32)
    use2 = vm_trail
    return (torch.where(use2, vr2, vr), torch.where(use2, vm2, vm),
            torch.where(use2, last2, last),
            torch.where(use2, removed2, removed),
            torch.where(use2, vr_trail2, vr_trail), vm_trail)


def _round(vr, vm, last, removed, vr_trail, vm_trail, accept, e10):
    # round-even on exact ties
    tie = vr_trail & (last == 5) & ((vr % 2) == 0)
    last = torch.where(tie, 4, last)
    need_up = ((vr == vm) & (~accept | ~vm_trail)) | (last >= 5)
    return vr + need_up.to(torch.int64), (e10 + removed).to(torch.int32)


# --------------------------------------------------------- core (f64)


def _d2d(bits: torch.Tensor):
    """Shortest-decimal core for f64 raw bits (sign handled by caller).
    Returns (digits u64, e10 int32) for finite nonzero inputs."""
    dev = bits.device
    mant = bits & ((1 << 52) - 1)
    expo = shr(bits, 52) & 0x7FF
    is_sub = expo == 0
    m2 = torch.where(is_sub, mant, mant | (1 << 52))
    e2 = torch.where(is_sub, 1, expo) - 1075 - 2
    accept = (m2 & 1) == 0                     # even mantissa
    mm_shift = ((mant != 0) | (expo <= 1)).to(torch.int64)
    mv = m2 * 4
    mp = mv + 2
    mm = mv - 1 - mm_shift

    # ---- decimal-domain candidates, both e2 branches computed & merged
    pos = e2 >= 0
    e2p = e2.clamp(min=0)
    q_pos = (_log10_pow2(e2p) - (e2p > 3).to(torch.int64)).clamp(min=0)
    k_pos = _B_INV + _pow5bits(q_pos) - 1
    i_pos = -e2p + q_pos + k_pos
    inv = _table("_D_INV", dev)[q_pos.clamp(0, _D_INV.shape[0] - 1)]
    vr_p = _mul_shift64(mv, inv[:, 0], inv[:, 1], i_pos)
    vp_p = _mul_shift64(mp, inv[:, 0], inv[:, 1], i_pos)
    vm_p = _mul_shift64(mm, inv[:, 0], inv[:, 1], i_pos)
    e10_p = q_pos
    qp_small = q_pos <= 21
    mv5_ok = (mv % 5) == 0
    vr_t_p = qp_small & _pow5_factor_ge(mv, q_pos) & mv5_ok
    vm_t_p = qp_small & _pow5_factor_ge(mm, q_pos) & ~mv5_ok & accept
    vp_adj_p = qp_small & _pow5_factor_ge(mp, q_pos) & ~mv5_ok & ~accept

    e2n = e2.clamp(max=0)
    nq = (_log10_pow5(-e2n) - ((-e2n) > 1).to(torch.int64)).clamp(min=0)
    e10_n = nq + e2n
    i_neg = (-e2n - nq).clamp(min=0)
    k_neg = _pow5bits(i_neg) - _B_POW
    j_neg = nq - k_neg
    p5 = _table("_D_POW5", dev)[i_neg.clamp(0, _D_POW5.shape[0] - 1)]
    vr_n = _mul_shift64(mv, p5[:, 0], p5[:, 1], j_neg)
    vp_n = _mul_shift64(mp, p5[:, 0], p5[:, 1], j_neg)
    vm_n = _mul_shift64(mm, p5[:, 0], p5[:, 1], j_neg)
    small = nq <= 1
    # (q<=1: mv=4m2 has >=2 factors of 2, so vr is exact)
    vr_t_n = small | ((nq < 63) & _multiple_of_pow2(mv, nq))
    vm_t_n = torch.where(small, accept & (mm_shift == 1),
                         (nq < 63) & _multiple_of_pow2(mm, nq))
    # ryu: for q<=1, vp trailing-adjust when !acceptBounds
    vp_adj_n = small & ~accept

    vr = torch.where(pos, vr_p, vr_n)
    vp = torch.where(pos, vp_p, vp_n)
    vm = torch.where(pos, vm_p, vm_n)
    e10 = torch.where(pos, e10_p, e10_n)
    vr_trail = torch.where(pos, vr_t_p, vr_t_n)
    vm_trail = torch.where(pos, vm_t_p, vm_t_n)
    vp = vp - torch.where(pos, vp_adj_p, vp_adj_n).to(torch.int64)

    vr, vm, last, removed, vr_trail, vm_trail = _strip(
        vr, vp, vm, vm_trail, vr_trail, 19)
    return _round(vr, vm, last, removed, vr_trail, vm_trail, accept, e10)


def _f2d(bits32: torch.Tensor):
    """Shortest-decimal core for f32 raw bits (in int64 lanes)."""
    dev = bits32.device
    b = bits32
    mant = b & ((1 << 23) - 1)
    expo = (b >> 23) & 0xFF
    is_sub = expo == 0
    m2 = torch.where(is_sub, mant, mant | (1 << 23))
    e2 = torch.where(is_sub, 1, expo) - 150 - 2
    accept = (m2 & 1) == 0
    mm_shift = ((mant != 0) | (expo <= 1)).to(torch.int64)
    mv = m2 * 4
    mp = mv + 2
    mm = mv - 1 - mm_shift

    def mul_shift32(m, factor, shift):
        # m < 2^26, factor < 2^64, shift in (32, 96)
        f_hi = shr(factor, 32)
        f_lo = factor & M32
        hi = m * f_hi
        lo = m * f_lo
        s = hi + shr(lo, 32)
        return shr(s, (shift - 32) & 63)

    # d2d-style q (one smaller than the naive log10): guarantees the
    # strip loop removes >= 1 digit whenever q >= 1, so no separate
    # last-removed-digit patch is needed (same argument as _d2d)
    pos = e2 >= 0
    e2p = e2.clamp(min=0)
    q_pos = (_log10_pow2(e2p) - (e2p > 3).to(torch.int64)).clamp(min=0)
    k_pos = _FB_INV + _pow5bits(q_pos) - 1
    i_pos = -e2p + q_pos + k_pos
    finv = _table("_F_INV", dev)[q_pos.clamp(0, _F_INV.shape[0] - 1)]
    vr_p = mul_shift32(mv, finv, i_pos)
    vp_p = mul_shift32(mp, finv, i_pos)
    vm_p = mul_shift32(mm, finv, i_pos)
    e10_p = q_pos
    # mv < 2^26 so 5^q | mv is only possible for q <= 11
    qp_small = q_pos <= 11
    mv5_ok = (mv % 5) == 0
    vr_t_p = qp_small & mv5_ok & _pow5_factor_ge(mv, q_pos)
    vm_t_p = qp_small & _pow5_factor_ge(mm, q_pos) & ~mv5_ok & accept
    vp_adj_p = qp_small & _pow5_factor_ge(mp, q_pos) & ~mv5_ok & ~accept

    e2n = e2.clamp(max=0)
    nq = (_log10_pow5(-e2n) - ((-e2n) > 1).to(torch.int64)).clamp(min=0)
    e10_n = nq + e2n
    i_neg = (-e2n - nq).clamp(min=0)
    k_neg = _pow5bits(i_neg) - _FB_POW
    j_neg = nq - k_neg
    fp5 = _table("_F_POW5", dev)[i_neg.clamp(0, _F_POW5.shape[0] - 1)]
    vr_n = mul_shift32(mv, fp5, j_neg)
    vp_n = mul_shift32(mp, fp5, j_neg)
    vm_n = mul_shift32(mm, fp5, j_neg)
    small = nq <= 1
    # vr = mv*5^i/2^q is an integer (no nonzero digit dropped by the
    # scaling) iff 2^q divides mv
    vr_t_n = small | _multiple_of_pow2(mv, nq)
    vm_t_n = torch.where(small, accept & (mm_shift == 1),
                         _multiple_of_pow2(mm, nq))
    vp_adj_n = small & ~accept

    vr = torch.where(pos, vr_p, vr_n)
    vp = torch.where(pos, vp_p, vp_n)
    vm = torch.where(pos, vm_p, vm_n)
    e10 = torch.where(pos, e10_p, e10_n)
    vr_trail = torch.where(pos, vr_t_p, vr_t_n)
    vm_trail = torch.where(pos, vm_t_p, vm_t_n)
    vp = vp - torch.where(pos, vp_adj_p, vp_adj_n).to(torch.int64)

    vr, vm, last, removed, vr_trail, vm_trail = _strip(
        vr, vp, vm, vm_trail, vr_trail, 11)
    return _round(vr, vm, last, removed, vr_trail, vm_trail, accept, e10)


# ------------------------------------------------------------- layout

_MAXW = 32          # widest Java rendering fits comfortably
_ND = 17            # most digits of a shortest double
# the constant renderings: none, NaN, Infinity, -Infinity, 0.0, -0.0
_SPECIALS = [b"", b"NaN", b"Infinity", b"-Infinity", b"0.0", b"-0.0"]
_SPECIAL_BYTES = np.zeros((len(_SPECIALS), _MAXW), np.uint8)
for _k, _s in enumerate(_SPECIALS):
    _SPECIAL_BYTES[_k, :len(_s)] = np.frombuffer(_s, np.uint8)
_SPECIAL_LENS = np.array([len(s) for s in _SPECIALS], np.int32)


def _render(bits64: torch.Tensor, is_f32: bool):
    """(bytes (rows, W) uint8, lengths (rows,) int32) in Java
    Double/Float.toString layout; W is the longest rendering, bytes past
    a row's length are not set."""
    rows = bits64.shape[0]
    dev = bits64.device
    if is_f32:
        sign = shr(bits64, 31) & 1
        expfield = shr(bits64, 23) & 0xFF
        mantfield = bits64 & ((1 << 23) - 1)
        emax = 0xFF
        digits, e10 = _f2d(bits64)
    else:
        sign = shr(bits64, 63) & 1
        expfield = shr(bits64, 52) & 0x7FF
        mantfield = bits64 & ((1 << 52) - 1)
        emax = 0x7FF
        digits, e10 = _d2d(bits64)
    is_nan = (expfield == emax) & (mantfield != 0)
    is_inf = (expfield == emax) & (mantfield == 0)
    is_zero = (expfield == 0) & (mantfield == 0)
    neg = sign == 1
    special = torch.where(is_nan, 1, torch.where(
        is_inf, torch.where(neg, 3, 2), torch.where(
            is_zero, torch.where(neg, 5, 4), 0)))

    # digit count and the digits, least significant first
    p10 = _table("_POW10_U64", dev)
    ndig = (~ult(digits[:, None], p10[None, :])).sum(
        dim=1, dtype=torch.int32).clamp(min=1)
    dlsb = torch.empty((rows, _ND), dtype=torch.uint8, device=dev)
    v = digits
    for k in range(_ND):
        dlsb[:, k] = (v % 10).to(torch.uint8)
        v = v // 10
    # digit i (0 = most significant) = dlsb[ndig-1-i]
    nd = ndig

    def digit_at(i):
        idx = (nd - 1 - i).clamp(0, _ND - 1).to(torch.int64)
        return dlsb.gather(1, idx[:, None])[:, 0]

    sci_exp = e10 + ndig - 1
    plain = (sci_exp >= -3) & (sci_exp < 7)
    sgn_off = neg.to(torch.int32)
    se = sci_exp
    # plain notation: integer part, '.', fraction (leading zeros and all
    # digits when se < 0)
    int_digits = torch.where(se >= 0, se + 1, 1)
    lead_zeros = torch.where(se < 0, -se - 1, 0)
    frac_digits = torch.where(se >= 0, (nd - int_digits).clamp(min=1),
                              lead_zeros + nd)
    int_len = torch.where(se >= 0, int_digits, 1)
    plain_len = sgn_off + int_len + 1 + frac_digits
    dot_pos = int_len
    # E notation: d.dddE[-]xx ; fraction = remaining digits or "0"
    efrac = (nd - 1).clamp(min=1)
    eneg = se < 0
    ae = se.abs()
    exp_digits = torch.where(ae >= 100, 3, torch.where(ae >= 10, 2, 1))
    sci_len = sgn_off + 1 + 1 + efrac + 1 + eneg.to(torch.int32) \
        + exp_digits
    epos = 2 + efrac
    edig_start = epos + 1 + eneg.to(torch.int32)
    d0 = digit_at(torch.zeros_like(nd)) + 48

    length = torch.where(plain, plain_len, sci_len)
    spec_lens = _table("_SPECIAL_LENS", dev)[special]
    length = torch.where(special > 0, spec_lens, length).to(torch.int32)
    width = int(length.max()) if rows else 1
    spec_table = _table("_SPECIAL_BYTES", dev)
    out = torch.empty((rows, width), dtype=torch.uint8, device=dev)
    for j in range(width):
        # byte at position j (after the sign on negative rows)
        pj = j - sgn_off
        in_int = (pj >= 0) & (pj < int_len)
        int_digit = torch.where(se >= 0, torch.where(
            pj < nd, digit_at(pj), 0), 0)
        in_dot = pj == dot_pos
        fj = pj - dot_pos - 1
        in_frac = (fj >= 0) & (fj < frac_digits)
        frac_digit = torch.where(
            se >= 0,
            torch.where(fj < nd - int_digits, digit_at(int_digits + fj), 0),
            torch.where(fj < lead_zeros, 0, digit_at(fj - lead_zeros)))
        plain_b = torch.where(
            in_int, int_digit + 48,
            torch.where(in_dot, 46, torch.where(in_frac, frac_digit + 48,
                                                0)))
        sfj = pj - 2
        in_sfrac = (sfj >= 0) & (sfj < efrac)
        sfrac_digit = torch.where(sfj < nd - 1, digit_at(1 + sfj), 0)
        ej = pj - edig_start
        in_edig = (ej >= 0) & (ej < exp_digits)
        # exponent digits most significant first
        div = torch.where(ej == exp_digits - 1, 1,
                          torch.where(ej == exp_digits - 2, 10, 100))
        edigit = (ae // div) % 10
        sci_b = torch.where(
            pj == 0, d0,
            torch.where(pj == 1, 46,
                        torch.where(in_sfrac, sfrac_digit + 48,
                                    torch.where(pj == epos, 69,
                                                torch.where(
                                                    (pj == epos + 1) & eneg,
                                                    45,
                                                    torch.where(
                                                        in_edig,
                                                        edigit + 48, 0))))))
        body = torch.where(plain, plain_b, sci_b)
        if j == 0:
            body = torch.where(neg, 45, body)
        out[:, j] = torch.where(special > 0, spec_table[:, j][special],
                                body.to(torch.uint8))
    return out, length


def float_to_string_device(col: Column) -> Column:
    """Device path of cast_string.float_to_string (same output)."""
    assert col.dtype.kind in (Kind.FLOAT32, Kind.FLOAT64)
    rows = col.length
    dev = col.device
    if rows == 0:
        return Column.from_strings([], dev)
    is_f32 = col.dtype.kind == Kind.FLOAT32
    if is_f32:
        bits = col.data.view(torch.int32).to(torch.int64) & M32
    else:
        bits = col.data.view(torch.int64)
    mat, lens = _render(bits, is_f32)
    mask = col.valid_mask()
    lens = torch.where(mask, lens, 0)
    offs = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    torch.cumsum(lens, 0, out=offs[1:])
    j = torch.arange(mat.shape[1], dtype=torch.int32, device=dev)
    data = mat[j[None, :] < lens[:, None]]
    v = None if bool(mask.all()) else mask.to(torch.uint8)
    return Column(dtypes.STRING, rows, data=data, validity=v, offsets=offs)
