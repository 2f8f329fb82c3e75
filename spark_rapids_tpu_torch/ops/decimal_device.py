"""Device decimal128 arithmetic on (rows, 4) int32 limb columns.

The exact host big-int path (ops/decimal_utils.py) is the semantic
reference (reference decimal_utils.cu dec128_multiplier/dec128_adder);
this module runs the same math as 32-bit limb arithmetic on the
column's device, so large columns never leave the card:

- products via 4x4 schoolbook partial products (a 256-bit
  intermediate, like the reference's __int128 chunks);
- rescaling by 10^k as k divmod-by-10 sweeps (k is a Python int:
  scales are column metadata);
- HALF_UP decided by the most significant dropped digit, identical to
  _div_round_half_up;
- overflow = |result| > 10^38-1, reported per row exactly like the host
  path's overflow column;
- division as restoring binary long division over a static bit bound.

Limbs are (rows, L) int64 matrices holding 0..2^32-1, little-endian
(limb 0 least significant): torch has no unsigned 32- or 64-bit
arithmetic, and int64 lanes keep unsigned compares plain.  A u64 partial
sum wraps in int64 with its low 64 bits exact, so every carry is a
logical shift, (t >> 32) & 0xFFFFFFFF.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind

_I64 = torch.int64
M32 = 0xFFFFFFFF

MAX_38 = 10**38 - 1
_MAX38_LIMBS = tuple((MAX_38 >> (32 * k)) & M32 for k in range(4))


def _carry(t: torch.Tensor) -> torch.Tensor:
    """The high 32 bits of a u64 held in int64 (a logical shift)."""
    return (t >> 32) & M32


def _mag_sign(limbs_i32: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows,4) int32 two's complement -> ((rows,4) magnitude limbs,
    (rows,) bool negative)."""
    neg = limbs_i32[:, 3] < 0
    u = limbs_i32.to(_I64) & M32
    return _negate_if(u, neg), neg


def _negate_if(x: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Two's complement of the rows where `neg`, across all L limbs."""
    flipped = torch.where(neg[:, None], x ^ M32, x)
    return _add_one(flipped, neg)


def _apply_sign(mag4: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """(rows,4) magnitude limbs + sign -> (rows,4) int32 two's
    complement."""
    v = _negate_if(mag4, neg)
    return (((v + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def _mul_4x4(a4: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    """(rows,4) x (rows,4) -> (rows,8) limbs of the full 256-bit product
    (schoolbook; a term of up to 2^64-1 wraps in int64, its low 64 bits
    exact)."""
    rows = a4.shape[0]
    acc = [torch.zeros(rows, dtype=_I64, device=a4.device)
           for _ in range(8)]
    for i in range(4):
        carry = torch.zeros(rows, dtype=_I64, device=a4.device)
        ai = a4[:, i]
        for j in range(4):
            t = acc[i + j] + ai * b4[:, j] + carry
            acc[i + j] = t & M32
            carry = _carry(t)
        acc[i + 4] = acc[i + 4] + carry
    return torch.stack(acc, dim=1)


def _divmod10(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows,L) // 10 with remainder, one high-to-low sweep (each step's
    value < 10 * 2^32)."""
    L = x.shape[1]
    r = torch.zeros(x.shape[0], dtype=_I64, device=x.device)
    q = [None] * L
    for k in range(L - 1, -1, -1):
        cur = (r << 32) | x[:, k]
        q[k] = cur // 10
        r = cur - q[k] * 10
    return torch.stack(q, dim=1), r


def _mul10(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows,L) * 10; returns (product, overflowed beyond L limbs)."""
    carry = torch.zeros(x.shape[0], dtype=_I64, device=x.device)
    out = []
    for k in range(x.shape[1]):
        t = x[:, k] * 10 + carry
        out.append(t & M32)
        carry = t >> 32
    return torch.stack(out, dim=1), carry != 0


def _add_one(x: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """x + inc (inc bool per row), ripple carry."""
    carry = inc.to(_I64)
    out = []
    for k in range(x.shape[1]):
        t = x[:, k] + carry
        out.append(t & M32)
        carry = t >> 32
    return torch.stack(out, dim=1)


def _rescale_down(x: torch.Tensor, k: int) -> torch.Tensor:
    """x // 10^k with HALF_UP (the most significant dropped digit alone
    decides the rounding, as in _div_round_half_up)."""
    if k <= 0:
        return x
    for _ in range(k - 1):
        x, _ = _divmod10(x)
    x, r = _divmod10(x)
    return _add_one(x, r >= 5)


def _scale_up(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x * 10^k; returns (result, overflowed)."""
    ovf = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for _ in range(k):
        x, o = _mul10(x)
        ovf = ovf | o
    return x, ovf


def _exceeds_max38(x: torch.Tensor) -> torch.Tensor:
    """(rows,L) magnitude > 10^38-1 (per row)."""
    high_nonzero = (x[:, 4:] != 0).any(dim=1) if x.shape[1] > 4 else \
        torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    # lexicographic compare of the low 4 limbs against MAX_38
    gt = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    eq = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for k in range(3, -1, -1):
        lim = _MAX38_LIMBS[k]
        gt = gt | (eq & (x[:, k] > lim))
        eq = eq & (x[:, k] == lim)
    return high_nonzero | gt


def _widen(x4: torch.Tensor, limbs: int) -> torch.Tensor:
    pad = torch.zeros((x4.shape[0], limbs - x4.shape[1]), dtype=_I64,
                      device=x4.device)
    return torch.cat([x4, pad], dim=1)


def _is_zero_mag(mag: torch.Tensor) -> torch.Tensor:
    """(rows,) bool: every limb zero."""
    return (mag == 0).all(dim=1)


def _multiply_core(a_limbs, b_limbs, a_scale: int, b_scale: int,
                   product_scale: int):
    amag, aneg = _mag_sign(a_limbs)
    bmag, bneg = _mag_sign(b_limbs)
    p = _mul_4x4(amag, bmag)                       # (rows, 8)
    neg = aneg ^ bneg
    exponent = product_scale - (a_scale + b_scale)
    ovf = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    if exponent > 0:
        p = _rescale_down(p, exponent)
    elif exponent < 0:
        if exponent <= -38:
            # host-path parity: the precision pre-check flags even a
            # ZERO product when precision10(0)=1 minus exponent exceeds
            # 38 (decimal_utils.multiply_decimal128); the magnitude
            # check below can never catch 0 * 10^k
            ovf = ovf | _is_zero_mag(p)
        p, o = _scale_up(p, -exponent)
        ovf = ovf | o
    ovf = ovf | _exceeds_max38(p)
    return ovf, _apply_sign(p[:, :4], neg)


def _add_wide(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    carry = torch.zeros(x.shape[0], dtype=_I64, device=x.device)
    out = []
    for k in range(x.shape[1]):
        t = x[:, k] + y[:, k] + carry
        out.append(t & M32)
        carry = t >> 32
    return torch.stack(out, dim=1)


def _add_sub_core(a_limbs, b_limbs, a_scale: int, b_scale: int,
                  out_scale: int, sub: bool):
    s = min(a_scale, b_scale)
    amag, aneg = _mag_sign(a_limbs)
    bmag, bneg = _mag_sign(b_limbs)
    if sub:
        bneg = ~bneg
    # limb budget sized to the upscale so a legitimately huge
    # intermediate (big scale gap, later divided back down) stays exact:
    # 10^k < 2^(4k), plus one limb of headroom for the add
    wide = _limbs_for_shift(max(a_scale - s, b_scale - s))
    x, oa = _scale_up(_widen(amag, wide), a_scale - s)
    y, ob = _scale_up(_widen(bmag, wide), b_scale - s)
    v = _add_wide(_negate_if(x, aneg), _negate_if(y, bneg))
    vneg = v[:, -1] >= (1 << 31)
    vmag = _negate_if(v, vneg)
    shift = out_scale - s
    ovf = oa | ob
    if shift < 0:
        vmag, o = _scale_up(vmag, -shift)
        ovf = ovf | o
    elif shift > 0:
        vmag = _rescale_down(vmag, shift)
    ovf = ovf | _exceeds_max38(vmag)
    return ovf, _apply_sign(vmag[:, :4], vneg)


# ------------------------------------------------------- Column wrappers

def _check(a: Column, b: Column):
    if (a.dtype.kind != Kind.DECIMAL128
            or b.dtype.kind != Kind.DECIMAL128):
        raise ValueError("decimal128 columns required")
    if a.length != b.length:
        raise ValueError("length mismatch")


def _wrap(ovf, limbs, a: Column, b: Column, out_scale: int):
    from spark_rapids_tpu_torch.ops.arithmetic import _combined_validity

    mask = _combined_validity(a, b)  # on the device; None = all valid
    ovf_col = Column(dtypes.BOOL8, a.length, data=ovf.to(torch.uint8),
                     validity=mask)
    out = Column(dtypes.decimal128(out_scale), a.length, data=limbs,
                 validity=mask)
    return ovf_col, out


def multiply128_device(a: Column, b: Column, product_scale: int):
    """Device counterpart of decimal_utils.multiply_decimal128 (without
    the SPARK-40129 interim cast: the host path covers that legacy
    mode)."""
    _check(a, b)
    ovf, limbs = _multiply_core(a.data, b.data, a.dtype.scale,
                                b.dtype.scale, product_scale)
    return _wrap(ovf, limbs, a, b, product_scale)


def add128_device(a: Column, b: Column, out_scale: int):
    _check(a, b)
    ovf, limbs = _add_sub_core(a.data, b.data, a.dtype.scale,
                               b.dtype.scale, out_scale, False)
    return _wrap(ovf, limbs, a, b, out_scale)


def sub128_device(a: Column, b: Column, out_scale: int):
    _check(a, b)
    ovf, limbs = _add_sub_core(a.data, b.data, a.dtype.scale,
                               b.dtype.scale, out_scale, True)
    return _wrap(ovf, limbs, a, b, out_scale)


# --------------------------------------------------- division / remainder

def _ge_limbs(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x >= y, limbwise lexicographic from the top (per row)."""
    gt = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    eq = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for k in range(x.shape[1] - 1, -1, -1):
        gt = gt | (eq & (x[:, k] > y[:, k]))
        eq = eq & (x[:, k] == y[:, k])
    return gt | eq


def _shl1_inject(x: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """Limb-major (L, rows) << 1 with `bit` (rows,) injected at bit 0."""
    out = (x << 1) & M32
    out[1:] |= x[:-1] >> 31
    out[0] |= bit
    return out


def _sub_if_ge(x: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x - y where x >= y else x, the (rows,) bool x >= y) for
    limb-major (L, rows) limbs: a ripple borrow over the L contiguous
    limb rows, whose final borrow is set exactly where x < y."""
    out = torch.empty_like(x)
    borrow = torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
    for k in range(x.shape[0]):
        t = x[k] - y[k] - borrow.to(_I64)
        torch.bitwise_and(t, M32, out=out[k])
        borrow = t < 0
    ge = ~borrow
    return torch.where(ge, out, x), ge


def _long_divide(num: torch.Tensor, den: torch.Tensor,
                 num_bits: int | None = None, den_bits: int | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restoring binary long division, vectorized over rows.
    num (rows,N) / den (rows,N) -> (quotient, remainder), both (rows,N).
    Caller guarantees den != 0 (zero rows are masked out and flagged
    upstream).  `num_bits` bounds the numerator's bit length: the loop
    runs num_bits rounds, not 32*N (about 280 against 480 for deep
    scale gaps).  `den_bits` bounds the divisor's: the remainder stays
    below the divisor, and below twice it after a shift, so it is kept
    only den_bits + 1 bits wide.  The rounds work limb-major, (L, rows),
    so every limb is one contiguous row of int64 lanes."""
    rows, N = num.shape
    total_bits = min(num_bits, N * 32) if num_bits else N * 32
    width = min(N, (den_bits + 32) // 32) if den_bits else N
    den_t = den[:, :width].t().contiguous()
    num_t = num.t().contiguous()
    rem = torch.zeros((width, rows), dtype=_I64, device=num.device)
    q = [torch.zeros(rows, dtype=_I64, device=num.device)
         for _ in range(N)]
    for k in range(total_bits - 1, -1, -1):
        bit = (num_t[k // 32] >> (k % 32)) & 1
        rem, ge = _sub_if_ge(_shl1_inject(rem, bit), den_t)
        q[k // 32] |= ge.to(_I64) << (k % 32)
    return torch.stack(q, dim=1), _widen(rem.t(), N)


def _limbs_for_shift(shift: int) -> int:
    return 4 + (abs(shift) * 4 + 31) // 32 + 1


def _bits_for_shift(shift: int) -> int:
    """Static bit bound for a 128-bit magnitude scaled up by 10^shift
    (10^k < 2^(4k))."""
    return 128 + 4 * max(shift, 0) + 1


def _replace_zero_den(den: torch.Tensor,
                      div_zero: torch.Tensor) -> torch.Tensor:
    """Zero divisors (flagged upstream) divide by 1 so the long
    division stays well-defined; their values are unspecified."""
    one = torch.zeros_like(den)
    one[:, 0] = 1
    return torch.where(div_zero[:, None], one, den)


def _mul_by_2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows,L) * 2; returns (product, carried out of the top limb)."""
    doubled = (x << 1) & M32
    doubled[:, 1:] |= x[:, :-1] >> 31
    return doubled, (x[:, -1] >> 31) != 0


def _divide_core(a_limbs, b_limbs, a_scale: int, b_scale: int,
                 quotient_scale: int, integer_divide: bool):
    shift = a_scale - b_scale - quotient_scale
    num_bits = _bits_for_shift(shift)
    wide = max((num_bits + 31) // 32,
               (_bits_for_shift(-shift) + 31) // 32)
    amag, aneg = _mag_sign(a_limbs)
    bmag, bneg = _mag_sign(b_limbs)
    div_zero = _is_zero_mag(bmag)
    num = _widen(amag, wide)
    den = _widen(bmag, wide)
    if shift >= 0:
        num, ovf = _scale_up(num, shift)
    else:
        den, ovf = _scale_up(den, -shift)
    den = _replace_zero_den(den, div_zero)
    q, rem = _long_divide(num, den, num_bits=num_bits,
                          den_bits=_bits_for_shift(-shift))
    neg = aneg ^ bneg
    if not integer_divide:
        # HALF_UP on the magnitude: round up when 2*rem >= den
        rem2, c = _mul_by_2(rem)
        up = (_ge_limbs(rem2, den) | c) & ~div_zero
        q = _add_one(q, up)
    ovf = ovf | div_zero | _exceeds_max38(q)
    if integer_divide:
        # Spark integral division bounds the result to int64
        # (dec128_divider is_int_div path)
        int64_ovf = (q[:, 2:] != 0).any(dim=1)
        hi = q[:, 1]
        # |q| must be <= 2^63-1 (or 2^63 when negative)
        too_big = (hi > 0x7FFFFFFF) | int64_ovf
        exactly_min = (hi == 0x80000000) & (q[:, 0] == 0) & ~int64_ovf
        ovf = ovf | torch.where(neg, too_big & ~exactly_min, too_big)
    return ovf, _apply_sign(q[:, :4], neg)


def _remainder_core(a_limbs, b_limbs, a_scale: int, b_scale: int,
                    remainder_scale: int):
    s = min(a_scale, b_scale)
    # width is driven by the ALIGNMENT upscales only; the remainder is
    # re-widened after the division if the output rescale needs it
    num_bits = _bits_for_shift(a_scale - s)
    wide = max((num_bits + 31) // 32,
               (_bits_for_shift(b_scale - s) + 31) // 32)
    amag, aneg = _mag_sign(a_limbs)
    bmag, _ = _mag_sign(b_limbs)
    div_zero = _is_zero_mag(bmag)
    x, oa = _scale_up(_widen(amag, wide), a_scale - s)
    y, ob = _scale_up(_widen(bmag, wide), b_scale - s)
    y = _replace_zero_den(y, div_zero)
    _, rem = _long_divide(x, y, num_bits=num_bits,
                          den_bits=_bits_for_shift(b_scale - s))
    shift = remainder_scale - s
    ovf = oa | ob
    if shift < 0:
        need = (_bits_for_shift(b_scale - s) + 4 * (-shift) + 31) \
            // 32 + 1
        if need > rem.shape[1]:
            rem = _widen(rem, need)
        rem, o = _scale_up(rem, -shift)
        ovf = ovf | o
    elif shift > 0:
        rem = _rescale_down(rem, shift)
    ovf = ovf | div_zero | _exceeds_max38(rem)
    return ovf, _apply_sign(rem[:, :4], aneg)   # sign follows the dividend


def divide128_device(a: Column, b: Column, quotient_scale: int,
                     integer_divide: bool = False):
    """Device counterpart of decimal_utils.divide_decimal128
    (dec128_divider): restoring binary long division on 32-bit limbs,
    HALF_UP (or truncation for integral division with int64 bounds);
    division by zero flags overflow."""
    _check(a, b)
    ovf, limbs = _divide_core(a.data, b.data, a.dtype.scale,
                              b.dtype.scale, quotient_scale,
                              integer_divide)
    return _wrap(ovf, limbs, a, b, quotient_scale)


def integer_divide128_device(a: Column, b: Column, quotient_scale: int):
    return divide128_device(a, b, quotient_scale, integer_divide=True)


def remainder128_device(a: Column, b: Column, remainder_scale: int):
    """Device counterpart of decimal_utils.remainder_decimal128:
    truncated-division remainder with the dividend's sign."""
    _check(a, b)
    ovf, limbs = _remainder_core(a.data, b.data, a.dtype.scale,
                                 b.dtype.scale, remainder_scale)
    return _wrap(ovf, limbs, a, b, remainder_scale)
