"""decimal128 arithmetic with Spark precision-38 semantics (reference
decimal_utils.cu/.hpp, DecimalUtils.java): each op returns (overflow BOOL8
column, result DECIMAL128 column at the requested scale).

Scales follow cudf convention: negative scale = digits after the point.

Two engines give the same bits.  The exact one runs on host
arbitrary-precision integers, bit-exact by construction, including the
Spark legacy cast_interim_result double-rounding (SPARK-40129); the
device one (ops/decimal_device.py) is limb arithmetic on the column's
device.  Columns on the card take the limbs and CPU columns the host
loop; SPARK_RAPIDS_TPU_FORCE_DEVICE_DECIMAL=1 sends CPU columns to the
limbs too, =0 sends card columns to the host loop.  The legacy
interim cast runs on the host loop wherever the columns are, as the
reference's device path leaves it to the host path.  Results land on
the inputs' device.
"""

from __future__ import annotations

import os
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind

MAX_38 = 10**38 - 1


def _to_ints(col: Column) -> Tuple[np.ndarray, np.ndarray]:
    """(object array of python unscaled ints, valid mask): through the
    Column decimal128 codec (single source of the limb layout)."""
    vals = np.array([0 if v is None else v for v in col.to_pylist()],
                    object)
    mask = (np.ones(col.length, bool) if col.validity is None
            else col.validity.cpu().numpy().astype(bool))
    return vals, mask


def _from_ints(vals, mask, scale: int, device) -> Column:
    pyvals = [int(v) if m else None for v, m in zip(vals, mask)]
    col = Column.from_pylist(pyvals, dtypes.decimal128(scale), device)
    if col.validity is None and not mask.all():
        col = Column(col.dtype, col.length, data=col.data,
                     validity=torch.from_numpy(
                         mask.astype(np.uint8)).to(device))
    return col


def _bool_col(vals: np.ndarray, mask: np.ndarray, device) -> Column:
    validity = None if mask.all() else torch.from_numpy(
        mask.astype(np.uint8)).to(device)
    return Column(dtypes.BOOL8, len(vals),
                  data=torch.from_numpy(vals.astype(np.uint8)).to(device),
                  validity=validity)


def _div_round_half_up(x: int, y: int) -> int:
    """round-half-away-from-zero of x/y (divide_and_round,
    decimal_utils.cu)."""
    if y == 0:
        raise ZeroDivisionError
    sign = -1 if (x < 0) != (y < 0) else 1
    ax, ay = abs(x), abs(y)
    return sign * ((2 * ax + ay) // (2 * ay))


def _precision10(x: int) -> int:
    return len(str(abs(x))) if x != 0 else 1


def _check_both(a: Column, b: Column):
    if a.dtype.kind != Kind.DECIMAL128 or b.dtype.kind != Kind.DECIMAL128:
        raise ValueError("decimal128 columns required")
    if a.length != b.length:
        raise ValueError("column lengths must match")


def _use_device(col: Column) -> bool:
    """Route to the device limbs (ops/decimal_device.py) when the
    columns are on the card; SPARK_RAPIDS_TPU_FORCE_DEVICE_DECIMAL=1
    forces the limbs, =0 the host loop (as the device join and group-by
    gates do)."""
    force = os.environ.get("SPARK_RAPIDS_TPU_FORCE_DEVICE_DECIMAL")
    if force == "1":
        return True
    if force == "0":
        return False
    return col.device.type == "cuda"


def multiply_decimal128(a: Column, b: Column, product_scale: int,
                        cast_interim_result: bool = False):
    """(overflow, product) (decimal_utils.cu dec128_multiplier incl. the
    SPARK-40129 legacy interim rounding when cast_interim_result)."""
    _check_both(a, b)
    if not cast_interim_result and _use_device(a):
        from spark_rapids_tpu_torch.ops.decimal_device import \
            multiply128_device
        return multiply128_device(a, b, product_scale)
    av, am = _to_ints(a)
    bv, bm = _to_ints(b)
    mask = am & bm
    n = a.length
    out = np.zeros(n, object)
    ovf = np.zeros(n, bool)
    for i in range(n):
        if not mask[i]:
            continue
        product = int(av[i]) * int(bv[i])
        mult_scale = a.dtype.scale + b.dtype.scale
        if cast_interim_result:
            first_div_precision = _precision10(product) - 38
            if first_div_precision > 0:
                product = _div_round_half_up(product,
                                             10**first_div_precision)
                mult_scale += first_div_precision
        exponent = product_scale - mult_scale
        if exponent < 0:
            if _precision10(product) - exponent > 38:
                ovf[i] = True
                continue
            product *= 10 ** (-exponent)
        elif exponent > 0:
            product = _div_round_half_up(product, 10**exponent)
        if abs(product) > MAX_38:
            ovf[i] = True
        else:
            out[i] = product
    return (_bool_col(ovf, mask, a.device),
            _from_ints(out, mask, product_scale, a.device))


def divide_decimal128(a: Column, b: Column, quotient_scale: int,
                      integer_divide: bool = False):
    """(overflow, quotient) at quotient_scale; HALF_UP rounding
    (dec128_divider)."""
    _check_both(a, b)
    if _use_device(a):
        from spark_rapids_tpu_torch.ops.decimal_device import \
            divide128_device
        return divide128_device(a, b, quotient_scale, integer_divide)
    av, am = _to_ints(a)
    bv, bm = _to_ints(b)
    mask = am & bm
    n = a.length
    out = np.zeros(n, object)
    ovf = np.zeros(n, bool)
    for i in range(n):
        if not mask[i]:
            continue
        if int(bv[i]) == 0:
            ovf[i] = True  # division by zero flagged as overflow
            continue
        # value = av*10^as / (bv*10^bs); unscaled at qs:
        shift = a.dtype.scale - b.dtype.scale - quotient_scale
        x, y = int(av[i]), int(bv[i])
        if integer_divide:
            # truncating division AT the target scale
            # (decimal_utils.cu dec128_divider is_int_div path)
            if shift >= 0:
                num, den = x * 10**shift, y
            else:
                num, den = x, y * 10**(-shift)
            q = abs(num) // abs(den)
            q = q if (x < 0) == (y < 0) else -q
            if q > 2**63 - 1 or q < -2**63:
                ovf[i] = True  # Spark integral div result bounds
                continue
        else:
            if shift >= 0:
                q = _div_round_half_up(x * 10**shift, y)
            else:
                q = _div_round_half_up(x, y * 10**(-shift))
        if abs(q) > MAX_38:
            ovf[i] = True
        else:
            out[i] = q
    return (_bool_col(ovf, mask, a.device),
            _from_ints(out, mask, quotient_scale, a.device))


def integer_divide_decimal128(a: Column, b: Column, quotient_scale: int):
    return divide_decimal128(a, b, quotient_scale, integer_divide=True)


def remainder_decimal128(a: Column, b: Column, remainder_scale: int):
    """(overflow, a % b) with C/Java truncated-division remainder."""
    _check_both(a, b)
    if _use_device(a):
        from spark_rapids_tpu_torch.ops.decimal_device import \
            remainder128_device
        return remainder128_device(a, b, remainder_scale)
    av, am = _to_ints(a)
    bv, bm = _to_ints(b)
    mask = am & bm
    n = a.length
    out = np.zeros(n, object)
    ovf = np.zeros(n, bool)
    for i in range(n):
        if not mask[i]:
            continue
        if int(bv[i]) == 0:
            ovf[i] = True
            continue
        # align both to the finer scale, take truncated remainder, rescale
        s = min(a.dtype.scale, b.dtype.scale)
        x = int(av[i]) * 10 ** (a.dtype.scale - s)
        y = int(bv[i]) * 10 ** (b.dtype.scale - s)
        r = abs(x) % abs(y)
        r = r if x >= 0 else -r
        shift = remainder_scale - s
        if shift < 0:
            r *= 10 ** (-shift)
        elif shift > 0:
            r = _div_round_half_up(r, 10**shift)
        if abs(r) > MAX_38:
            ovf[i] = True
        else:
            out[i] = r
    return (_bool_col(ovf, mask, a.device),
            _from_ints(out, mask, remainder_scale, a.device))


def _add_sub(a: Column, b: Column, out_scale: int, sub: bool):
    _check_both(a, b)
    if _use_device(a):
        from spark_rapids_tpu_torch.ops.decimal_device import (
            add128_device, sub128_device)
        return (sub128_device if sub else add128_device)(a, b, out_scale)
    av, am = _to_ints(a)
    bv, bm = _to_ints(b)
    mask = am & bm
    n = a.length
    out = np.zeros(n, object)
    ovf = np.zeros(n, bool)
    s = min(a.dtype.scale, b.dtype.scale)
    for i in range(n):
        if not mask[i]:
            continue
        x = int(av[i]) * 10 ** (a.dtype.scale - s)
        y = int(bv[i]) * 10 ** (b.dtype.scale - s)
        v = x - y if sub else x + y
        shift = out_scale - s
        if shift < 0:
            v *= 10 ** (-shift)
        elif shift > 0:
            v = _div_round_half_up(v, 10**shift)
        if abs(v) > MAX_38:
            ovf[i] = True
        else:
            out[i] = v
    return (_bool_col(ovf, mask, a.device),
            _from_ints(out, mask, out_scale, a.device))


def add_decimal128(a: Column, b: Column, out_scale: int):
    return _add_sub(a, b, out_scale, False)


def sub_decimal128(a: Column, b: Column, out_scale: int):
    return _add_sub(a, b, out_scale, True)


def floating_point_to_decimal(col: Column, output_scale: int,
                              precision: int):
    """(decimal column, first failed row index or -1): f64/f32 -> decimal
    rejecting values that don't fit `precision` digits
    (decimal_utils.hpp:77 floating_point_to_decimal).  A host loop over
    the exact double values; the column lands on the input's device."""
    if col.dtype.kind not in (Kind.FLOAT32, Kind.FLOAT64):
        raise ValueError("floating point column required")
    host = col.data.cpu().numpy().astype(np.float64)
    mask = (np.ones(col.length, bool) if col.validity is None
            else col.validity.cpu().numpy().astype(bool))
    n = col.length
    out = np.zeros(n, object)
    ok = mask.copy()
    first_fail = -1
    for i in range(n):
        if not mask[i]:
            continue
        v = host[i]
        if not np.isfinite(v):
            ok[i] = False
            first_fail = i if first_fail < 0 else first_fail
            continue
        # exact double value scaled, then HALF_UP (decimal_utils.cu
        # scaled_round): no double-arithmetic rounding error
        frac = Fraction(v) * 10 ** (-output_scale)
        unscaled = _div_round_half_up(frac.numerator, frac.denominator)
        if _precision10(int(unscaled)) > precision:
            ok[i] = False
            first_fail = i if first_fail < 0 else first_fail
            continue
        out[i] = int(unscaled)
    return _from_ints(out, ok, output_scale, col.device), first_fail
