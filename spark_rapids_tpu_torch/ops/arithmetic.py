"""Arithmetic ops: ANSI/TRY multiply with overflow, Spark round()
(reference multiply.cu/multiply.hpp, round_float.cu/round_float.hpp,
Arithmetic.java:45-185).

Integer quotients and remainders truncate toward zero, as the
reference's (and XLA's) do: `torch.div(..., rounding_mode="trunc")` and
`torch.fmod`, never Python's flooring `//` and `%`.  FLOAT64 is native
float64."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.ops.exceptions import ExceptionWithRowIndex

_I64 = torch.int64
_INT64_MIN = -(1 << 63)

HALF_UP = "HALF_UP"
HALF_EVEN = "HALF_EVEN"


def _tdiv(a, b):
    return torch.div(a, b, rounding_mode="trunc")


def _combined_validity(a: Column, b: Column) -> Optional[torch.Tensor]:
    if a.validity is None and b.validity is None:
        return None
    return (a.valid_mask() & b.valid_mask()).to(torch.uint8)


def multiply(lhs: Column, rhs: Column, is_ansi_mode: bool = False,
             is_try_mode: bool = False) -> Column:
    """Element-wise multiply with Spark overflow semantics (multiply.hpp):
    regular mode wraps, TRY nulls overflow rows, ANSI throws
    ExceptionWithRowIndex at the first overflow row."""
    if is_ansi_mode and is_try_mode:
        raise ValueError("ANSI and TRY mode cannot both be enabled")
    if lhs.dtype != rhs.dtype:
        raise ValueError("multiply requires matching dtypes")
    kind = lhs.dtype.kind
    validity = _combined_validity(lhs, rhs)
    if kind in (Kind.FLOAT32, Kind.FLOAT64):
        return Column(lhs.dtype, lhs.length, data=lhs.data * rhs.data,
                      validity=validity)
    # integral: wrapped product, overflow found by dividing back
    a = lhs.data.to(_I64)
    b = rhs.data.to(_I64)
    r = a * b  # wraps
    if kind == Kind.INT64:
        # a == -1 is decided by its own term: INT64_MIN / -1 traps on
        # the CPU, and the division would only give -r == b there
        plain = (a != 0) & (a != -1)
        safe = torch.where(plain, a, 1)
        ovf = (((a == -1) & (b == _INT64_MIN))
               | ((b == -1) & (a == _INT64_MIN))
               | (plain & (_tdiv(r, safe) != b)))
        out = r
    else:
        info = np.iinfo(lhs.dtype.np_dtype)
        ovf = (r < int(info.min)) | (r > int(info.max))
        out = r.to(lhs.dtype.torch_dtype)
    base_valid = (torch.ones(lhs.length, dtype=torch.bool, device=a.device)
                  if validity is None else validity.to(torch.bool))
    if is_ansi_mode:
        bad = base_valid & ovf
        if bool(bad.any()):
            raise ExceptionWithRowIndex(int(torch.argmax(bad.to(torch.uint8))),
                                        "multiplication overflow")
        return Column(lhs.dtype, lhs.length, data=out, validity=validity)
    if is_try_mode:
        new_valid = (base_valid & ~ovf).to(torch.uint8)
        return Column(lhs.dtype, lhs.length, data=out, validity=new_valid)
    return Column(lhs.dtype, lhs.length, data=out, validity=validity)


def _round_int(v: torch.Tensor, f: int, method: str) -> torch.Tensor:
    """int64 values rounded to a multiple of f (a power of 10, >= 10),
    HALF_UP or HALF_EVEN, away from zero on the sign of v."""
    q = _tdiv(v, f)
    absr = torch.fmod(v, f).abs()
    if method == HALF_UP:
        up = absr >= f // 2
    else:
        tie = absr * 2 == f
        up = (absr * 2 > f) | (tie & (torch.fmod(q, 2) != 0))
    bump = up.to(_I64) * torch.where(v < 0, -1, 1)
    return (q + bump) * f


def round_column(col: Column, decimal_places: int = 0,
                 method: str = HALF_UP) -> Column:
    """Spark round()/bround() (round_float.hpp): integers, floats,
    decimal32/64 (negated scale == decimal_places)."""
    if method not in (HALF_UP, HALF_EVEN):
        # unvalidated strings must not silently round the wrong way
        # (JNI callers pass the mode through verbatim)
        raise ValueError(f"unknown rounding method {method!r}; "
                         f"expected {HALF_UP!r} or {HALF_EVEN!r}")
    kind = col.dtype.kind
    if kind in (Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64,
                Kind.DECIMAL32, Kind.DECIMAL64):
        if kind in (Kind.DECIMAL32, Kind.DECIMAL64):
            # rounding the unscaled value to the requested scale
            shift = -col.dtype.scale - decimal_places
        else:
            shift = -decimal_places
        if shift <= 0:
            return Column(col.dtype, col.length, data=col.data,
                          validity=col.validity)
        if shift > 18:  # 10^19 > int64 range: everything -> 0
            return Column(col.dtype, col.length,
                          data=torch.zeros_like(col.data),
                          validity=col.validity)
        out = _round_int(col.data.to(_I64), 10 ** shift, method)
        return Column(col.dtype, col.length,
                      data=out.to(col.dtype.torch_dtype),
                      validity=col.validity)
    if kind in (Kind.FLOAT32, Kind.FLOAT64):
        # float64 arithmetic for both widths, as the reference's
        # float64 scale factor promotes a FLOAT32 column
        x = col.data.to(torch.float64)
        f = float(np.float64(10.0 ** decimal_places))
        scaled = x * f
        if method == HALF_UP:
            r = torch.trunc(scaled + torch.where(scaled >= 0, 0.5, -0.5))
        else:
            r = torch.round(scaled)  # round-half-even
        # a tensor divisor: torch divides by a Python scalar on the card
        # as a multiply by its reciprocal, which can round differently
        out = torch.where(torch.isfinite(x), r / x.new_tensor(f), x)
        return Column(col.dtype, col.length,
                      data=out.to(col.dtype.torch_dtype),
                      validity=col.validity)
    raise NotImplementedError(f"round of {kind}")
