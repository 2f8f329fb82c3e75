"""Overflow-safe 64-bit SUM building blocks (aggregation64_utils.hpp/.cu,
Aggregation64Utils.java): split int64 values into 32-bit chunks, sum the
chunks as int64 (no overflow below 2^32 rows), then reassemble with carry
propagation and overflow detection.

u64 values travel as int64 bit patterns; every step below stays inside
int64 without overflowing, except the reference's own wrapping add of
the high sums and the carry.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType
from spark_rapids_tpu_torch.ops.joins import _as_int64, _from_int64

_U32 = 0xFFFFFFFF


def extract_chunk32_from_64bit(col: Column, dtype: DType,
                               chunk_idx: int) -> Column:
    """Chunk 0 = least-significant 32 bits (as UINT32-valued numbers),
    chunk 1 = most-significant (signed).  Output in `dtype` (UINT32/INT32
    per the reference, but any integer dtype wide enough works)."""
    if chunk_idx not in (0, 1):
        raise ValueError("chunk_idx must be 0 or 1")
    v = _as_int64(col.data, col.dtype.kind)
    chunk = v & _U32 if chunk_idx == 0 else v >> 32
    return Column(dtype, col.length, data=_from_int64(chunk, dtype),
                  validity=col.validity)


def assemble64_from_sum(low_sums: Column, high_sums: Column,
                        output_dtype: DType = dtypes.INT64):
    """(overflow BOOL8 column, value column): value = low + (high << 32)
    where low's upper bits carry into high (aggregation64_utils.hpp:52).
    Overflow when the true sum does not fit in 64 bits signed."""
    low = _as_int64(low_sums.data, low_sums.dtype.kind)
    high = _as_int64(high_sums.data, high_sums.dtype.kind)
    total_high = high + (low >> 32)    # arithmetic shift: signed carry
    # the value's bits 32..63 are total_high's low 32 bits
    top = total_high & _U32
    top = torch.where(top > 0x7FFFFFFF, top - (1 << 32), top)
    value = top * (1 << 32) + (low & _U32)
    # overflow iff total_high is not the sign extension of value's top
    overflow = total_high != (value >> 32)
    validity = None
    if low_sums.validity is not None or high_sums.validity is not None:
        ok = torch.ones(low_sums.length, dtype=torch.bool,
                        device=low.device)
        for c in (low_sums, high_sums):
            if c.validity is not None:
                ok = ok & (c.validity != 0)
        validity = ok.to(torch.uint8)
    return (Column(dtypes.BOOL8, low_sums.length,
                   data=overflow.to(torch.uint8), validity=validity),
            Column(output_dtype, low_sums.length,
                   data=_from_int64(value, output_dtype), validity=validity))
