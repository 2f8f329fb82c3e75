"""Iceberg partition transforms (reference src/main/cpp/src/iceberg/:
iceberg_bucket.cu, iceberg_truncate.cu, iceberg_datetime_util.cu;
IcebergBucket.java etc.) -- bucket (STANDARD murmur3_32 seed 0, NOT the
Spark variant: ints promote to longs and hash as 8 LE bytes, decimals
hash their minimal big-endian two's-complement unscaled bytes), truncate
(positive-mod for integrals/decimals, leading codepoints for strings),
and year/month/day/hour datetime transforms.  u32 hash values ride in
int64 lanes, as in ops/hash.py."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.ops.datetime_ops import _days_to_ymd
from spark_rapids_tpu_torch.ops.hash import (M32, _MM_C1, _MM_C2,
                                             _chars_to_u32_blocks,
                                             _dec128_min_be_bytes,
                                             _mm_fmix, _mm_update,
                                             _pad_chars, _pick, _rotl32,
                                             _split_u64)

_I64 = torch.int64

MICROS_PER_HOUR = 3_600_000_000
MICROS_PER_DAY = 86_400_000_000


def _std_murmur_varbytes(chars: torch.Tensor, lens: torch.Tensor
                         ) -> torch.Tensor:
    """STANDARD murmur3_32 (seed 0) over per-row byte strings -- unlike
    Spark's variant, the tail partial block is combined little-endian and
    mixed once without the h-rotation (iceberg_bucket.cu hash_bytes via
    cuco MurmurHash3_32)."""
    chars = _pad_chars(chars, 4)
    blocks = _chars_to_u32_blocks(chars)
    lens = lens.to(_I64)
    nblocks = lens // 4
    h = torch.zeros(chars.shape[0], dtype=_I64, device=chars.device)
    for i in range(blocks.shape[1]):
        h = torch.where(i < nblocks, _mm_update(h, blocks[:, i]), h)
    # standard tail: combine remaining 1-3 bytes LE, single k1 mix
    p = chars.shape[1]
    tail = torch.zeros_like(h)
    for j in range(3):
        idx = nblocks * 4 + j
        byte = _pick(chars, idx.clamp(0, p - 1))
        tail = tail | torch.where(idx < lens, byte << (8 * j), 0)
    k1 = (tail * _MM_C1) & M32
    k1 = _rotl32(k1, 15)
    k1 = (k1 * _MM_C2) & M32
    h = torch.where(lens % 4 != 0, h ^ k1, h)
    return _mm_fmix(h ^ (lens & M32))


def _std_murmur_u64(v: torch.Tensor) -> torch.Tensor:
    """Standard murmur3_32 of 8 LE bytes (Iceberg hashLong)."""
    lo, hi = _split_u64(v)
    h = _mm_update(torch.zeros_like(v), lo)
    h = _mm_update(h, hi)
    return _mm_fmix(h ^ 8)


def bucket(col: Column, num_buckets: int) -> Column:
    """Iceberg bucket transform: (hash & MAX_INT) % N, null-preserving."""
    kind = col.dtype.kind
    if kind in (Kind.INT32, Kind.INT64, Kind.TIMESTAMP_DAYS,
                Kind.TIMESTAMP_MICROS):
        h = _std_murmur_u64(col.data.to(_I64))
    elif kind == Kind.STRING:
        chars, lens = col.to_padded_chars()
        h = _std_murmur_varbytes(chars, lens)
    elif kind in (Kind.DECIMAL32, Kind.DECIMAL64):
        # minimal big-endian two's complement of the unscaled value
        v = col.data.to(_I64)
        sign = torch.where(v < 0, -1, 0)
        limbs = torch.stack([v & M32, (v >> 32) & M32, sign, sign],
                            dim=1).to(torch.int32)
        be, length = _dec128_min_be_bytes(limbs)
        h = _std_murmur_varbytes(be, length)
    elif kind == Kind.DECIMAL128:
        be, length = _dec128_min_be_bytes(col.data)
        h = _std_murmur_varbytes(be, length)
    else:
        raise NotImplementedError(f"iceberg bucket of {kind}")
    b = (h & 0x7FFFFFFF) % num_buckets
    return Column(dtypes.INT32, col.length, data=b.to(torch.int32),
                  validity=col.validity)


def truncate(col: Column, width: int) -> Column:
    """Iceberg truncate transform (iceberg_truncate.cu:48-61 examples:
    truncate(10, 5)=0, truncate(10, 15)=10, truncate(10, -5)=-10)."""
    kind = col.dtype.kind
    if kind in (Kind.INT32, Kind.INT64, Kind.DECIMAL32, Kind.DECIMAL64):
        v = col.data.to(_I64)
        out = v - torch.remainder(v, width)    # floor mod: non-negative
        return Column(col.dtype, col.length,
                      data=out.to(col.dtype.torch_dtype),
                      validity=col.validity)
    if kind == Kind.STRING:
        # first `width` CODEPOINTS (not bytes), a host loop
        return Column.from_strings(
            [None if s is None else s[:width] for s in col.to_pylist()],
            col.device)
    raise NotImplementedError(f"iceberg truncate of {kind}")


def year(col: Column) -> Column:
    """Years since 1970 (iceberg_datetime_util.cu)."""
    y, _, _ = _days_to_ymd(_col_days(col))
    return Column(dtypes.INT32, col.length, data=(y - 1970).to(torch.int32),
                  validity=col.validity)


def month(col: Column) -> Column:
    y, m, _ = _days_to_ymd(_col_days(col))
    return Column(dtypes.INT32, col.length,
                  data=((y - 1970) * 12 + m - 1).to(torch.int32),
                  validity=col.validity)


def day(col: Column) -> Column:
    return Column(dtypes.INT32, col.length,
                  data=_col_days(col).to(torch.int32),
                  validity=col.validity)


def hour(col: Column) -> Column:
    assert col.dtype.kind == Kind.TIMESTAMP_MICROS
    h = torch.div(col.data.to(_I64), MICROS_PER_HOUR, rounding_mode="floor")
    return Column(dtypes.INT32, col.length, data=h.to(torch.int32),
                  validity=col.validity)


def _col_days(col: Column) -> torch.Tensor:
    if col.dtype.kind == Kind.TIMESTAMP_DAYS:
        return col.data.to(_I64)
    if col.dtype.kind == Kind.TIMESTAMP_MICROS:
        return torch.div(col.data.to(_I64), MICROS_PER_DAY,
                         rounding_mode="floor")
    raise NotImplementedError(f"datetime transform of {col.dtype.kind}")
