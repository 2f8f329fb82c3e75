"""Spark-exact row hashes: murmur3_32 and xxhash64 over fixed-width,
STRING and DECIMAL128 columns.

Semantics follow the reference (murmur_hash.cuh, xxhash64.cu): the seed
chains serially across columns and a null element passes the incoming hash
through unchanged; INT8/INT16 sign-extend to 4 bytes, BOOL8 widens to a
4-byte 0/1, DECIMAL32/64 hash as an 8-byte long; murmur normalizes only
NaN, xxhash64 also turns -0.0 into 0.  A STRING hashes its bytes and a
DECIMAL128 the minimal big-endian two's-complement bytes of its unscaled
value (Java BigInteger.toByteArray); murmur's byte tail sign-extends each
trailing byte, xxhash64's zero-extends it.  Byte strings are hashed over
a (rows, pad) zero-padded char matrix, one block of every row per step
with a per-row "still inside the string" mask.

Torch has no shift, compare or remainder for uint32/uint64 on the CPU, so
unsigned values ride in int64 lanes:
  * a u32 value is an int64 in [0, 2^32); every step that can leave that
    range is masked with 0xFFFFFFFF (int64 products wrap mod 2^64, so the
    low 32 bits stay right);
  * a u64 value is the int64 with the same bits; products and sums wrap,
    a logical right shift is an arithmetic one masked to the kept bits,
    and constants >= 2^63 are written as their signed equals.
Widening int32 -> int64 sign-extends: a u32 taken from an int32 buffer is
masked to zero-extend it.

LIST and STRUCT columns raise NotImplementedError (ROADMAP Queue A3);
hive_hash is not ported yet either.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.utils import floats

DEFAULT_XXHASH64_SEED = 42

M32 = 0xFFFFFFFF


def _signed64(u: int) -> int:
    """The int64 with the same bits as the u64 constant `u`."""
    return u - (1 << 64) if u >= 1 << 63 else u


def _cols(table_or_cols) -> List[Column]:
    if isinstance(table_or_cols, Table):
        return list(table_or_cols.columns)
    if isinstance(table_or_cols, Column):
        return [table_or_cols]
    return list(table_or_cols)


def _shr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr64(x, 64 - r)


# ------------------------------------------------------------ murmur3_32

_MM_C1 = 0xCC9E2D51
_MM_C2 = 0x1B873593
_MM_C3 = 0xE6546B64


def _mm_update(h, k1):
    k1 = (k1 * _MM_C1) & M32
    k1 = _rotl32(k1, 15)
    k1 = (k1 * _MM_C2) & M32
    h = h ^ k1
    h = _rotl32(h, 13)
    return (h * 5 + _MM_C3) & M32


def _mm_fmix(h):
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _murmur_blocks(h, blocks: Sequence[torch.Tensor], nbytes: int):
    for b in blocks:
        h = _mm_update(h, b)
    return _mm_fmix(h ^ nbytes)


def _murmur_varbytes(h, chars: torch.Tensor, lens: torch.Tensor):
    """Spark murmur over per-row byte strings: (rows, P) uint8 chars,
    zero-padded, and (rows,) int64 lengths.  Whole 4-byte blocks, then
    Spark's tail (murmur_hash.cuh:72-93): each trailing byte sign-extended
    and mixed as a block of its own."""
    chars = _pad_chars(chars, 4)
    blocks = _chars_to_u32_blocks(chars)
    nblocks = lens // 4
    for i in range(blocks.shape[1]):
        h = torch.where(i < nblocks, _mm_update(h, blocks[:, i]), h)
    p = chars.shape[1]
    for j in range(3):
        idx = nblocks * 4 + j
        byte = _pick(chars, idx.clamp(0, p - 1))
        sbyte = ((byte ^ 0x80) - 0x80) & M32    # int8 sign-extended to u32
        h = torch.where(idx < lens, _mm_update(h, sbyte), h)
    return _mm_fmix(h ^ (lens & M32))


# -------------------------------------------------------------- xxhash64

_XXP1 = _signed64(0x9E3779B185EBCA87)
_XXP2 = _signed64(0xC2B2AE3D27D4EB4F)
_XXP3 = _signed64(0x165667B19E3779F9)
_XXP4 = _signed64(0x85EBCA77C2B2AE63)
_XXP5 = _signed64(0x27D4EB2F165667C5)


def _xx_round(v, k):
    return _rotl64(v + k * _XXP2, 31) * _XXP1


def _xx_merge(h, v):
    h = h ^ _xx_round(0, v)
    return h * _XXP1 + _XXP4


def _xx_update8(h, k64):
    h = h ^ _xx_round(0, k64)
    return _rotl64(h, 27) * _XXP1 + _XXP4


def _xx_update4(h, k32):
    h = h ^ (k32 * _XXP1)
    return _rotl64(h, 23) * _XXP2 + _XXP3


def _xx_update1(h, byte):
    h = h ^ (byte * _XXP5)
    return _rotl64(h, 11) * _XXP1


def _xx_finalize(h):
    h = h ^ _shr64(h, 33)
    h = h * _XXP2
    h = h ^ _shr64(h, 29)
    h = h * _XXP3
    return h ^ _shr64(h, 32)


def _xxhash_blocks(h, blocks: Sequence[torch.Tensor], nbytes: int):
    """Element hash of 4 or 8 bytes given as u32 little-endian blocks."""
    h = h + _XXP5 + nbytes
    if nbytes == 8:
        h = _xx_update8(h, blocks[0] | (blocks[1] << 32))
    else:
        h = _xx_update4(h, blocks[0])
    return _xx_finalize(h)


def _xxhash_varbytes(h0, chars: torch.Tensor, lens: torch.Tensor):
    """Spark xxhash64 over per-row byte strings (xxhash64.cu:113-183):
    32-byte stripes on four lanes for rows of 32 bytes or more, then up
    to three 8-byte chunks, one 4-byte chunk and up to three single bytes
    (zero-extended)."""
    chars = _pad_chars(chars, 32)
    p = chars.shape[1]
    b32 = _chars_to_u32_blocks(chars)                       # (rows, p/4)
    b64 = b32[:, 0::2] | (b32[:, 1::2] << 32)               # (rows, p/8)
    nstripes = torch.where(lens >= 32, lens // 32, 0)
    v = [h0 + _XXP1 + _XXP2, h0 + _XXP2, h0, h0 - _XXP1]
    for s in range(p // 32):
        active = s < nstripes
        v = [torch.where(active, _xx_round(v[lane], b64[:, 4 * s + lane]),
                         v[lane]) for lane in range(4)]
    merged = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
              + _rotl64(v[3], 18))
    for lane in range(4):
        merged = _xx_merge(merged, v[lane])
    h = torch.where(nstripes > 0, merged, h0 + _XXP5) + lens

    rem = lens - nstripes * 32
    n8 = rem // 8
    for t in range(3):                  # 8-byte chunks after the stripes
        k64 = _pick(b64, (nstripes * 4 + t).clamp(0, b64.shape[1] - 1))
        h = torch.where(t < n8, _xx_update8(h, k64), h)
    rem4 = rem - n8 * 8
    off4 = (nstripes * 32 + n8 * 8) // 4
    k32 = _pick(b32, off4.clamp(0, b32.shape[1] - 1))
    h = torch.where(rem4 >= 4, _xx_update4(h, k32), h)
    offb = nstripes * 32 + n8 * 8 + torch.where(rem4 >= 4, 4, 0)
    for t in range(3):                  # single bytes
        idx = offb + t
        byte = _pick(chars, idx.clamp(0, p - 1))
        h = torch.where(idx < lens, _xx_update1(h, byte), h)
    return _xx_finalize(h)


# ------------------------------------------------------- byte strings


def _pick(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat[r, idx[r]] of each row, as int64."""
    return mat.gather(1, idx[:, None]).squeeze(1).to(torch.int64)


def _pad_chars(chars: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the char matrix's width to a multiple of `multiple`, at
    least `multiple`."""
    p = chars.shape[1]
    target = max(-(-p // multiple) * multiple, multiple)
    if target != p:
        chars = torch.nn.functional.pad(chars, (0, target - p))
    return chars


def _chars_to_u32_blocks(chars: torch.Tensor) -> torch.Tensor:
    """(rows, P) uint8, P % 4 == 0 -> (rows, P//4) little-endian u32
    blocks in int64 lanes."""
    b = chars.reshape(chars.shape[0], chars.shape[1] // 4, 4).to(torch.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _dec128_min_be_bytes(limbs: torch.Tensor):
    """(rows, 4) int32 little-endian limbs -> ((rows, 16) uint8 minimal
    big-endian two's-complement bytes, left-justified, (rows,) int64
    length): Java BigDecimal.unscaledValue().toByteArray() (reference
    hash.cuh:64-107) strips leading sign bytes, keeps at least one, and
    adds one back where the top bit would flip the sign."""
    u = limbs.to(torch.int64) & M32
    k = torch.arange(16, device=limbs.device)
    le = (u[:, k // 4] >> (8 * (k % 4))) & 0xFF                   # (r, 16)
    neg = limbs[:, 3] < 0
    sign_byte = torch.where(neg, 0xFF, 0)
    significant = torch.where(le != sign_byte[:, None], k, -1)
    length = (significant.max(dim=1).values + 1).clamp(min=1)
    top = _pick(le, length - 1)
    need_sign_byte = (length < 16) & (neg != ((top & 0x80) != 0))
    length = length + need_sign_byte.to(torch.int64)
    src = length[:, None] - 1 - k[None, :]
    be = torch.where(src >= 0, le.gather(1, src.clamp(0, 15)), 0)
    return be.to(torch.uint8), length


# ------------------------------------------------- element hash dispatch


def _split_u64(bits: torch.Tensor):
    """int64 bits -> (lo, hi) u32 blocks in int64 lanes."""
    return bits & M32, _shr64(bits, 32)


def _f32_bits(d: torch.Tensor) -> torch.Tensor:
    return d.view(torch.int32).to(torch.int64) & M32


def _fixed_width_blocks(col: Column, xxhash: bool):
    """(u32 blocks in int64 lanes, nbytes) under Spark hashing rules."""
    kind = col.dtype.kind
    d = col.data
    if kind in (Kind.BOOL8, Kind.UINT8, Kind.INT8, Kind.INT16,
                Kind.INT32, Kind.TIMESTAMP_DAYS):
        # BOOL8/UINT8 zero-extend (uint8 buffer), the signed kinds
        # sign-extend to 32 bits; the mask keeps the u32 image
        return [d.to(torch.int64) & M32], 4
    if kind in (Kind.UINT16, Kind.UINT32):
        signed = dtypes.SIGNED_OF_WIDTH[col.dtype.size_bytes]
        width_mask = (1 << (8 * col.dtype.size_bytes)) - 1
        return [d.view(signed).to(torch.int64) & width_mask], 4
    if kind == Kind.FLOAT32:
        bits = torch.where(torch.isnan(d), floats.F32_QNAN, _f32_bits(d))
        if xxhash:
            # -0.0 -> 0 by bits: a float compare would also zero the
            # denormals where the device flushes them
            bits = torch.where(bits == floats.F32_SIGN, 0, bits)
        return [bits], 4
    if kind == Kind.FLOAT64:
        bits = d.view(torch.int64)
        bits = (floats.normalize_nans_zeros_f64_bits(bits) if xxhash
                else floats.normalize_nans_f64_bits(bits))
        return list(_split_u64(bits)), 8
    if kind in (Kind.INT64, Kind.TIMESTAMP_MICROS, Kind.DECIMAL64):
        return list(_split_u64(d)), 8
    if kind == Kind.UINT64:
        return list(_split_u64(d.view(torch.int64))), 8
    if kind == Kind.DECIMAL32:
        # hashed as an 8-byte long of the unscaled value
        return list(_split_u64(d.to(torch.int64))), 8
    raise NotImplementedError(
        f"hash of {kind} columns is not ported yet (ROADMAP Queue A3: "
        f"LIST and STRUCT)")


def _resolve_str_pad(col: Column, max_str_len: Optional[int]) -> int:
    """Padded char width for a string column.  `max_str_len` is an upper
    bound that must hold for the data: truncating the char matrix while
    keeping the true lengths would give wrong hashes, so a bound below
    the longest string raises."""
    actual = col.max_string_length()
    if max_str_len is None:
        return max(1, actual)
    if max_str_len < actual:
        raise ValueError(
            f"max_str_len={max_str_len} is smaller than the column's "
            f"longest string ({actual} bytes); refusing to truncate")
    return max(1, max_str_len)


def _element_hash(h, col: Column, xxhash: bool,
                  max_str_len: Optional[int]) -> torch.Tensor:
    """Each row's element hash of `col`, seeded by h (nulls not masked)."""
    varbytes = _xxhash_varbytes if xxhash else _murmur_varbytes
    if col.dtype.is_string:
        chars, lens = col.to_padded_chars(_resolve_str_pad(col, max_str_len))
        return varbytes(h, chars, lens.to(torch.int64))
    if col.dtype.kind == Kind.DECIMAL128:
        return varbytes(h, *_dec128_min_be_bytes(col.data))
    blocks, nbytes = _fixed_width_blocks(col, xxhash)
    element = _xxhash_blocks if xxhash else _murmur_blocks
    return element(h, blocks, nbytes)


def _row_hash(table_or_cols, seed: int, xxhash: bool,
              max_str_len: Optional[int]) -> torch.Tensor:
    cols = _cols(table_or_cols)
    if not cols:
        raise ValueError("need at least one column to hash")
    rows = cols[0].length
    seed_bits = (_signed64(seed & (2**64 - 1)) if xxhash
                 else seed & M32)
    h = torch.full((rows,), seed_bits, dtype=torch.int64,
                   device=cols[0].device)
    for c in cols:
        h2 = _element_hash(h, c, xxhash, max_str_len)
        h = h2 if c.validity is None else torch.where(c.validity != 0, h2, h)
    return h


def murmur3_32(table_or_cols, seed: int = 42,
               max_str_len: Optional[int] = None) -> Column:
    """Spark-exact murmur3_32 row hash (reference Hash.java murmurHash32).
    `max_str_len`, if given, bounds every string's length in bytes (it
    raises if a string is longer).  Returns a non-null INT32 column."""
    h = _row_hash(table_or_cols, seed, False, max_str_len)
    return Column(dtypes.INT32, h.shape[0], data=h.to(torch.int32))


def xxhash64(table_or_cols, seed: int = DEFAULT_XXHASH64_SEED,
             max_str_len: Optional[int] = None) -> Column:
    """Spark-exact xxhash64 row hash (reference Hash.java xxhash64).
    `max_str_len` as for murmur3_32.  Returns a non-null INT64 column."""
    h = _row_hash(table_or_cols, seed, True, max_str_len)
    return Column(dtypes.INT64, h.shape[0], data=h)
