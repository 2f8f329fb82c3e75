"""Key ranks and group ids: the helpers GROUP BY, ORDER BY and (with
ROADMAP A7) the join router stand on.

Two ways to turn key columns into canonical integers:

  * the host rank path — per-column int64 ranks in numpy (floats by
    their total-order key, strings by dense lexicographic rank,
    DECIMAL128 by value) and `group_ids_from_ranks` over them; it
    takes every kind, and the group-by's host branch runs on it;
  * the device key path — int64 key columns built on the tensors'
    device (`_device_key_columns`) and `_sorted_gid_core`'s stable
    sorts and adjacent-diff numbering.  It takes fixed-width kinds,
    DECIMAL128 (as two words) and strings (as packed big-endian
    words and the length); the group-by's device branch takes strings
    up to DEVICE_STR_KEY_MAX_LEN bytes, ORDER BY takes them at any
    length.

Both paths order keys the same way, so group ids, and the rows a
group-by emits, come out in the same order on either: floats by
total order, strings as unsigned bytes with a shorter prefix first,
DECIMAL128 as signed 128-bit values, UINT64 as its int64 bits (as the
JAX package's host path ranks it).  The JAX package's device words
compare strings and DECIMAL128 as signed words, which orders bytes
>= 0x80 and DECIMAL128 differently from its host path; the port's
words carry the unsigned order instead (sign bit flipped), so its two
paths agree for every kind.  Nulls are a key column of their own
(mask, then the value zeroed), never a sentinel rank.

The JAX package's native C++ string rank (`utils/native.py`) is left
out: the vectorised packed-word ranking gives the same ranks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.utils import floats

_SIGN = -(1 << 63)
_U32 = 0xFFFFFFFF


# ------------------------------------------------------------ host ranks


def _mask_of(col: Column) -> np.ndarray:
    return (np.ones(col.length, bool) if col.validity is None
            else col.validity.cpu().numpy().astype(bool))


def _string_buf(col: Column) -> np.ndarray:
    return (col.data.cpu().numpy() if col.data is not None
            else np.zeros(0, np.uint8))


_STRING_RANK_WORDS_BUDGET = 256 << 20   # packed-word matrix byte cap


def _string_ranks(chars: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Dense lexicographic ranks (unsigned bytes, a shorter prefix
    first) of an Arrow string buffer: big-endian packed u64 words plus
    the length, ranked together; one word column is gathered at a
    time.  Past the budget (the (rows, words) matrix the ranking
    holds), the exact per-row path."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    if n <= 0:
        return np.zeros(0, np.int64)
    lens = np.diff(offsets)
    k = max(1, (int(lens.max()) + 7) // 8)
    if n * k * 8 > _STRING_RANK_WORDS_BUDGET:
        vals = np.array([chars[offsets[i]:offsets[i + 1]].tobytes()
                         for i in range(n)], dtype=object)
        _, inv = np.unique(vals, return_inverse=True)
        return inv.astype(np.int64)
    # zero pad preserves byte order; the length column puts "a" before
    # "a\x00" (and keeps them apart)
    cols = []
    width = np.arange(8, dtype=np.int64)[None, :]
    last = max(len(chars) - 1, 0)
    src = chars if len(chars) else np.zeros(1, np.uint8)
    for w in range(k):
        pos = width + 8 * w
        idx = np.minimum(offsets[:-1, None] + pos, last)
        part = src[idx] * (pos < lens[:, None])
        cols.append(np.ascontiguousarray(part).view(
            np.dtype(">u8")).astype(np.uint64).reshape(n))
    cols.append(lens.astype(np.uint64))
    ids, _, _ = group_ids_from_ranks(cols)
    return ids.astype(np.int64)


def _raw_values(col: Column) -> np.ndarray:
    """DECIMAL128 rows as python ints (the signed unscaled values)."""
    limbs = col.data.cpu().numpy().astype(np.uint32).astype(object)
    vals = (limbs[:, 0] + (limbs[:, 1] << 32) + (limbs[:, 2] << 64)
            + (limbs[:, 3] << 96))
    return np.where(vals >= (1 << 127), vals - (1 << 128), vals)


def _column_rank_host(col: Column) -> Tuple[np.ndarray, np.ndarray]:
    """(rank int64 array, null mask): ranks order rows like the
    column's natural ordering; null rows get rank 0."""
    kind = col.dtype.kind
    mask = _mask_of(col)
    if kind == Kind.STRING:
        rank = _string_ranks(_string_buf(col), col.offsets.cpu().numpy())
    elif kind == Kind.DECIMAL128:
        _, inv = np.unique(_raw_values(col), return_inverse=True)
        rank = inv.astype(np.int64)
    elif kind in _DEVICE_RANK_KINDS:
        rank = _device_rank(col)[0].cpu().numpy()
    else:
        raise NotImplementedError(
            f"{kind} keys come with nested columns (ROADMAP Queue A1)")
    return np.where(mask, rank, 0), mask


def group_ids_from_ranks(rank_cols):
    """(ids, first_index_per_group, ngroups) from per-column rank
    arrays; ids number the groups in the keys' lexicographic order, and
    a group's first index is its earliest row."""
    n = len(rank_cols[0]) if rank_cols else 0
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    if len(rank_cols) == 1:
        uniq, first_idx, ids = np.unique(
            rank_cols[0], return_index=True, return_inverse=True)
        return ids.astype(np.int64), first_idx, len(uniq)
    order = np.lexsort(tuple(reversed(rank_cols)))
    diff = np.zeros(n, bool)
    for c in rank_cols:
        cs = c[order]
        diff[1:] |= cs[1:] != cs[:-1]
    gid_sorted = np.cumsum(diff)
    ids = np.empty(n, np.int64)
    ids[order] = gid_sorted
    # stable lexsort: the first sorted row of a group is its earliest
    starts = np.concatenate([[0], np.nonzero(diff)[0]])
    return ids, order[starts], int(gid_sorted[-1]) + 1


# ------------------------------------------------------ device key path

# kinds whose rank is an elementwise transform on the device
_DEVICE_RANK_KINDS = frozenset({
    Kind.BOOL8, Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64,
    Kind.UINT8, Kind.UINT16, Kind.UINT32, Kind.UINT64,
    Kind.FLOAT32, Kind.FLOAT64, Kind.TIMESTAMP_DAYS,
    Kind.TIMESTAMP_MICROS, Kind.DECIMAL32, Kind.DECIMAL64})

# Longest string key that goes through the device word sort (one sort
# pass per 8 bytes, plus the length); beyond it the host rank path
DEVICE_STR_KEY_MAX_LEN = 256


def _device_key_kind_ok(c: Column) -> bool:
    """Can this column be a device group-by key?  Fixed-width and
    DECIMAL128 always; strings up to DEVICE_STR_KEY_MAX_LEN bytes."""
    kind = c.dtype.kind
    if kind in _DEVICE_RANK_KINDS or kind == Kind.DECIMAL128:
        return True
    if kind == Kind.STRING:
        return c.max_string_length() <= DEVICE_STR_KEY_MAX_LEN
    return False


def _as_int64(data: torch.Tensor, kind: str) -> torch.Tensor:
    """Integer values in int64 lanes: unsigned kinds below 64 bits by
    value, UINT64 by its bits."""
    if kind in (Kind.UINT16, Kind.UINT32):
        width = data.element_size() * 8
        signed = torch.int16 if width == 16 else torch.int32
        return data.view(signed).to(torch.int64) & ((1 << width) - 1)
    if kind == Kind.UINT64:
        return data.view(torch.int64)
    return data.to(torch.int64)


def _from_int64(v: torch.Tensor, dtype) -> torch.Tensor:
    """int64 lanes into ``dtype``'s torch dtype, wrapping to its width
    as numpy's astype does."""
    width = dtype.size_bytes * 8
    if width < 64:
        half = 1 << (width - 1)
        v = ((v + half) & ((1 << width) - 1)) - half
    signed = {8: torch.int8, 16: torch.int16, 32: torch.int32,
              64: torch.int64}[width]
    return v.to(signed).view(dtype.torch_dtype)


def _device_rank(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 rank, bool mask) on the column's device: injective per
    value and in the column's order (floats by total order)."""
    kind = col.dtype.kind
    if kind == Kind.FLOAT64:
        r = floats.total_order_key(col.data)
    elif kind == Kind.FLOAT32:
        r = floats.f32_order_key(col.data)
    else:
        r = _as_int64(col.data, kind)
    mask = (torch.ones(col.length, dtype=torch.bool, device=r.device)
            if col.validity is None else col.validity != 0)
    return r, mask


def _ordered_word(hi32: torch.Tensor, lo32: torch.Tensor) -> torch.Tensor:
    """The u64 (hi32 << 32 | lo32) with its sign bit flipped, as int64:
    signed order of the result is the unsigned order of the word.
    Both halves are int64 in [0, 2^32); no step overflows."""
    return (hi32 - (1 << 31)) * (1 << 32) + lo32


def _string_words(col: Column, pad_to: int) -> List[torch.Tensor]:
    """String keys as packed big-endian u64 word columns (sign bit
    flipped, see _ordered_word) plus the byte length: zero padding
    alone would conflate "a" and "a\\x00".  Each word column is
    gathered on its own (eight bytes a row), so the peak is the words
    themselves, not a (rows, pad_to) index matrix."""
    lens = col.string_lengths().to(torch.int64)
    dev = lens.device
    starts = col.offsets[:-1].to(torch.int64)
    chars = (col.data if col.data is not None and col.data.numel()
             else torch.zeros(1, dtype=torch.uint8, device=dev))
    last = chars.shape[0] - 1
    pos = torch.arange(8, dtype=torch.int64, device=dev)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=dev)
    words = []
    for w in range((max(pad_to, 1) + 7) // 8):
        p = pos + 8 * w
        b = chars[(starts[:, None] + p).clamp_(0, last)].to(torch.int64)
        b = torch.where(p < lens[:, None], b, 0)
        words.append(_ordered_word((b[:, :4] << shifts).sum(dim=1),
                                   (b[:, 4:] << shifts).sum(dim=1)))
    return words + [lens]


def _decimal_words(col: Column) -> List[torch.Tensor]:
    """DECIMAL128 keys as (high word signed, low word as unsigned with
    its sign bit flipped): lexicographic order is the value's order."""
    limbs = col.data.to(torch.int64)
    lo = _ordered_word(limbs[:, 1] & _U32, limbs[:, 0] & _U32)
    hi = limbs[:, 3] * (1 << 32) + (limbs[:, 2] & _U32)
    return [hi, lo]


def _device_equality_cols(col: Column, pad_to: int = 0
                          ) -> Optional[List[torch.Tensor]]:
    """int64 key columns for one column on its device, or None when the
    kind has no device path."""
    kind = col.dtype.kind
    if kind in _DEVICE_RANK_KINDS:
        return [_device_rank(col)[0]]
    if kind == Kind.STRING:
        return _string_words(col, pad_to)
    if kind == Kind.DECIMAL128:
        return _decimal_words(col)
    return None


def _device_key_columns(columns) -> List[torch.Tensor]:
    """int64 key columns for the sorted-gid core.  A column with a
    validity contributes its mask before its values (zeroed where
    null); an all-valid column skips the mask, one sort pass fewer."""
    cols: List[torch.Tensor] = []
    for c in columns:
        pad = c.max_string_length() if c.dtype.is_string else 0
        vals = _device_equality_cols(c, pad)
        if vals is None:
            raise ValueError(f"no device key path for {c.dtype}")
        if c.validity is not None:
            m = c.validity != 0
            cols.append(m.to(torch.int64))
            cols.extend(torch.where(m, v, 0) for v in vals)
        else:
            cols.extend(vals)
    return cols


def _lex_order(cols) -> torch.Tensor:
    """The stable lexicographic sort permutation of int64 key columns
    (the first most significant): one stable pass a column, the last
    first."""
    order = None
    for c in reversed(cols):
        o = torch.sort(c if order is None else c[order], stable=True).indices
        order = o if order is None else order[o]
    return order


def _sorted_gid_core(cols) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, gid_sorted): the key columns' stable lexicographic order
    and the group number of each sorted row (adjacent-diff cumsum)."""
    order = _lex_order(cols)
    diff = torch.zeros(cols[0].shape[0], dtype=torch.bool,
                       device=cols[0].device)
    for c in cols:
        cs = c[order]
        diff[1:] |= cs[1:] != cs[:-1]
    return order, torch.cumsum(diff, 0)
