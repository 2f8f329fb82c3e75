"""Join primitives (reference join_primitives.hpp, JoinPrimitives.java):
sort_merge_inner_join / hash_inner_join -> (left_indices, right_indices)
gather maps, the index transforms make_left_outer / make_full_outer /
make_semi / make_anti / get_matched_rows and conditional pair
filtering; and the key ranks and group ids that the joins, GROUP BY and
ORDER BY stand on.

The inner join has four engines that give the same int32 pairs in the
same order (grouped by left row ascending, right indices ascending
within each group):

  * ``host_rank``: joint host ranks of both sides' keys (dense group
    ids), a stable argsort of the right ids and each left row's run
    gathered from the ids' counts; every key kind, and the
    differential oracle of the other three;
  * ``host_hash``: ops/hash_join.host_hash_join, a numpy bucket table
    over the device word encoding;
  * ``device_sort``: the joint device ids (a single all-valid
    fixed-width key is its own id; others pay the sorted-gid pass),
    the pair count from one sort and two searchsorteds, then
    ops/device_join.inner_join_device at that count rounded up to a
    power of two;
  * ``device_hash``: ops/hash_join.device_hash_join, xxhash64 ids
    through the same probe with a fused verify and a learned capacity.

`sort_merge_inner_join` routes: keys without a word encoding (a kind
mismatch, strings over DEVICE_STR_KEY_MAX_LEN) take host_rank;
``SPARK_RAPIDS_TPU_FORCE_DEVICE_JOIN=1`` forces device_sort; a pin
``SPARK_RAPIDS_TPU_PATH_JOIN_INNER=<engine>`` wins next; under
JOIN_CALIBRATE_MIN_ROWS rows, device_sort on a CUDA device and
host_rank on the CPU; above, perf/calibrate.pick_path times the four
on a sample and caches the verdict per schema, size class and device.
The host engines copy the key words to the host once and return their
pairs on the keys' device.

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
(mask, then the value zeroed), never a sentinel rank.  Float keys
compare by their bits, as in the JAX package: -0.0 does not match 0.0,
and a NaN matches only a NaN of the same bits.

The JAX package's native C++ string rank (`utils/native.py`) is left
out: the vectorised packed-word ranking gives the same ranks.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops.device_join import inner_join_device
from spark_rapids_tpu_torch.utils import floats

NULL_EQUAL = "EQUAL"
NULL_UNEQUAL = "UNEQUAL"

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
    # a column equal on every row (the mask of a column without nulls)
    # neither orders nor splits a group: one sort pass fewer
    rank_cols = ([c for c in rank_cols if c.min() != c.max()]
                 or rank_cols[:1])
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


# ------------------------------------------------------------ join engines


def _key_ids(left: Table, right: Table, compare_nulls: str):
    """Host canonical id per row of left and right (equal keys <=> equal
    id), plus per-row key validity (any null key under UNEQUAL = no
    match).  Strings and DECIMAL128 are ranked jointly over both
    sides."""
    nl, nr = left.num_rows, right.num_rows
    ranks = []
    valid_l = np.ones(nl, bool)
    valid_r = np.ones(nr, bool)
    for lc, rc in zip(left.columns, right.columns):
        if lc.dtype.kind != rc.dtype.kind:
            raise ValueError("join key dtypes must match")
        if lc.dtype.kind == Kind.STRING:
            lm, rm = _mask_of(lc), _mask_of(rc)
            loffs = lc.offsets.cpu().numpy().astype(np.int64)
            roffs = rc.offsets.cpu().numpy().astype(np.int64)
            # both sides' rows back to back in one buffer, whatever
            # their offsets start at
            chars = np.concatenate([_string_buf(lc)[:loffs[-1]],
                                    _string_buf(rc)[roffs[0]:roffs[-1]]])
            offsets = np.concatenate([loffs, roffs[1:] - roffs[0]
                                      + loffs[-1]])
            inv = _string_ranks(chars, offsets)
            lr, rr = inv[:nl], inv[nl:]
        elif lc.dtype.kind == Kind.DECIMAL128:
            lm, rm = _mask_of(lc), _mask_of(rc)
            _, inv = np.unique(np.concatenate([_raw_values(lc),
                                               _raw_values(rc)]),
                               return_inverse=True)
            lr, rr = inv[:nl].astype(np.int64), inv[nl:].astype(np.int64)
        else:
            lr, lm = _column_rank_host(lc)
            rr, rm = _column_rank_host(rc)
        # the mask is a key column of its own and null rows zero their
        # value: no sentinel can collide with a legal rank
        ranks.append((lm.astype(np.int64), rm.astype(np.int64)))
        ranks.append((np.where(lm, lr, np.int64(0)),
                      np.where(rm, rr, np.int64(0))))
        if compare_nulls == NULL_UNEQUAL:
            valid_l &= lm
            valid_r &= rm
    combined = [np.concatenate([a, b]) for a, b in ranks]
    if combined and len(combined[0]):
        ids, _, _ = group_ids_from_ranks(combined)
    else:
        ids = np.zeros(nl + nr, np.int64)
    return ids[:nl], ids[nl:], valid_l, valid_r


def _keys_device(left: Table, right: Table) -> torch.device:
    for t in (left, right):
        if t.columns:
            return t.device
    return torch.device("cpu")


def _empty_pairs(dev) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    return z, z


def _col_mask(c: Column) -> torch.Tensor:
    return (torch.ones(c.length, dtype=torch.bool, device=c.device)
            if c.validity is None else c.validity != 0)


def _ids_from_cols(cols) -> torch.Tensor:
    """Per-row group id from the sorted-gid core over int64 columns."""
    order, gid_sorted = _sorted_gid_core(cols)
    ids = torch.empty(cols[0].shape[0], dtype=torch.int64,
                      device=order.device)
    ids[order] = gid_sorted
    return ids


def _device_ids(left: Table, right: Table, compare_nulls: str):
    """Per-row equality ids over the joined key columns, on their
    device.  The join core needs only an injective int64 key, so a
    single all-valid fixed-width key column IS its own id, with no
    sort; multi-word encodings (strings, DECIMAL128) and nullable keys
    pay for the sorted-gid pass over both sides together."""
    nl, nr = left.num_rows, right.num_rows
    key_cols = []
    vl = torch.ones(nl, dtype=torch.bool, device=left.device)
    vr = torch.ones(nr, dtype=torch.bool, device=right.device)
    for lc, rc in zip(left.columns, right.columns):
        pad = (max(lc.max_string_length(), rc.max_string_length())
               if lc.dtype.kind == Kind.STRING else 0)
        lvals = _device_equality_cols(lc, pad)
        rvals = _device_equality_cols(rc, pad)
        nullable = lc.validity is not None or rc.validity is not None
        if nullable or compare_nulls == NULL_UNEQUAL:
            lm, rm = _col_mask(lc), _col_mask(rc)
        if nullable:
            key_cols.append(torch.cat([lm, rm]).to(torch.int64))
            key_cols.extend(
                torch.cat([torch.where(lm, lv, 0), torch.where(rm, rv, 0)])
                for lv, rv in zip(lvals, rvals))
        else:
            key_cols.extend(torch.cat([lv, rv])
                            for lv, rv in zip(lvals, rvals))
        if compare_nulls == NULL_UNEQUAL:
            vl = vl & lm
            vr = vr & rm
    ids = key_cols[0] if len(key_cols) == 1 else _ids_from_cols(key_cols)
    return ids[:nl], ids[nl:], vl, vr


def _device_join_total(lid, rid, lval, rval) -> torch.Tensor:
    """Count-only half of inner_join_device: one sort and two
    searchsorteds (no reverse map, no pair expansion).  Invalid right
    keys sort last as INT64_MAX; the clamp to the valid count keeps a
    valid INT64_MAX key from counting them."""
    r_sortkey = torch.where(rval, rid, 2**63 - 1)
    rk_sorted = torch.sort(r_sortkey).values
    n_valid_r = rval.sum()
    lo = torch.minimum(torch.searchsorted(rk_sorted, lid), n_valid_r)
    hi = torch.minimum(torch.searchsorted(rk_sorted, lid, right=True),
                       n_valid_r)
    return torch.where(lval, hi - lo, 0).sum()


def _sort_merge_inner_join_device(left: Table, right: Table,
                                  compare_nulls: str):
    """Device sort engine: ids, the pair count (the only value that
    crosses to the host, to size the output), then the pairs at the
    count rounded up to a power of two, sliced to the count."""
    nl, nr = left.num_rows, right.num_rows
    if nl == 0 or nr == 0 or not left.columns:
        return _empty_pairs(_keys_device(left, right))
    lid, rid, lval, rval = _device_ids(left, right, compare_nulls)
    total = int(_device_join_total(lid, rid, lval, rval))
    if total == 0:
        return _empty_pairs(lid.device)
    cap = 1 << (total - 1).bit_length()
    pairs = inner_join_device(lid, rid, cap, lval, rval)
    # with capacity >= total the first `total` slots are exactly the
    # pairs, in (left row, right row) order, as the host oracle lays
    # them out
    return pairs.left_indices[:total], pairs.right_indices[:total]


def _sort_merge_inner_join_host(left_keys: Table, right_keys: Table,
                                compare_nulls: str = NULL_EQUAL
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host rank engine (every key kind), and the executable oracle of
    the other engines' differential tests."""
    lid, rid, lval, rval = _key_ids(left_keys, right_keys, compare_nulls)
    nl = left_keys.num_rows
    # bucket right rows by id (rows invalid under UNEQUAL leave the
    # buckets); the ids are dense, so each left row's run in the sorted
    # right side is a gather from the buckets' counts and starts, where
    # the JAX package binary-searches the sorted ids
    order_r = np.argsort(rid, kind="stable")
    if compare_nulls == NULL_UNEQUAL and not rval.all():
        order_r = order_r[rval[order_r]]
    ngroups = 1 + max(lid.max(initial=-1), rid.max(initial=-1))
    rcounts = np.bincount(rid[order_r], minlength=ngroups)
    rstarts = np.cumsum(rcounts) - rcounts
    starts = rstarts[lid]
    counts = rcounts[lid]
    if compare_nulls == NULL_UNEQUAL:
        counts = np.where(lval, counts, 0)
    total = int(counts.sum())
    left_out = np.repeat(np.arange(nl), counts)
    offs = np.zeros(nl + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    pos = np.arange(total) - offs[left_out]
    right_out = order_r[starts[left_out] + pos]
    dev = _keys_device(left_keys, right_keys)
    return (torch.from_numpy(left_out.astype(np.int32)).to(dev),
            torch.from_numpy(right_out.astype(np.int32)).to(dev))


def _host_hash_inner_join(left_keys: Table, right_keys: Table,
                          compare_nulls: str):
    """Host hash engine: the word encoding copied to the host once, the
    numpy bucket table, the pairs back on the keys' device."""
    from spark_rapids_tpu_torch.ops import hash_join as HJ
    lwords, rwords, vl, vr, _extra = HJ.join_key_words(
        left_keys, right_keys, compare_nulls)
    li, ri = HJ.host_hash_join(
        [w.cpu().numpy() for w in lwords], [w.cpu().numpy() for w in rwords],
        vl.cpu().numpy(), vr.cpu().numpy())
    dev = _keys_device(left_keys, right_keys)
    return torch.from_numpy(li).to(dev), torch.from_numpy(ri).to(dev)


def _device_hash_inner_join(left_keys: Table, right_keys: Table,
                            compare_nulls: str):
    from spark_rapids_tpu_torch.ops import hash_join as HJ
    lwords, rwords, vl, vr, extra = HJ.join_key_words(
        left_keys, right_keys, compare_nulls)
    return HJ.device_hash_join(lwords, rwords, vl, vr, extra)


# rows (larger side) at or above this count earn a measured path pick;
# below it the static default is cheaper than timing anything
JOIN_CALIBRATE_MIN_ROWS = 1 << 15

JOIN_PATHS = ("host_rank", "host_hash", "device_sort", "device_hash")


def _join_engines():
    """Name -> engine.  Dict order is the calibration's measurement
    order: expected-fast engines first, the rank oracle LAST, so a slow
    oracle that trips the calibration budget can only lose to measured
    candidates, never win by starving them."""
    return {
        "host_hash": _host_hash_inner_join,
        "device_sort": _sort_merge_inner_join_device,
        "device_hash": _device_hash_inner_join,
        "host_rank": _sort_merge_inner_join_host,
    }


def _join_sample(table: Table, rows: int) -> Table:
    if table.num_rows <= rows:
        return table
    from spark_rapids_tpu_torch.ops.copying import slice_table
    return slice_table(table, 0, rows)


def sort_merge_inner_join(left_keys: Table, right_keys: Table,
                          compare_nulls: str = NULL_EQUAL
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 (left_indices, right_indices) gather maps of the matching
    row pairs (join_primitives.hpp:64), on the keys' device: grouped by
    left row ascending, right indices ascending within each group,
    whichever engine runs (see the module docstring for the routing).
    Calibration samples 2^18 left by 2^20 right rows: the build side's
    size class stays in the verdict's digest, and a bounded sample keeps
    the first large join from stalling on four engines' timings."""
    from spark_rapids_tpu_torch.perf import calibrate
    from spark_rapids_tpu_torch.perf.jit_cache import schema_digest

    nl, nr = left_keys.num_rows, right_keys.num_rows
    rows = max(nl, nr)
    device_ok = (
        len(left_keys.columns) == len(right_keys.columns)
        and all(lc.dtype.kind == rc.dtype.kind
                and _device_key_kind_ok(lc) and _device_key_kind_ok(rc)
                for lc, rc in zip(left_keys.columns, right_keys.columns)))
    on_card = _keys_device(left_keys, right_keys).type == "cuda"
    engines = _join_engines()
    if not device_ok or not left_keys.columns:
        path = "host_rank"
    elif os.environ.get("SPARK_RAPIDS_TPU_FORCE_DEVICE_JOIN") == "1":
        path = "device_sort"
    else:
        pin = calibrate.pinned_path("join.inner")
        if pin is not None and pin in engines:
            path = pin
        elif rows < JOIN_CALIBRATE_MIN_ROWS:
            path = "device_sort" if on_card else "host_rank"
        else:
            # both sides' schemas and size classes key the verdict: the
            # winner flips with how much of the build side stays cached
            nulls = [lc.validity is not None or rc.validity is not None
                     for lc, rc in zip(left_keys.columns,
                                       right_keys.columns)]
            digest = calibrate.operands_digest(
                [(schema_digest([c.dtype for c in left_keys.columns],
                                nulls), nl),
                 (schema_digest([c.dtype for c in right_keys.columns],
                                nulls), nr)],
                extra=f"join:{compare_nulls}")
            sl = _join_sample(left_keys, 1 << 18)
            sr = _join_sample(right_keys, 1 << 20)
            candidates = {
                name: (lambda fn=fn: fn(sl, sr, compare_nulls))
                for name, fn in engines.items()}
            path = calibrate.pick_path(
                "join.inner", digest, candidates,
                default="device_sort" if on_card else "host_hash",
                device=left_keys.device)
            if path not in engines:
                path = "host_rank"
    # ROADMAP A14: the JAX package counts the path taken here
    # (observability.record_kernel_path)
    return engines[path](left_keys, right_keys, compare_nulls)


def hash_inner_join(left_keys: Table, right_keys: Table,
                    compare_nulls: str = NULL_EQUAL):
    """The reference's hash_inner_join (join_primitives.hpp:87): the
    router above owns the hash engines too, so both entries share its
    calibrated pick."""
    return sort_merge_inner_join(left_keys, right_keys, compare_nulls)


# ------------------------------------------------------ index transforms


def _matched(indices: torch.Tensor, num_rows: int) -> torch.Tensor:
    matched = torch.zeros(num_rows, dtype=torch.bool, device=indices.device)
    matched[indices.to(torch.int64)] = True
    return matched


def filter_join_pairs(left_indices: torch.Tensor,
                      right_indices: torch.Tensor, predicate):
    """Keep the pairs where ``predicate`` (bool per pair) holds
    (join_primitives.hpp's conditional filtering: the caller evaluates
    the predicate over the gathered pair columns)."""
    keep = torch.as_tensor(predicate, device=left_indices.device).to(
        torch.bool)
    return left_indices[keep], right_indices[keep]


def make_left_outer(left_indices, right_indices, left_num_rows: int):
    """Add unmatched left rows with right index -1, the null sentinel
    (join_primitives.hpp:145)."""
    missing = torch.nonzero(~_matched(left_indices, left_num_rows)).squeeze(
        1).to(left_indices.dtype)
    return (torch.cat([left_indices, missing]),
            torch.cat([right_indices, torch.full_like(
                missing, -1, dtype=right_indices.dtype)]))


def make_full_outer(left_indices, right_indices, left_num_rows: int,
                    right_num_rows: int):
    """Unmatched rows of both sides with -1 sentinels
    (join_primitives.hpp:169)."""
    lmiss = torch.nonzero(~_matched(left_indices, left_num_rows)).squeeze(
        1).to(left_indices.dtype)
    rmiss = torch.nonzero(~_matched(right_indices, right_num_rows)).squeeze(
        1).to(right_indices.dtype)
    return (torch.cat([left_indices, lmiss, torch.full_like(
                rmiss, -1, dtype=left_indices.dtype)]),
            torch.cat([right_indices, torch.full_like(
                lmiss, -1, dtype=right_indices.dtype), rmiss]))


def make_semi(left_indices, left_num_rows: int) -> torch.Tensor:
    """Distinct left rows with at least one match
    (join_primitives.hpp:194)."""
    return torch.nonzero(_matched(left_indices, left_num_rows)).squeeze(
        1).to(torch.int32)


def make_anti(left_indices, left_num_rows: int) -> torch.Tensor:
    """Left rows with no match (join_primitives.hpp:213)."""
    return torch.nonzero(~_matched(left_indices, left_num_rows)).squeeze(
        1).to(torch.int32)


def get_matched_rows(indices, num_rows: int) -> Column:
    """BOOL8 column marking the rows present in the gather map (its -1
    sentinels left out; join_primitives.hpp:237)."""
    matched = _matched(indices[indices >= 0], num_rows)
    return Column(dtypes.BOOL8, num_rows, data=matched.to(torch.uint8))
