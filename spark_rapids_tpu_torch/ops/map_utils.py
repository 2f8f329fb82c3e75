"""Map column utilities (reference map_utils.hpp / map.hpp /
map_zip_with_utils.hpp, Map.java / MapUtils.java / GpuMapZipWithUtils):
maps are LIST<STRUCT<key, value>> columns with Spark semantics.

The entry order of each map is decided on the host from the keys' ranks
(ops/joins._column_rank_host); the entries themselves move with one
device gather per child, so every result lives on its input's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.ops.copying import concat_columns, gather
from spark_rapids_tpu_torch.ops.exceptions import ExceptionWithRowIndex
from spark_rapids_tpu_torch.ops.joins import _column_rank_host


def _entries(col: Column) -> Tuple[Column, Column, Column]:
    assert col.dtype.kind == Kind.LIST
    st = col.children[0]
    assert st.dtype.kind == Kind.STRUCT and len(st.children) == 2
    return st, st.children[0], st.children[1]


def _host_mask(col: Column) -> np.ndarray:
    return (np.ones(col.length, bool) if col.validity is None
            else col.validity.cpu().numpy().astype(bool))


def _index(take, device) -> torch.Tensor:
    return torch.tensor(np.asarray(take, np.int64), dtype=torch.int64,
                        device=device)


def _list(rows: int, validity, offsets, child: Column) -> Column:
    return Column(dtypes.LIST, rows, validity=validity, offsets=offsets,
                  children=(child,))


def _offsets(new_offs: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(new_offs.astype(np.int32)).to(device)


def is_valid_map(col: Column, throw_on_null_key: bool = False) -> bool:
    """True when every entry struct is non-null and every key is non-null
    (map_utils.hpp:58)."""
    st, keys, _ = _entries(col)
    if not _host_mask(st).all():
        return False
    kmask = _host_mask(keys)
    if not kmask.all():
        if throw_on_null_key:
            raise ExceptionWithRowIndex(int(np.argmin(kmask)),
                                        "null map key")
        return False
    return True


def map_from_entries(col: Column, throw_on_null_key: bool = True
                     ) -> Column:
    """LIST<STRUCT<K,V>> -> valid Spark map: null keys throw (or drop),
    duplicate keys keep the LAST occurrence (Spark LAST_WIN policy),
    entry order of first occurrence preserved (map_utils.hpp:97)."""
    st, keys, vals = _entries(col)
    offs = col.offsets.cpu().numpy()
    key_ranks, key_mask = _column_rank_host(keys)
    st_mask = _host_mask(st)
    row_mask = _host_mask(col)
    if throw_on_null_key and not key_mask.all():
        # only entries under valid rows AND valid structs count
        for row in range(col.length):
            if not row_mask[row]:
                continue
            for e in range(offs[row], offs[row + 1]):
                if st_mask[e] and not key_mask[e]:
                    raise ExceptionWithRowIndex(row, "null map key")
    take = []
    new_offs = np.zeros(col.length + 1, np.int32)
    for row in range(col.length):
        seen = {}
        if row_mask[row]:
            for e in range(offs[row], offs[row + 1]):
                if not st_mask[e] or not key_mask[e]:
                    continue  # drop null entries/keys (non-throw mode)
                seen[key_ranks[e]] = e    # last occurrence wins
        take.extend(seen.values())
        new_offs[row + 1] = len(take)
    dev = col.device
    idx = _index(take, dev)
    new_st = Column.make_struct(len(take),
                                [gather(keys, idx), gather(vals, idx)])
    return _list(col.length, col.validity, _offsets(new_offs, dev),
                 new_st)


def sort_map_column(col: Column, descending: bool = False) -> Column:
    """Sort each map's entries by key (map.hpp:39 sort_map_column)."""
    st, keys, vals = _entries(col)
    offs = col.offsets.cpu().numpy()
    key_ranks, _ = _column_rank_host(keys)
    take = []
    for row in range(col.length):
        es = list(range(offs[row], offs[row + 1]))
        es.sort(key=lambda e: key_ranks[e], reverse=descending)
        take.extend(es)
    idx = _index(take, col.device)
    new_st = Column(dtypes.STRUCT, len(take),
                    validity=None if st.validity is None or not take
                    else st.validity[idx],
                    children=(gather(keys, idx), gather(vals, idx)))
    return _list(col.length, col.validity, col.offsets, new_st)


def map_zip(keys_list: Column, a_vals: Column, b_vals: Column) -> Column:
    """Zip aligned LIST columns into LIST<STRUCT<key, a, b>> -- the
    map_zip_with building block (map_zip_with_utils.hpp:60); the three
    lists must share offsets."""
    for c in (keys_list, a_vals, b_vals):
        assert c.dtype.kind == Kind.LIST
    ko = keys_list.offsets
    if not (torch.equal(ko, a_vals.offsets)
            and torch.equal(ko, b_vals.offsets)):
        raise ValueError("map_zip requires aligned list offsets")
    st = Column.make_struct(
        keys_list.children[0].length,
        [keys_list.children[0], a_vals.children[0], b_vals.children[0]])
    return _list(keys_list.length, keys_list.validity, keys_list.offsets,
                 st)


def _all_null_like(src: Column, n: int) -> Column:
    """n all-null rows shaped like src (src may be zero-length)."""
    dev = src.device
    zeros = torch.zeros(n, dtype=torch.uint8, device=dev)
    if src.dtype.kind == Kind.LIST:
        return _list(n, zeros, torch.zeros(n + 1, dtype=torch.int32,
                                           device=dev), src.children[0])
    if src.dtype.kind == Kind.STRUCT:
        return Column(dtypes.STRUCT, n, validity=zeros,
                      children=tuple(_all_null_like(c, n)
                                     for c in src.children))
    return Column.from_pylist([None] * n, src.dtype, dev)


def _gather_opt(src: Column, take) -> Column:
    """src rows at `take`, null where take is -1."""
    t = np.asarray(take, np.int64)
    if src.length == 0:
        # one side contributed no entries at all: every take is -1
        return _all_null_like(src, len(t))
    present = torch.from_numpy(t >= 0).to(src.device)
    g = gather(src, _index(np.where(t >= 0, t, 0), src.device))
    base = present if g.validity is None else \
        g.validity.to(torch.bool) & present
    return Column(g.dtype, g.length, data=g.data,
                  validity=base.to(torch.uint8), offsets=g.offsets,
                  children=g.children)


def map_zip_full(col1: Column, col2: Column) -> Column:
    """Spark map_zip_with key alignment (map_zip_with_utils.cu:356-420
    map_zip; GpuMapZipWithUtils.mapZip): per row, take the distinct
    union of both maps' keys (col1's keys in first-appearance order,
    then col2's new keys), and for each key build STRUCT<value1, value2>
    where a side's value is null when that map lacks the key.  Result
    row validity is the AND of the input validities."""
    st1, k1, v1 = _entries(col1)
    st2, k2, v2 = _entries(col2)
    assert col1.length == col2.length
    all_keys = concat_columns([k1, k2])
    ranks, _ = _column_rank_host(all_keys)
    r1, r2 = ranks[:k1.length], ranks[k1.length:]
    o1 = col1.offsets.cpu().numpy()
    o2 = col2.offsets.cpu().numpy()
    row_mask = _host_mask(col1) & _host_mask(col2)
    key_take = []          # index into the concatenated key column
    take1, take2 = [], []  # value gathers; -1 = absent
    new_offs = np.zeros(col1.length + 1, np.int32)
    for row in range(col1.length):
        if row_mask[row]:
            pos = {}   # rank -> output slot
            for e in range(o1[row], o1[row + 1]):
                if r1[e] not in pos:
                    pos[r1[e]] = len(key_take)
                    key_take.append(e)
                    take1.append(e)
                    take2.append(-1)
                else:
                    take1[pos[r1[e]]] = e  # duplicate key: last wins
            for e in range(o2[row], o2[row + 1]):
                if r2[e] not in pos:
                    pos[r2[e]] = len(key_take)
                    key_take.append(k1.length + e)
                    take1.append(-1)
                    take2.append(e)
                else:
                    take2[pos[r2[e]]] = e
        new_offs[row + 1] = len(key_take)

    dev = col1.device
    # key_take never holds -1, so a plain gather over the concatenation
    # already built for ranking is enough
    keys_out = gather(all_keys, _index(key_take, dev))
    pair = Column.make_struct(len(key_take),
                              [_gather_opt(v1, take1),
                               _gather_opt(v2, take2)])
    st = Column.make_struct(len(key_take), [keys_out, pair])
    return _list(col1.length,
                 torch.from_numpy(row_mask.astype(np.uint8)).to(dev),
                 _offsets(new_offs, dev), st)
