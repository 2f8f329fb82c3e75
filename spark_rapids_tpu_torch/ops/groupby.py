"""GROUP BY aggregation over columns: one output row per distinct key,
the keys then one column per (value, aggregate).

Group ids come from the key helpers in ops/joins.py by one of two
branches, which give the same ids:

  * the device branch, on CUDA tensors whose keys the device key path
    takes (fixed-width, DECIMAL128, strings up to 256 bytes): stable
    sorts and adjacent-diff numbering, then each group's first row
    from a scatter-min; only the group count crosses to the host;
  * the host rank branch, for longer strings and for CPU tensors.
    ``SPARK_RAPIDS_TPU_FORCE_DEVICE_GROUPBY=1`` sends CPU tensors down
    the device branch.

Groups come out in key order (nulls first), each key row the group's
earliest.  Nulls group together; null values are left out of every
aggregate, and count counts the non-null values.  Integer SUM wraps in
int64 (Java semantics); ops/aggregation64.py detects the overflow.
Float MIN/MAX reduce total-order keys, so they return an input's exact
bits (NaN payloads, -0.0 against 0.0).  Float SUM/MEAN add in float64:
on the CPU in row order, byte-equal to the JAX package; on the card
with atomics, whose order varies, so there they are held to a bound
(see tests/test_torch_gpu.py).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import joins as J
from spark_rapids_tpu_torch.ops.copying import gather_table
from spark_rapids_tpu_torch.utils import floats

SUM = "sum"
COUNT = "count"
MIN = "min"
MAX = "max"
MEAN = "mean"

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _group_ids_device(keys: Table):
    """Device branch of _group_ids (same return contract)."""
    cols = J._device_key_columns(keys.columns)
    n = keys.num_rows
    order, gid_sorted = J._sorted_gid_core(cols)
    ids = torch.empty(n, dtype=torch.int64, device=order.device)
    ids[order] = gid_sorted
    ngroups = int(gid_sorted[-1]) + 1
    first = torch.full((ngroups,), n, dtype=torch.int64,
                       device=order.device)
    first.scatter_reduce_(0, ids, torch.arange(n, device=order.device),
                          "amin")
    return ids.to(torch.int32), first, ngroups


def _group_ids_host(keys: Table):
    """Host rank branch of _group_ids: every kind; the device branch's
    differential oracle."""
    cols = []
    for c in keys.columns:
        rank, mask = J._column_rank_host(c)
        cols.append(mask.astype(np.int64))
        cols.append(rank)
    ids, first_idx, ngroups = J.group_ids_from_ranks(cols)
    dev = keys.device
    return (torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(first_idx.astype(np.int64)).to(dev), ngroups)


def _group_ids(keys: Table) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(per-row group id int32, first row of each group int64,
    number of groups), on the keys' device."""
    if not keys.columns:
        return (torch.zeros(0, dtype=torch.int32),
                torch.zeros(0, dtype=torch.int64), 0)
    use_device = (keys.device.type == "cuda"
                  or os.environ.get(
                      "SPARK_RAPIDS_TPU_FORCE_DEVICE_GROUPBY") == "1")
    if (use_device and keys.num_rows > 0
            and all(J._device_key_kind_ok(c) for c in keys.columns)):
        return _group_ids_device(keys)
    return _group_ids_host(keys)


def groupby_aggregate(keys: Table, values: Sequence[Column],
                      aggs: Sequence[str]) -> Table:
    """One output row per distinct key; columns = keys then one per
    (value, agg) pair, agg in sum, count, min, max and mean."""
    if len(values) != len(aggs):
        raise ValueError("values and aggs must align")
    ids, first_idx, ngroups = _group_ids(keys)
    out_cols: List[Column] = list(gather_table(keys, first_idx).columns)
    ids = ids.to(torch.int64)
    for col, agg in zip(values, aggs):
        out_cols.append(_aggregate_one(col, agg, ids, ngroups))
    names = None
    if keys.names is not None:
        names = list(keys.names) + [f"agg{i}" for i in range(len(values))]
    return Table(out_cols, names)


def _seg_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
        0, ids, x)


def _seg_reduce(x: torch.Tensor, ids: torch.Tensor, n: int, agg: str,
                fill: int) -> torch.Tensor:
    """Per-group min or max of int64 ``x``; ``fill`` where a group has
    only nulls (they carry ``fill`` already)."""
    out = torch.full((n,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, ids, x, "amin" if agg == MIN else "amax")


def _aggregate_one(col: Column, agg: str, ids: torch.Tensor,
                   ngroups: int) -> Column:
    kind = col.dtype.kind
    valid = (torch.ones(col.length, dtype=torch.bool, device=ids.device)
             if col.validity is None else col.validity != 0)
    counts = _seg_sum(valid.to(torch.int64), ids, ngroups)
    if agg == COUNT:
        return Column(dtypes.INT64, ngroups, data=counts)
    if agg not in (SUM, MEAN, MIN, MAX):
        raise ValueError(f"unknown aggregation {agg}")
    if kind not in J._DEVICE_RANK_KINDS:
        raise NotImplementedError(
            f"{agg} over {kind} values: fixed-width kinds only")
    validity = (counts > 0).to(torch.uint8)
    is_float = kind in (Kind.FLOAT32, Kind.FLOAT64)
    if agg in (SUM, MEAN):
        if is_float:
            s = _seg_sum(torch.where(valid, col.data, 0).to(torch.float64),
                         ids, ngroups)
            if agg == MEAN:
                s = s / counts.clamp(min=1).to(torch.float64)
            if kind == Kind.FLOAT32 and agg == SUM:
                return Column(col.dtype, ngroups, data=s.to(torch.float32),
                              validity=validity)
            return Column(dtypes.FLOAT64, ngroups, data=s,
                          validity=validity)
        x = torch.where(valid, J._as_int64(col.data, kind), 0)
        s = _seg_sum(x, ids, ngroups)
        if agg == MEAN:
            m = s.to(torch.float64) / counts.clamp(min=1).to(torch.float64)
            return Column(dtypes.FLOAT64, ngroups, data=m,
                          validity=validity)
        return Column(dtypes.INT64, ngroups, data=s, validity=validity)
    # MIN / MAX
    if kind == Kind.FLOAT64:
        fill = _I64_MAX if agg == MIN else _I64_MIN
        key = torch.where(valid, floats.total_order_key(col.data), fill)
        best = _seg_reduce(key, ids, ngroups, agg, fill)
        return Column(col.dtype, ngroups,
                      data=floats.from_total_order_key(best),
                      validity=validity)
    if kind == Kind.FLOAT32:
        fill = 1 << 32 if agg == MIN else -1
        key = torch.where(valid, floats.f32_order_key(col.data), fill)
        best = _seg_reduce(key, ids, ngroups, agg, fill)
        return Column(col.dtype, ngroups,
                      data=floats.from_f32_order_key(best),
                      validity=validity)
    x = J._as_int64(col.data, kind)
    if kind == Kind.UINT64:
        # unsigned order in signed lanes: flip the sign bit
        x = x ^ J._SIGN
        fill = _I64_MAX if agg == MIN else _I64_MIN
        best = _seg_reduce(torch.where(valid, x, fill), ids, ngroups, agg,
                           fill) ^ J._SIGN
        return Column(col.dtype, ngroups, data=best.view(torch.uint64),
                      validity=validity)
    info = np.iinfo(col.dtype.np_dtype)
    fill = int(info.max if agg == MIN else info.min)
    best = _seg_reduce(torch.where(valid, x, fill), ids, ngroups, agg, fill)
    return Column(col.dtype, ngroups, data=J._from_int64(best, col.dtype),
                  validity=validity)
