"""Table and column copying: gather, slice, split, concat — the building
blocks GROUP BY, ORDER BY and joins compose (cudf::gather, slice,
split and concatenate).

Fixed-width, DECIMAL128 and STRING columns; LIST and STRUCT raise
NotImplementedError (ROADMAP Queue A1).  Everything runs on the
columns' device; a string gather or slice reads its byte counts back
to size the new chars buffer.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table


def _flat_only(col: Column) -> None:
    if col.dtype.is_nested:
        raise NotImplementedError(
            f"{col.dtype.kind} columns come with nested columns "
            f"(ROADMAP Queue A1)")


def gather(col: Column, idx: torch.Tensor) -> Column:
    """New column with rows col[idx[i]].  As the JAX package gathers:
    a negative index counts from the end, and fixed-width gathers clamp
    an index past either end; a string gather's indices must be in
    range after the wrap."""
    _flat_only(col)
    n = int(idx.shape[0])
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + col.length, idx)
    if not col.dtype.is_string:
        idx = idx.clamp(0, max(col.length - 1, 0))
    validity = None if col.validity is None else col.validity[idx]
    if not col.dtype.is_string:
        return Column(col.dtype, n, data=col.data[idx], validity=validity)
    if n and bool(((idx < 0) | (idx >= col.length)).any()):
        raise IndexError(f"string gather index out of range "
                         f"[0, {col.length})")
    starts = col.offsets[:-1].to(torch.int64)[idx]
    lens = col.offsets[1:].to(torch.int64)[idx] - starts
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1])
    row = torch.repeat_interleave(
        torch.arange(n, device=idx.device), lens, output_size=total)
    src = (starts[row] + torch.arange(total, device=idx.device)
           - offsets[:-1][row])
    return Column(col.dtype, n, data=col.data[src], validity=validity,
                  offsets=offsets.to(torch.int32))


def gather_table(table: Table, idx: torch.Tensor) -> Table:
    return Table([gather(c, idx) for c in table.columns], table.names)


def slice_column(col: Column, start: int, end: int) -> Column:
    """Rows [start, end), zero-rebased (cudf::slice semantics)."""
    _flat_only(col)
    n = end - start
    validity = None if col.validity is None else col.validity[start:end]
    if not col.dtype.is_string:
        return Column(col.dtype, n, data=col.data[start:end],
                      validity=validity)
    offs = col.offsets[start:end + 1]
    c0, c1 = int(offs[0]), int(offs[-1])
    return Column(col.dtype, n, data=col.data[c0:c1], validity=validity,
                  offsets=offs - c0)


def slice_table(table: Table, start: int, end: int) -> Table:
    return Table([slice_column(c, start, end) for c in table.columns],
                 table.names)


def split_table(table: Table, splits: Sequence[int]) -> List[Table]:
    """Split at row indices (cudf::split): [0,s0), [s0,s1), ... [sn,rows)."""
    bounds = [0] + list(splits) + [table.num_rows]
    return [slice_table(table, bounds[i], bounds[i + 1])
            for i in range(len(bounds) - 1)]


def concat_columns(cols: Sequence[Column]) -> Column:
    """One column of every input's rows in order; validity is None
    unless some input has one.  String offsets are rebased to start at
    0 whatever the inputs' first offsets."""
    for c in cols:
        _flat_only(c)
    first = cols[0]
    rows = sum(c.length for c in cols)
    validity = None
    if any(c.validity is not None for c in cols):
        validity = torch.cat([
            c.validity if c.validity is not None
            else torch.ones(c.length, dtype=torch.uint8, device=c.device)
            for c in cols])
    if not first.dtype.is_string:
        return Column(first.dtype, rows,
                      data=torch.cat([c.data for c in cols]),
                      validity=validity)
    chars, parts, base = [], [first.offsets[:1] * 0], 0
    for c in cols:
        c0, c1 = int(c.offsets[0]), int(c.offsets[-1])
        chars.append(c.data[c0:c1])
        parts.append(c.offsets[1:] - c0 + base)
        base += c1 - c0
    return Column(first.dtype, rows, data=torch.cat(chars),
                  validity=validity, offsets=torch.cat(parts))


def concat_tables(tables: Sequence[Table]) -> Table:
    if not tables:
        raise ValueError("need at least one table")
    ncols = tables[0].num_columns
    return Table([concat_columns([t.columns[i] for t in tables])
                  for i in range(ncols)], tables[0].names)
