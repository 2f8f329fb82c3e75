"""Row <-> columnar conversion in the JCUDF row format.

Reference: src/main/cpp/src/row_conversion.cu (format spec in
RowConversion.java:67-137 and compute_column_information):

  * fixed-width section: columns in order, each aligned to its byte size;
    a STRING column's field is a (start in row, length) uint32 pair,
    aligned to 4; then validity, one bit per column (1 = valid),
    byte-aligned.
  * variable-width section: each string column's bytes in column order,
    starting right after the fixed section.  The row length is rounded
    up to 8 bytes (JCUDF_ROW_ALIGNMENT) with zeros.
  * output is a LIST<UINT8> column: row i = bytes[offsets[i]:offsets[i+1]].

The layout (`compute_layout`, `field_word_slots`) and the plain word-stack
assembly (`_assemble_fixed_words`) live here.  `convert_to_rows` hands the
data movement to ops/row_assembly_cuda.py: the hand-written kernels for
tensors on the card, their plain versions for tensors on the CPU.
`convert_from_rows` does the same for fixed-width schemas; rows with
strings are decoded in plain PyTorch on either device (the JAX package
has no kernel there either).  Everything runs eagerly at the true row
count.

Schemas with lists or structs raise NotImplementedError (ROADMAP Queue A4).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType, Kind
from spark_rapids_tpu_torch.columns.table import Table

JCUDF_ROW_ALIGNMENT = 8


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _col_byte_size(dt: DType) -> int:
    if dt.is_string:
        return 8  # (offset, length) uint32 pair
    if dt.kind == Kind.DECIMAL128:
        return 16
    return dt.size_bytes


def _col_alignment(dt: DType) -> int:
    return 4 if dt.is_string else _col_byte_size(dt)


def compute_layout(schema: Sequence[DType]):
    """Per-column start offsets + fixed-section/validity sizes.
    Mirrors compute_column_information (row_conversion.cu:1367)."""
    starts: List[int] = []
    size = 0
    for dt in schema:
        size = _round_up(size, _col_alignment(dt))
        starts.append(size)
        size += _col_byte_size(dt)
    validity_offset = size
    size += (len(schema) + 7) // 8
    return starts, validity_offset, size  # size = fixed + validity bytes


def row_size_of(schema: Sequence[DType]) -> int:
    return _round_up(compute_layout(schema)[2], JCUDF_ROW_ALIGNMENT)


def _require_flat(schema: Sequence[DType]) -> None:
    for dt in schema:
        if dt.is_nested:
            raise NotImplementedError(
                f"JCUDF conversion of {dt.kind} columns is not ported yet "
                f"(ROADMAP Queue A4: LIST and STRUCT)")


def field_word_slots(dt: DType, st: int):
    """[(word_index, shift_bits, nbits)] for the value pieces of one
    fixed-width field at byte offset `st`: the single source of the JCUDF
    word layout for the plain assembly (build_plan) and the plain
    extraction (row_assembly_cuda.build_extract_plan)."""
    w = st // 4
    size = _col_byte_size(dt)
    if dt.kind == Kind.DECIMAL128:
        return [(w + k, 0, 32) for k in range(4)]
    if size == 8:
        return [(w, 0, 32), (w + 1, 0, 32)]
    if size == 4:
        return [(w, 0, 32)]
    return [(w, (st % 4) * 8, size * 8)]


def _validity_bytes(cols: Sequence[Column]) -> torch.Tensor:
    """(rows, ceil(ncols/8)) uint8; bit c%8 of byte c//8 set = col c
    valid.  A column without validity counts as all valid."""
    rows = cols[0].length
    nbytes = (len(cols) + 7) // 8
    base = [0] * nbytes
    out = torch.zeros((rows, nbytes), dtype=torch.uint8,
                      device=cols[0].device)
    for ci, c in enumerate(cols):
        if c.validity is None:
            base[ci // 8] |= 1 << (ci % 8)
        else:
            out[:, ci // 8] |= (c.validity != 0).to(torch.uint8) << (ci % 8)
    return out | torch.tensor(base, dtype=torch.uint8, device=out.device)


def _word_pieces(c: Column) -> List[torch.Tensor]:
    """One (rows,) int32 piece per field_word_slots entry, zero-extended
    from the field's width."""
    d = c.data
    size = _col_byte_size(c.dtype)
    if c.dtype.kind == Kind.DECIMAL128:
        return [d[:, k] for k in range(4)]
    if size == 8:
        v = d.view(torch.int64)
        return [v.to(torch.int32), (v >> 32).to(torch.int32)]
    if size == 4:
        return [d.view(torch.int32)]
    signed = dtypes.SIGNED_OF_WIDTH[size]
    return [d.view(signed).to(torch.int32) & ((1 << (8 * size)) - 1)]


def build_plan(cols: Sequence[Column], starts: Sequence[int],
               validity_offset: int, n_words: int,
               var_pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]] = ()):
    """(inputs, plan): one (rows,) int32 piece per word contribution and
    the (word_index, left_shift_bits) each lands at.  Word coordinates
    come from field_word_slots; a string column's pieces are its (start
    in row, length) pair from `var_pairs`, in string-column order;
    validity bytes ride in the same plan."""
    inputs = []
    plan = []
    pairs = iter(var_pairs)
    for c, st in zip(cols, starts):
        pieces = (list(next(pairs)) if c.dtype.is_string
                  else _word_pieces(c))
        for arr, (word, shift, _nbits) in zip(
                pieces, field_word_slots(c.dtype, st)):
            inputs.append(arr)
            plan.append((word, shift))
    packed = _validity_bytes(cols)
    for b in range((len(cols) + 7) // 8):
        off = validity_offset + b
        inputs.append(packed[:, b].to(torch.int32))
        plan.append((off // 4, (off % 4) * 8))
    if any(w >= n_words for w, _ in plan):
        raise ValueError(f"layout needs more than {n_words} words per row")
    return inputs, plan


def _assemble_fixed_words(cols, starts, validity_offset, row_size,
                          var_pairs=()) -> torch.Tensor:
    """Plain to-rows: compose each 4-byte word of the row as an OR of
    shifted (rows,) pieces and stack them into the (rows, W) matrix.
    Returns the flat (rows * row_size,) uint8 row buffer.  With strings,
    `var_pairs` gives their fields and this is the fixed section only."""
    rows = cols[0].length
    n_words = row_size // 4
    inputs, plan = build_plan(cols, starts, validity_offset, n_words,
                              var_pairs)
    words = [None] * n_words
    for arr, (w, sh) in zip(inputs, plan):
        u = arr << sh if sh else arr
        words[w] = u if words[w] is None else words[w] | u
    zeros = torch.zeros((rows,), dtype=torch.int32, device=cols[0].device)
    mat = torch.stack([w if w is not None else zeros for w in words], dim=1)
    return mat.view(torch.uint8).reshape(-1)


def _row_offsets(rows: int, row_size: int, device) -> torch.Tensor:
    if rows * row_size >= 2**31:
        raise ValueError(
            f"{rows} rows of {row_size} bytes overflow int32 offsets; "
            f"split the table into smaller batches")
    return torch.arange(rows + 1, dtype=torch.int32, device=device) * row_size


def var_row_offsets(cols: Sequence[Column],
                    fixed_size: int) -> Tuple[torch.Tensor, int]:
    """((rows+1,) int32 row offsets, total bytes) of variable-width rows:
    each row is fixed_size plus its strings' lengths, rounded up to 8.
    The sums run in int64; one host sync reads the total."""
    rows = cols[0].length
    var_total = torch.zeros((rows,), dtype=torch.int64,
                            device=cols[0].device)
    for c in cols:
        if c.dtype.is_string:
            var_total += c.string_lengths()
    row_sizes = _round_up(var_total + fixed_size, JCUDF_ROW_ALIGNMENT)
    offsets = torch.zeros((rows + 1,), dtype=torch.int64,
                          device=var_total.device)
    torch.cumsum(row_sizes, 0, out=offsets[1:])
    total = int(offsets[-1])
    if total >= 2**31:
        raise ValueError(
            f"{rows} rows of {total} bytes in all overflow int32 offsets; "
            f"split the table into smaller batches")
    return offsets.to(torch.int32), total


def convert_to_rows(table: Table) -> Column:
    """Table -> LIST<UINT8> column of JCUDF rows (RowConversion.
    convertToRows).  Fixed-width and STRING columns."""
    from spark_rapids_tpu_torch.ops import row_assembly_cuda

    cols = table.columns
    if not cols:
        raise ValueError("cannot convert empty table")
    schema = [c.dtype for c in cols]
    _require_flat(schema)
    starts, validity_offset, fixed_size = compute_layout(schema)
    if any(dt.is_string for dt in schema):
        offsets, total = var_row_offsets(cols, fixed_size)
        data = row_assembly_cuda.assemble_var_rows(
            cols, starts, validity_offset, fixed_size, offsets, total)
        return Column.make_list_from_parts(offsets, data)
    row_size = _round_up(fixed_size, JCUDF_ROW_ALIGNMENT)
    offsets = _row_offsets(table.num_rows, row_size, table.device)
    data = row_assembly_cuda.assemble_rows(cols, starts, validity_offset,
                                           row_size)
    return Column.make_list_from_parts(offsets, data)


def _gather_fixed_region(list_col: Column, fixed_size: int) -> torch.Tensor:
    """(rows, fixed_size) uint8: each row's fixed section, in one gather
    (indices clipped to the buffer, as the JAX package clips them)."""
    offs = list_col.offsets
    data = list_col.children[0].data
    j = torch.arange(fixed_size, dtype=torch.int64, device=offs.device)
    idx = offs[:-1, None].to(torch.int64) + j[None, :]
    if not data.shape[0]:
        return torch.zeros(idx.shape, dtype=torch.uint8, device=offs.device)
    return data[idx.clamp_(0, data.shape[0] - 1)]


def _field(region: torch.Tensor, st: int, dt: DType) -> torch.Tensor:
    """One fixed-width field's values from the rows' fixed sections."""
    raw = region[:, st:st + _col_byte_size(dt)].contiguous().reshape(-1)
    if dt.kind == Kind.DECIMAL128:
        return raw.view(torch.int32).view(-1, 4)
    return raw.view(dt.torch_dtype)


def _from_var_rows(list_col: Column, schema: Sequence[DType],
                   starts: Sequence[int], validity_offset: int,
                   fixed_size: int) -> Table:
    """Rows with strings -> Table, in plain PyTorch: one gather of every
    row's fixed section, then each STRING column's bytes gathered from
    its (start in row, length) pair into compacted chars."""
    rows = list_col.length
    offs = list_col.offsets.to(torch.int64)
    data = list_col.children[0].data
    region = _gather_fixed_region(list_col, fixed_size)
    bit = torch.tensor([validity_offset + ci // 8 for ci in range(len(schema))],
                       device=region.device)
    shift = torch.arange(len(schema), device=region.device) % 8
    valid = ((region[:, bit] >> shift.to(torch.uint8)) & 1).T.contiguous()
    pairs = {ci: (_field(region, st, dtypes.INT32).to(torch.int64),
                  _field(region, st + 4, dtypes.INT32).to(torch.int64))
             for ci, (dt, st) in enumerate(zip(schema, starts))
             if dt.is_string}
    totals = iter(torch.stack([lens.sum()
                               for _s, lens in pairs.values()]).tolist())
    out = []
    for ci, (dt, st) in enumerate(zip(schema, starts)):
        if not dt.is_string:
            out.append(Column(dt, rows, data=_field(region, st, dt),
                              validity=valid[ci]))
            continue
        in_row, lens = pairs[ci]
        total = next(totals)
        str_offs = torch.zeros((rows + 1,), dtype=torch.int64,
                               device=offs.device)
        torch.cumsum(lens, 0, out=str_offs[1:])
        r = torch.repeat_interleave(
            torch.arange(rows, device=offs.device), lens, output_size=total)
        src = (offs[r] + in_row[r] + torch.arange(total, device=offs.device)
               - str_offs[r])
        chars = (data[src.clamp_(0, data.shape[0] - 1)] if total
                 else torch.zeros((0,), dtype=torch.uint8,
                                  device=offs.device))
        out.append(Column(dtypes.STRING, rows, data=chars,
                          validity=valid[ci],
                          offsets=str_offs.to(torch.int32)))
    return Table(out)


def convert_from_rows(list_col: Column, schema: Sequence[DType]) -> Table:
    """LIST<UINT8> of JCUDF rows -> Table (RowConversion.convertFromRows).
    Fixed-width schemas need every row exactly one row size long; with
    strings, rows are decoded from their own offsets.  Every output
    column carries a (rows,) uint8 validity."""
    from spark_rapids_tpu_torch.ops import row_assembly_cuda

    schema = list(schema)
    _require_flat(schema)
    starts, validity_offset, fixed_size = compute_layout(schema)
    if any(dt.is_string for dt in schema):
        return _from_var_rows(list_col, schema, starts, validity_offset,
                              fixed_size)
    row_size = _round_up(fixed_size, JCUDF_ROW_ALIGNMENT)
    rows = list_col.length
    data = list_col.children[0].data
    expect = _row_offsets(rows, row_size, list_col.offsets.device)
    if data.shape[0] != rows * row_size or not torch.equal(
            list_col.offsets, expect):
        raise ValueError(
            f"row buffer is not {rows} uniform rows of {row_size} bytes")
    datas, valid = row_assembly_cuda.disassemble_rows(
        data, schema, starts, validity_offset, row_size)
    return Table([Column(dt, rows, data=d, validity=valid[ci])
                  for ci, (dt, d) in enumerate(zip(schema, datas))])
