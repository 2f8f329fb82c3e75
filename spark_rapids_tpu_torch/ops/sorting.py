"""ORDER BY over columns: a stable lexicographic sort with Spark's null
placement, floats by the total-order transform (NaN largest, -0.0
below 0.0), strings as unsigned bytes with a shorter prefix first and
DECIMAL128 by value.

Each key becomes a null key and its int64 device key words
(ops/joins.py: a fixed-width rank, a string's packed big-endian words
and its length, DECIMAL128's two words), all built on the tensors'
device, and stable sorts run over them, the last first.  The words
order every kind as the JAX package's host ranks do, and a stable
lexicographic sort's permutation is unique, so this is the same
function as its host lexsort.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import joins as J
from spark_rapids_tpu_torch.ops.copying import gather_table

ASC = True
DESC = False


def _sort_words(col: Column, asc: bool, nulls_first: bool
                ) -> List[torch.Tensor]:
    """int64 sort columns of one key on the column's device: its null
    key (where it has a validity), then its device key words."""
    pad = col.max_string_length() if col.dtype.is_string else 0
    words = J._device_equality_cols(col, pad)
    if words is None:
        raise NotImplementedError(
            f"{col.dtype.kind} keys come with nested columns "
            "(ROADMAP Queue A1)")
    out = []
    if col.validity is not None:
        # nulls by a key of their own: no sentinel can collide with a
        # legal word
        mask = col.validity != 0
        out.append((mask == nulls_first).to(torch.int64))
        words = [torch.where(mask, w, 0) for w in words]
    # DESC by bitwise NOT of every word: order-reversing without
    # negation overflow, and lexicographic order reverses with it
    return out + [w if asc else ~w for w in words]


def order_by(keys: Table,
             ascending: Optional[Sequence[bool]] = None,
             nulls_first: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Stable argsort over the key columns (leftmost key most
    significant), as an int32 gather map.  Spark defaults: ASC with
    nulls first; DESC with nulls last unless overridden."""
    n = keys.num_columns
    asc = list(ascending) if ascending is not None else [True] * n
    nf = list(nulls_first) if nulls_first is not None else list(asc)
    if not (len(asc) == len(nf) == n):
        raise ValueError("ascending/nulls_first must match key count")
    if n == 0:
        return torch.arange(keys.num_rows, dtype=torch.int32)
    sort_keys: List[torch.Tensor] = []
    for col, a, f in zip(keys.columns, asc, nf):
        sort_keys.extend(_sort_words(col, a, f))
    return J._lex_order(sort_keys).to(torch.int32)


def sort_table(table: Table, key_indices: Sequence[int],
               ascending: Optional[Sequence[bool]] = None,
               nulls_first: Optional[Sequence[bool]] = None) -> Table:
    keys = Table([table.columns[i] for i in key_indices])
    return gather_table(table, order_by(keys, ascending, nulls_first))
