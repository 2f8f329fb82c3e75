"""CASE WHEN fast path (reference case_when.cu/case_when.hpp,
CaseWhen.java): N boolean WHEN columns -> index of the first true branch
per row (num_columns = ELSE) for a subsequent gather."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column


def select_first_true_index(bool_cols: Sequence[Column]) -> Column:
    """(rows,) INT32: index of the first WHEN column whose value is true
    (null counts as false); len(bool_cols) if none match (the ELSE
    branch)."""
    if not bool_cols:
        raise ValueError("need at least one boolean column")
    n = len(bool_cols)
    rows = bool_cols[0].length
    result = torch.full((rows,), n, dtype=torch.int32,
                        device=bool_cols[0].device)
    for i in range(n - 1, -1, -1):
        c = bool_cols[i]
        t = c.data != 0
        if c.validity is not None:
            t = t & (c.validity != 0)
        result = torch.where(t, i, result).to(torch.int32)
    return Column(dtypes.INT32, rows, data=result)
