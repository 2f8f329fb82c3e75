"""Spark substring_index(str, delim, count) (reference
substring_index.cu/.hpp, GpuSubstringIndexUtils.java).

count > 0: prefix up to (not including) the count-th delimiter occurrence
from the left; count < 0: suffix after the |count|-th occurrence from the
right; count == 0 or empty delimiter: empty string; fewer occurrences
than |count|: whole string.

Delimiter matches are a sliding-window equality over the padded char
matrix with a cumulative match count, on the column's device.  A
multi-byte delimiter also needs its overlapping matches suppressed: one
sweep over the positions with a per-row "suppressed until" cursor,
directional (left to right for count > 0, right to left for count < 0,
as Spark's indexOf/lastIndexOf scans)."""

from __future__ import annotations

from typing import Union

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.strbuild import _segments

_I64 = torch.int64


def _first_index(hit: torch.Tensor) -> torch.Tensor:
    """(rows,) index of each row's first True (0 where none)."""
    return torch.argmax(hit.to(torch.uint8), dim=1)


def _non_overlapping(m: torch.Tensor, d: int, forward: bool
                     ) -> torch.Tensor:
    """Greedy non-overlapping matches of a d-byte delimiter, scanning
    each row's positions in the given direction."""
    rows, P = m.shape
    kept = torch.zeros_like(m)
    if forward:
        until = torch.zeros(rows, dtype=_I64, device=m.device)
        for j in range(P):
            k = m[:, j] & (j >= until)
            kept[:, j] = k
            until = torch.where(k, j + d, until)
    else:
        until = torch.full((rows,), P, dtype=_I64, device=m.device)
        for j in range(P - 1, -1, -1):
            k = m[:, j] & (j < until)
            kept[:, j] = k
            until = torch.where(k, j - d + 1, until)
    return kept


def substring_index(col: Column, delimiter: Union[str, bytes],
                    count: int) -> Column:
    assert col.dtype.is_string
    rows = col.length
    device = col.device
    delim = delimiter.encode("utf-8") if isinstance(delimiter, str) \
        else bytes(delimiter)
    d = len(delim)
    if rows == 0 or count == 0 or d == 0:
        valid = col.valid_mask().cpu().tolist()
        return Column.from_strings(["" if v else None for v in valid],
                                   device)

    chars, lens = col.to_padded_chars()
    lens = lens.to(_I64)
    p = chars.shape[1]
    if p < d:
        # no row can contain the delimiter: whole strings
        keep_len = lens
    else:
        # match[i, j]: the delimiter starts at byte j
        m = torch.ones((rows, p - d + 1), dtype=torch.bool, device=device)
        for k, b in enumerate(delim):
            m &= chars[:, k:p - d + 1 + k] == b
        m &= torch.arange(p - d + 1, device=device)[None, :] \
            <= (lens - d)[:, None]
        if d > 1:
            m = _non_overlapping(m, d, count > 0)
        cum = torch.cumsum(m.to(torch.int32), dim=1)
        total = cum[:, -1]
        if count > 0:
            # cut before the count-th occurrence (or keep all if fewer)
            hit = m & (cum == count)
            pos = torch.where(hit.any(dim=1), _first_index(hit), lens)
            keep_len = torch.minimum(pos, lens)
        else:
            k = -count
            # keep everything after the (total-k+1)-th occurrence
            target = (total - k + 1).clamp(min=1)
            hit = m & (cum == target[:, None])
            start = torch.where((total >= k) & hit.any(dim=1),
                                _first_index(hit) + d, 0)
            keep_len = lens - start
            idx = start[:, None] + torch.arange(p, device=device)[None, :]
            chars = torch.where(idx < lens[:, None],
                                chars.gather(1, idx.clamp(0, p - 1)), 0)

    # each row's prefix of `chars`, one flat gather
    keep_len = torch.where(col.valid_mask(), keep_len.clamp(min=0), 0)
    offs = torch.zeros(rows + 1, dtype=_I64, device=device)
    torch.cumsum(keep_len, 0, out=offs[1:])
    row, pos = _segments(keep_len, int(offs[-1]))
    return Column(dtypes.STRING, rows, data=chars[row, pos].to(torch.uint8),
                  validity=col.validity, offsets=offs.to(torch.int32))
