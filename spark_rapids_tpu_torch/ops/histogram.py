"""Histogram build + percentile (reference histogram.cu/.hpp,
Histogram.java): Spark percentile() over (value, frequency) histograms.

create_histogram_if_valid: (values, frequencies) -> LIST<STRUCT<value,
freq>> per input row (validating freq >= 0), on the columns' device;
percentile_from_histogram: for each histogram row, Spark percentile
interpolation at the requested percentages, a host loop over the rows
whose result lands on the histogram's device."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import copying as _copying
from spark_rapids_tpu_torch.ops.exceptions import ExceptionWithRowIndex


def _first(mask: torch.Tensor) -> int:
    return int(torch.argmax(mask.to(torch.uint8)))


def create_histogram_if_valid(values: Column, frequencies: Column,
                              output_as_lists: bool = True) -> Column:
    """Per input row i: a one-element histogram [{value_i, freq_i}], or an
    empty list (lists mode) / null struct row (struct mode) when the value
    is null or freq <= 0.  Null or negative frequencies raise
    (histogram.cu:374-440 contract)."""
    rows = values.length
    fvalid = frequencies.valid_mask()
    if not bool(fvalid.all()):
        raise ExceptionWithRowIndex(_first(~fvalid),
                                    "frequency must not be null")
    freqs = frequencies.data.to(torch.int64)
    neg = freqs < 0
    if bool(neg.any()):
        raise ExceptionWithRowIndex(_first(neg),
                                    "frequency must not be negative")
    keep = values.valid_mask() & (freqs > 0)
    if not output_as_lists:
        freq_col = Column(dtypes.INT64, rows, data=freqs,
                          validity=keep.to(torch.uint8))
        return Column.make_struct(rows, [values, freq_col],
                                  validity=keep.to(torch.uint8))
    # lists mode: the element stream keeps only valid pairs; each input
    # row's list holds 0 or 1 element
    keep_idx = torch.nonzero(keep).squeeze(1)
    # through the module: the op layer's traced gather brackets this
    # inner call, as the JAX package's call-time import does
    kept_vals = _copying.gather(values, keep_idx)
    kept_freqs = Column(dtypes.INT64, kept_vals.length, data=freqs[keep])
    st = Column.make_struct(kept_vals.length, [kept_vals, kept_freqs])
    offsets = torch.zeros(rows + 1, dtype=torch.int32, device=freqs.device)
    torch.cumsum(keep.to(torch.int32), 0, out=offsets[1:])
    return Column(dtypes.LIST, rows, offsets=offsets, children=(st,))


def percentile_from_histogram(histogram: Column,
                              percentages: Sequence[float],
                              output_as_list: bool = True) -> Column:
    """Spark percentile(): sort each histogram by value, walk cumulative
    frequencies, linear-interpolate at p*(total-1)
    (histogram.hpp percentile_from_histogram)."""
    assert histogram.dtype.kind == "list"
    device = histogram.device
    st = histogram.children[0]
    vals_col, freq_col = st.children
    offs = histogram.offsets.cpu().numpy()
    vals = vals_col.data.cpu().numpy().astype(np.float64)
    freqs = freq_col.data.cpu().numpy().astype(np.int64)
    rows = histogram.length
    out: List = []
    hmask = histogram.valid_mask().cpu().numpy()
    for i in range(rows):
        if not hmask[i]:
            out.append(None)
            continue
        v = vals[offs[i]:offs[i + 1]]
        f = freqs[offs[i]:offs[i + 1]]
        if len(v) == 0:
            out.append(None)
            continue
        order = np.argsort(v, kind="stable")
        v, f = v[order], f[order]
        cum = np.cumsum(f)
        total = cum[-1]
        row_out = []
        for p in percentages:
            pos = p * (total - 1)
            lo = int(np.floor(pos))
            hi = int(np.ceil(pos))
            # index of first cumulative count > lo / > hi
            li = int(np.searchsorted(cum, lo + 1, side="left"))
            hi_i = int(np.searchsorted(cum, hi + 1, side="left"))
            vlo, vhi = v[li], v[hi_i]
            row_out.append(vlo + (pos - lo) * (vhi - vlo))
        out.append(row_out)
    if output_as_list:
        flat = [x for row in out if row is not None for x in row]
        child = Column.from_pylist(flat, dtypes.FLOAT64, device)
        offsets = np.zeros(rows + 1, np.int32)
        acc = 0
        for i, row in enumerate(out):
            acc += 0 if row is None else len(row)
            offsets[i + 1] = acc
        validity = None if all(r is not None for r in out) else \
            torch.tensor([r is not None for r in out],
                         dtype=torch.uint8, device=device)
        return Column(dtypes.LIST, rows, validity=validity,
                      offsets=torch.from_numpy(offsets).to(device),
                      children=(child,))
    return Column.from_pylist(
        [row[0] if row else None for row in out], dtypes.FLOAT64, device)
