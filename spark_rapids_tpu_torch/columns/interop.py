"""Host arrays in, host arrays out: how tables cross into and out of the
port.

A fixed-width column on the host is a `(kind, data, validity)` triple
laid out as the JAX package's Column holds it: `data` in the kind's numpy
dtype, FLOAT64 as uint64 raw IEEE-754 bits, DECIMAL128 as (rows, 4) int32
limbs, and `validity` a (rows,) uint8 array or None.  FLOAT64 bits are
viewed as float64 on the way in and back to uint64 on the way out, so
NaN payloads and -0.0 survive byte for byte.  A STRING column is a
`("string", chars, validity, offsets)` 4-tuple: a flat uint8 chars
buffer and (rows+1,) int32 offsets into it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType, Kind
from spark_rapids_tpu_torch.columns.table import Table

HostColumn = Tuple  # (kind, data, validity[, offsets])


def _as_dtype(kind: Union[str, DType]) -> DType:
    return kind if isinstance(kind, DType) else DType(kind)


def _validity_from_host(validity: Optional[np.ndarray], rows: int,
                        device) -> Optional[torch.Tensor]:
    if validity is None:
        return None
    vh = np.ascontiguousarray(validity).astype(np.uint8)
    if vh.shape != (rows,):
        raise ValueError(f"validity shape {vh.shape} != ({rows},)")
    return torch.from_numpy(vh).to(device)


def _string_from_host(chars: np.ndarray, validity: Optional[np.ndarray],
                      offsets: np.ndarray, device) -> Column:
    ch = np.ascontiguousarray(chars)
    offs = np.ascontiguousarray(offsets)
    if ch.dtype != np.uint8 or ch.ndim != 1:
        raise ValueError(f"string chars must be a flat uint8 array, got "
                         f"{ch.dtype} {ch.shape}")
    if offs.dtype != np.int32 or offs.ndim != 1 or offs.shape[0] < 1:
        raise ValueError(f"string offsets must be (rows+1,) int32, got "
                         f"{offs.dtype} {offs.shape}")
    rows = offs.shape[0] - 1
    return Column(dtypes.STRING, rows,
                  data=torch.from_numpy(ch.copy()).to(device),
                  validity=_validity_from_host(validity, rows, device),
                  offsets=torch.from_numpy(offs.copy()).to(device))


def _column_from_host(kind: Union[str, DType], data: np.ndarray,
                      validity: Optional[np.ndarray],
                      offsets: Optional[np.ndarray] = None, *,
                      device: Union[str, torch.device]) -> Column:
    dt = _as_dtype(kind)
    if dt.is_string:
        if offsets is None:
            raise ValueError("a STRING host column is (\"string\", chars, "
                             "validity, offsets)")
        return _string_from_host(data, validity, offsets, device)
    if not dt.is_fixed_width:
        raise NotImplementedError(
            f"{dt.kind} columns cross only when the port supports them "
            f"(ROADMAP Queue A1: nested columns)")
    if offsets is not None:
        raise ValueError(f"a {dt.kind} host column has no offsets")
    arr = np.ascontiguousarray(data)
    if dt.kind == Kind.FLOAT64 and arr.dtype == np.uint64:
        arr = arr.view(np.float64)
    want_shape = (arr.shape[0], 4) if dt.kind == Kind.DECIMAL128 \
        else (arr.shape[0],)
    if arr.dtype != dt.np_dtype or arr.shape != want_shape:
        raise ValueError(
            f"{dt.kind} host data must be {dt.np_dtype} {want_shape}, got "
            f"{arr.dtype} {arr.shape}")
    t = torch.from_numpy(arr.copy()).to(device)
    return Column(dt, arr.shape[0], data=t,
                  validity=_validity_from_host(validity, arr.shape[0],
                                               device))


def table_from_host(specs: Sequence[Tuple], device="cuda") -> Table:
    """Table on `device` from `(kind, data, validity)` host triples and
    `("string", chars, validity, offsets)` 4-tuples."""
    return Table([_column_from_host(*s, device=device) for s in specs])


def _column_to_host(col: Column) -> HostColumn:
    data = col.data.cpu().numpy()
    if col.dtype.kind == Kind.FLOAT64:
        data = data.view(np.uint64)
    v = None if col.validity is None else col.validity.cpu().numpy()
    if col.dtype.is_string:
        return col.dtype.kind, data, v, col.offsets.cpu().numpy()
    return col.dtype.kind, data, v


def table_to_host(table: Table) -> List[HostColumn]:
    """Host triples (FLOAT64 as uint64 bits) and STRING 4-tuples, the
    form `table_from_host` takes."""
    return [_column_to_host(c) for c in table.columns]


def rows_from_host(offsets: np.ndarray, row_bytes, device="cuda") -> Column:
    """Port LIST<UINT8> column from JCUDF row offsets and bytes.  The bytes
    may be `bytes`, a uint8 array, or the JAX package's packed uint32
    little-endian words; a word buffer's tail padding is cut off at
    offsets[-1]."""
    offs = np.ascontiguousarray(offsets).astype(np.int32)
    if isinstance(row_bytes, np.ndarray):
        buf = np.ascontiguousarray(row_bytes).view(np.uint8).reshape(-1)
    else:
        buf = np.frombuffer(bytes(row_bytes), np.uint8)
    nbytes = int(offs[-1]) if offs.size else 0
    if buf.shape[0] < nbytes:
        raise ValueError(f"{buf.shape[0]} row bytes < offsets end {nbytes}")
    data = torch.from_numpy(buf[:nbytes].copy()).to(device)
    return Column.make_list_from_parts(torch.from_numpy(offs).to(device),
                                       data)
