"""HostTable: move a whole device Table into one contiguous host buffer and
back (reference HostTable.java:46 fromTableAsync / toDeviceColumnViews,
host_table_view.hpp) — the primitive behind host-spill of tables.

Layout: a metadata header (python-side description of the column tree) +
one contiguous bytes buffer holding every device buffer (data, validity,
offsets, children depth-first), each 8-byte aligned — matching the
contiguous-split single-buffer idea the reference builds on.  The layout
equals the JAX package's for the same table (both hold validity as uint8
per row, FLOAT64 in 8 bytes, chars as uint8).  ``to_table`` builds the
table back on the device the columns came from.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType
from spark_rapids_tpu_torch.columns.table import Table

_ALIGN = 8


class _BufMeta:
    __slots__ = ("offset", "nbytes", "np_dtype", "shape")

    def __init__(self, offset, nbytes, np_dtype, shape):
        self.offset = offset
        self.nbytes = nbytes
        self.np_dtype = np_dtype
        self.shape = shape


class _ColMeta:
    __slots__ = ("dtype", "length", "data", "validity", "offsets",
                 "children")

    def __init__(self, dtype: DType, length: int, data, validity, offsets,
                 children):
        self.dtype = dtype
        self.length = length
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.children = children


class HostTable:
    """A spilled Table: metadata + one contiguous host buffer, and the
    device its columns came from."""

    def __init__(self, buffer: bytes, columns: List[_ColMeta],
                 names: Optional[List[str]], device: torch.device):
        self.buffer = buffer
        self._columns = columns
        self.names = names
        self.device = device

    @property
    def size_bytes(self) -> int:
        return len(self.buffer)

    @staticmethod
    def from_table(table: Table) -> "HostTable":
        chunks: List[bytes] = []
        pos = 0

        def put(t: Optional[torch.Tensor]) -> Optional[_BufMeta]:
            nonlocal pos
            if t is None:
                return None
            host = t.cpu().numpy()
            raw = host.tobytes()
            meta = _BufMeta(pos, len(raw), host.dtype, host.shape)
            chunks.append(raw)
            pos += len(raw)
            pad = (-pos) % _ALIGN
            if pad:
                chunks.append(b"\0" * pad)
                pos += pad
            return meta

        def walk(c: Column) -> _ColMeta:
            return _ColMeta(c.dtype, c.length, put(c.data), put(c.validity),
                            put(c.offsets),
                            [walk(ch) for ch in c.children])

        cols = [walk(c) for c in table.columns]
        device = table.device if table.columns else torch.device("cpu")
        return HostTable(b"".join(chunks), cols, table.names, device)

    def to_table(self) -> Table:
        buf = self.buffer

        def get(meta: Optional[_BufMeta]) -> Optional[torch.Tensor]:
            if meta is None:
                return None
            host = np.frombuffer(
                buf, dtype=meta.np_dtype,
                count=int(np.prod(meta.shape)) if meta.shape else 1,
                offset=meta.offset).reshape(meta.shape)
            return torch.from_numpy(host.copy()).to(self.device)

        def rebuild(m: _ColMeta) -> Column:
            return Column(m.dtype, m.length, data=get(m.data),
                          validity=get(m.validity), offsets=get(m.offsets),
                          children=tuple(rebuild(ch) for ch in m.children))

        return Table([rebuild(m) for m in self._columns], self.names)
