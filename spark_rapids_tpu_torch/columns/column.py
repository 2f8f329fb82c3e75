"""Arrow-layout device columns on torch tensors.

The reference operates on `cudf::column_view` (data ptr, packed validity
bits, int32 offsets, children).  Here a Column holds torch tensors, all on
one device:

  data      fixed-width: (rows,) in the kind's torch dtype (dtypes.py);
            FLOAT64 is native float64, bit work goes through
            `.view(torch.int64)`.
            decimal128:  (rows, 4) int32 little-endian limbs
            string:      (nbytes,) uint8, the flat chars buffer
            LIST<UINT8>: the child's (bytes,) uint8 buffer
  validity  (rows,) uint8, nonzero = valid; None means all rows valid.
  offsets   (rows+1,) int32 for STRING and LIST (int32 offsets, as the
            reference builds with CUDF_LARGE_STRINGS_DISABLED).
  children  LIST: (element column,); STRUCT: field columns.

A STRING row's length comes from its offsets whatever its validity, and
the offsets need not start at 0 (a sliced column).  Ops never mutate a
Column; they build new ones.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.dtypes import DType, Kind


def _as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def _as_validity(validity, device) -> Optional[torch.Tensor]:
    return None if validity is None else _as_tensor(validity, torch.uint8,
                                                    device)


class Column:
    __slots__ = ("dtype", "length", "data", "validity", "offsets", "children")

    def __init__(
        self,
        dtype: DType,
        length: int,
        data: Optional[torch.Tensor] = None,
        validity: Optional[torch.Tensor] = None,
        offsets: Optional[torch.Tensor] = None,
        children: Tuple["Column", ...] = (),
    ):
        self.dtype = dtype
        self.length = int(length)
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.children = tuple(children)

    def __len__(self) -> int:
        return self.length

    def __repr__(self) -> str:
        return f"Column({self.dtype!r}, length={self.length})"

    @property
    def has_validity(self) -> bool:
        return self.validity is not None

    def null_count(self) -> int:
        """Rows that are null (one host sync)."""
        if self.validity is None:
            return 0
        return int(self.length
                   - int((self.validity[:self.length] != 0).sum()))

    @property
    def device(self) -> torch.device:
        for t in (self.data, self.offsets, self.validity):
            if t is not None:
                return t.device
        return self.children[0].device

    @staticmethod
    def make_list_from_parts(offsets: torch.Tensor,
                             byte_data: torch.Tensor) -> "Column":
        """LIST<UINT8> column from (rows+1,) offsets and a flat uint8
        buffer: the shape JCUDF rows take."""
        if byte_data.dtype != torch.uint8 or byte_data.dim() != 1:
            raise ValueError(
                f"byte_data must be a flat uint8 tensor, got "
                f"{byte_data.dtype} {tuple(byte_data.shape)}")
        child = Column(dtypes.UINT8, byte_data.shape[0], data=byte_data)
        return Column(dtypes.LIST, offsets.shape[0] - 1,
                      offsets=offsets.to(torch.int32), children=(child,))

    @staticmethod
    def make_list(offsets, child: "Column", validity=None,
                  device=None) -> "Column":
        """LIST column over `child` from (rows+1,) offsets and an optional
        (rows,) validity (numpy arrays or tensors), on `device` (the
        child's unless given)."""
        device = child.device if device is None else device
        offs = _as_tensor(offsets, torch.int32, device)
        return Column(dtypes.LIST, offs.shape[0] - 1,
                      validity=_as_validity(validity, device),
                      offsets=offs, children=(child,))

    @staticmethod
    def make_struct(length: int, children: Sequence["Column"],
                    validity=None) -> "Column":
        """STRUCT column of `length` rows over the field columns, with an
        optional (rows,) validity on the children's device ("cuda" when
        there is no child)."""
        device = children[0].device if children else "cuda"
        return Column(dtypes.STRUCT, length,
                      validity=_as_validity(validity, device),
                      children=tuple(children))

    # ---------------------------------------------------------- constructors

    @staticmethod
    def from_numpy(arr: np.ndarray, validity: Optional[np.ndarray] = None,
                   dtype: Optional[DType] = None,
                   device="cuda") -> "Column":
        """Fixed-width column from a numpy array, in `dtype` (by default
        the one `dtypes.from_numpy` names for the array's dtype), with an
        optional (rows,) validity (nonzero = valid)."""
        arr = np.asarray(arr)
        dt = dtype if dtype is not None else dtypes.from_numpy(arr.dtype)
        host = np.ascontiguousarray(arr.astype(dt.np_dtype, copy=False))
        return Column(dt, arr.shape[0],
                      data=torch.from_numpy(host).to(device),
                      validity=_as_validity(
                          None if validity is None
                          else np.asarray(validity).astype(np.uint8),
                          device))

    @staticmethod
    def from_pylist(values: Sequence, dtype: DType,
                    device="cuda") -> "Column":
        """Column from a python list; None entries become nulls."""
        if dtype.is_string:
            return Column.from_strings(values, device)
        if dtype.kind == Kind.DECIMAL128:
            return Column._decimal128_from_pylist(values, dtype, device)
        host = np.array([0 if v is None else v for v in values],
                        dtype=dtype.np_dtype)
        v = None
        if any(x is None for x in values):
            v = torch.tensor([0 if x is None else 1 for x in values],
                             dtype=torch.uint8, device=device)
        return Column(dtype, len(values),
                      data=torch.from_numpy(host).to(device), validity=v)

    @staticmethod
    def _decimal128_from_pylist(values: Sequence, dtype: DType,
                                device="cuda") -> "Column":
        """(rows, 4) int32 little-endian limbs from python ints (the
        unscaled decimal value), two's complement across 128 bits."""
        n = len(values)
        limbs = np.zeros((n, 4), dtype=np.uint32)
        vmask = np.ones(n, dtype=np.uint8)
        for i, v in enumerate(values):
            if v is None:
                vmask[i] = 0
                continue
            u = int(v) & ((1 << 128) - 1)
            for j in range(4):
                limbs[i, j] = (u >> (32 * j)) & 0xFFFFFFFF
        validity = None if vmask.all() else torch.from_numpy(vmask).to(device)
        return Column(dtype, n,
                      data=torch.from_numpy(limbs.view(np.int32)).to(device),
                      validity=validity)

    @staticmethod
    def from_strings(values: Sequence[Optional[Union[str, bytes]]],
                     device="cuda") -> "Column":
        """STRING column from str (UTF-8 encoded) or bytes values; a null
        row has length 0, and validity is None when every row is
        valid."""
        n = len(values)
        bufs: List[bytes] = []
        offs = np.zeros(n + 1, dtype=np.int32)
        vmask = np.ones(n, dtype=np.uint8)
        total = 0
        for i, s in enumerate(values):
            if s is None:
                vmask[i] = 0
                b = b""
            else:
                b = s.encode("utf-8") if isinstance(s, str) else bytes(s)
            bufs.append(b)
            total += len(b)
            offs[i + 1] = total
        chars = np.frombuffer(b"".join(bufs), dtype=np.uint8).copy()
        validity = None if vmask.all() else torch.from_numpy(vmask).to(device)
        return Column(dtypes.STRING, n,
                      data=torch.from_numpy(chars).to(device),
                      validity=validity,
                      offsets=torch.from_numpy(offs).to(device))

    def valid_mask(self) -> torch.Tensor:
        """(rows,) bool: True where the row is valid (every row without a
        validity buffer)."""
        if self.validity is None:
            return torch.ones(self.length, dtype=torch.bool,
                              device=self.device)
        return self.validity.to(torch.bool)

    # ------------------------------------------------------------- host view

    def to_numpy(self) -> np.ndarray:
        """The data buffer on the host in the kind's dtype, nulls not
        masked.  FLOAT64 comes back as float64 values (the buffer is
        native float64; the JAX package views its raw bits)."""
        if self.data is None:
            raise ValueError(f"{self.dtype} column has no data buffer")
        return self.data.cpu().numpy()

    def to_pylist(self) -> list:
        """Host values with None for nulls: python ints, floats and bools,
        str for STRING (UTF-8, undecodable bytes replaced), the unscaled
        int for DECIMAL128, lists for LIST and tuples for STRUCT."""
        mask = (np.ones(self.length, bool) if self.validity is None
                else self.validity.cpu().numpy().astype(bool))
        if self.dtype.is_string:
            chars = self.data.cpu().numpy().tobytes()
            offs = self.offsets.cpu().numpy()
            return [chars[offs[i]:offs[i + 1]].decode("utf-8",
                                                      errors="replace")
                    if mask[i] else None for i in range(self.length)]
        if self.dtype.kind == Kind.LIST:
            offs = self.offsets.cpu().numpy()
            child = self.children[0].to_pylist()
            return [child[offs[i]:offs[i + 1]] if mask[i] else None
                    for i in range(self.length)]
        if self.dtype.kind == Kind.STRUCT:
            cols = [c.to_pylist() for c in self.children]
            return [tuple(c[i] for c in cols) if mask[i] else None
                    for i in range(self.length)]
        host = self.data.cpu().numpy()
        if self.dtype.kind == Kind.BOOL8:
            return [bool(host[i]) if mask[i] else None
                    for i in range(self.length)]
        if self.dtype.kind == Kind.DECIMAL128:
            limbs = host.view(np.uint32).astype(object)
            out = []
            for i in range(self.length):
                if not mask[i]:
                    out.append(None)
                    continue
                u = sum(int(limbs[i, j]) << (32 * j) for j in range(4))
                out.append(u - (1 << 128) if u >= 1 << 127 else u)
            return out
        return [host[i].item() if mask[i] else None
                for i in range(self.length)]

    # -------------------------------------------------------- string helpers

    def string_lengths(self) -> torch.Tensor:
        """(rows,) int32 byte length of each row, from the offsets."""
        assert self.dtype.is_string
        return self.offsets[1:] - self.offsets[:-1]

    def max_string_length(self) -> int:
        """Longest row in bytes (one host sync)."""
        assert self.dtype.is_string
        if self.length == 0:
            return 0
        return int(self.string_lengths().max())

    def to_padded_chars(self, pad_to: Optional[int] = None,
                        fill: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, pad_to) uint8 char matrix with `fill` past each row's
        length, and the (rows,) int32 lengths.  pad_to defaults to the
        longest row, at least 1."""
        assert self.dtype.is_string
        lens = self.string_lengths()
        if pad_to is None:
            pad_to = max(1, self.max_string_length())
        j = torch.arange(pad_to, dtype=torch.int64, device=lens.device)
        idx = self.offsets[:-1, None].to(torch.int64) + j[None, :]
        in_range = idx < self.offsets[1:, None]
        nbytes = self.data.shape[0]
        if nbytes:
            got = self.data[idx.clamp_(0, nbytes - 1)]
        else:
            got = torch.zeros(idx.shape, dtype=torch.uint8,
                              device=lens.device)
        return torch.where(in_range, got, fill).to(torch.uint8), lens
