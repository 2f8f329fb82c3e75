"""Column data types for the PyTorch columnar engine.

The same `Kind`/`DType` table as the JAX package (cudf type-id subset:
fixed-width numerics, bool, strings with int32 offsets, timestamps,
decimal 32/64/128, nested LIST/STRUCT), with each fixed-width kind's
torch dtype beside its numpy dtype.

  * FLOAT64 is native torch.float64; bit work views it as int64.
  * UINT16/32/64 use torch's unsigned dtypes for storage only.  Torch has
    no arithmetic, shift or compare for them on the CPU, so ops view the
    buffer as the signed type of the same width and carry the bits.
  * decimal128 is a (rows, 4) int32 little-endian limb tensor.
  * validity is an unpacked (rows,) uint8 tensor, 1 = valid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class Kind:
    """Type-kind tags, roughly cudf type_id equivalents."""

    BOOL8 = "bool8"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"
    TIMESTAMP_DAYS = "timestamp_days"      # Spark DATE: int32 days since epoch
    TIMESTAMP_MICROS = "timestamp_micros"  # Spark TIMESTAMP: int64 micros
    DECIMAL32 = "decimal32"
    DECIMAL64 = "decimal64"
    DECIMAL128 = "decimal128"
    LIST = "list"
    STRUCT = "struct"


_FIXED_WIDTH_NP = {
    Kind.BOOL8: np.dtype(np.uint8),
    Kind.INT8: np.dtype(np.int8),
    Kind.INT16: np.dtype(np.int16),
    Kind.INT32: np.dtype(np.int32),
    Kind.INT64: np.dtype(np.int64),
    Kind.UINT8: np.dtype(np.uint8),
    Kind.UINT16: np.dtype(np.uint16),
    Kind.UINT32: np.dtype(np.uint32),
    Kind.UINT64: np.dtype(np.uint64),
    Kind.FLOAT32: np.dtype(np.float32),
    Kind.FLOAT64: np.dtype(np.float64),
    Kind.TIMESTAMP_DAYS: np.dtype(np.int32),
    Kind.TIMESTAMP_MICROS: np.dtype(np.int64),
    Kind.DECIMAL32: np.dtype(np.int32),
    Kind.DECIMAL64: np.dtype(np.int64),
}

_FIXED_WIDTH_TORCH = {
    Kind.BOOL8: torch.uint8,
    Kind.INT8: torch.int8,
    Kind.INT16: torch.int16,
    Kind.INT32: torch.int32,
    Kind.INT64: torch.int64,
    Kind.UINT8: torch.uint8,
    Kind.UINT16: torch.uint16,
    Kind.UINT32: torch.uint32,
    Kind.UINT64: torch.uint64,
    Kind.FLOAT32: torch.float32,
    Kind.FLOAT64: torch.float64,
    Kind.TIMESTAMP_DAYS: torch.int32,
    Kind.TIMESTAMP_MICROS: torch.int64,
    Kind.DECIMAL32: torch.int32,
    Kind.DECIMAL64: torch.int64,
}

_SIZES = dict(
    {k: d.itemsize for k, d in _FIXED_WIDTH_NP.items()},
    **{Kind.DECIMAL128: 16},
)

# signed dtype of each width: the lanes bit work runs in
SIGNED_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}


@dataclasses.dataclass(frozen=True)
class DType:
    """A column data type. `scale` follows cudf convention for decimals
    (negative scale = digits after the decimal point is -scale)."""

    kind: str
    scale: int = 0

    @property
    def is_fixed_width(self) -> bool:
        return self.kind in _SIZES

    @property
    def is_decimal(self) -> bool:
        return self.kind in (Kind.DECIMAL32, Kind.DECIMAL64, Kind.DECIMAL128)

    @property
    def is_nested(self) -> bool:
        return self.kind in (Kind.LIST, Kind.STRUCT)

    @property
    def is_string(self) -> bool:
        return self.kind == Kind.STRING

    @property
    def size_bytes(self) -> int:
        """Fixed-width element size in bytes (JCUDF row layout size)."""
        if not self.is_fixed_width:
            raise ValueError(f"{self.kind} is not fixed-width")
        return _SIZES[self.kind]

    @property
    def np_dtype(self) -> np.dtype:
        """Natural numpy dtype of the data buffer."""
        if self.kind in _FIXED_WIDTH_NP:
            return _FIXED_WIDTH_NP[self.kind]
        if self.kind == Kind.DECIMAL128:
            return np.dtype(np.int32)  # (rows, 4) limb layout
        if self.kind == Kind.STRING:
            return np.dtype(np.uint8)  # chars buffer
        raise ValueError(f"{self.kind} has no single buffer dtype")

    @property
    def torch_dtype(self) -> torch.dtype:
        """Torch dtype of the data buffer."""
        if self.kind in _FIXED_WIDTH_TORCH:
            return _FIXED_WIDTH_TORCH[self.kind]
        if self.kind == Kind.DECIMAL128:
            return torch.int32
        if self.kind == Kind.STRING:
            return torch.uint8
        raise ValueError(f"{self.kind} has no single buffer dtype")

    def __repr__(self) -> str:
        if self.is_decimal:
            return f"DType({self.kind}, scale={self.scale})"
        return f"DType({self.kind})"


BOOL8 = DType(Kind.BOOL8)
INT8 = DType(Kind.INT8)
INT16 = DType(Kind.INT16)
INT32 = DType(Kind.INT32)
INT64 = DType(Kind.INT64)
UINT8 = DType(Kind.UINT8)
UINT16 = DType(Kind.UINT16)
UINT32 = DType(Kind.UINT32)
UINT64 = DType(Kind.UINT64)
FLOAT32 = DType(Kind.FLOAT32)
FLOAT64 = DType(Kind.FLOAT64)
STRING = DType(Kind.STRING)
TIMESTAMP_DAYS = DType(Kind.TIMESTAMP_DAYS)
TIMESTAMP_MICROS = DType(Kind.TIMESTAMP_MICROS)
LIST = DType(Kind.LIST)
STRUCT = DType(Kind.STRUCT)


def decimal32(scale: int) -> DType:
    return DType(Kind.DECIMAL32, scale)


def decimal64(scale: int) -> DType:
    return DType(Kind.DECIMAL64, scale)


def decimal128(scale: int) -> DType:
    return DType(Kind.DECIMAL128, scale)


def from_numpy(dt: np.dtype) -> DType:
    """The column dtype of a numpy dtype: the first fixed-width kind
    with that buffer dtype, past the ones a numpy dtype cannot name
    (BOOL8, the timestamps, the decimals); numpy bool is BOOL8."""
    dt = np.dtype(dt)
    for kind, nd in _FIXED_WIDTH_NP.items():
        if kind in (Kind.BOOL8, Kind.TIMESTAMP_DAYS, Kind.TIMESTAMP_MICROS,
                    Kind.DECIMAL32, Kind.DECIMAL64):
            continue
        if nd == dt:
            return DType(kind)
    if dt == np.dtype(np.bool_):
        return BOOL8
    raise ValueError(f"no column dtype for numpy {dt}")
