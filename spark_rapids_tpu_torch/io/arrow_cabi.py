"""Zero-copy Arrow C-data-interface ingest: wrap the buffers of a
pyarrow RecordBatch (or anything exporting ``__arrow_c_array__``) as
Columns WITHOUT copying — the "hand batches across the JVM boundary
for free" door ("Zero-Cost, Arrow-Enabled Data Interface for Apache
Spark", PAPERS.md).

Zero-copy contract (``device="cpu"``):

  * fixed-width data buffers, string offsets, and string chars become
    CPU tensors ALIASING the Arrow memory (pointer identity holds:
    ``col.data.data_ptr() == buffer.address + offset * itemsize``).
    float64 is native float64 over the same memory; decimal128
    reshapes the 16-byte limbs in place.  Arrow buffers are immutable
    and torch has no read-only tensors; the port's ops never write into
    a column's tensors.
  * only layout mismatches copy: Arrow's packed validity bitmaps and
    bit-packed booleans expand to the engine's unpacked uint8 masks
    (an O(rows/8 -> rows) expansion, never a value copy).
  * lifetime is safe without the caller keeping the batch alive: every
    tensor holds a reference to its ``pyarrow.Buffer``, which owns the
    allocation — freeing the RecordBatch (or its handle in the shim
    registry) cannot pull memory out from under a column.

On ``device="cuda"`` (the default) each buffer, aliased as above, is
uploaded once.

Sliced batches (``batch.offset != 0``) stay zero-copy for fixed-width
columns (the view starts ``offset`` items in); sliced STRING columns
would need re-based offsets, so they take one normalizing copy and are
the documented exception.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column


class ArrowIngestException(ValueError):
    """Typed ingest refusal: not an Arrow batch, or a column type /
    layout outside the zero-copy contract."""


class _BufferView:
    """A numpy array interface over part of a pyarrow Buffer that keeps
    the Buffer alive for as long as the array (and the tensor over it)
    lives.  Buffers imported through the C interface refuse a writable
    buffer-protocol export, so the view goes by address."""

    __slots__ = ("buf", "__array_interface__")

    def __init__(self, buf, np_dtype: np.dtype, offset_items: int,
                 count: int):
        self.buf = buf
        self.__array_interface__ = {
            "shape": (count,), "typestr": np_dtype.str, "version": 3,
            "data": (buf.address + offset_items * np_dtype.itemsize,
                     False)}


def _view(buf, dtype: torch.dtype, offset_items: int,
          count: int) -> torch.Tensor:
    """Zero-copy CPU tensor of ``count`` items of a pyarrow Buffer
    starting ``offset_items`` in."""
    if count == 0 or buf is None:
        return torch.empty(0, dtype=dtype)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(np.asarray(_BufferView(buf, np_dtype,
                                                   offset_items, count)))


def _unpack_bits(buf, offset: int, count: int) -> torch.Tensor:
    """Arrow packed LSB-first bits -> unpacked uint8 0/1 (the one
    layout conversion that must copy)."""
    nbytes = (offset + count + 7) // 8
    bits = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes),
                         bitorder="little")
    return torch.from_numpy(bits[offset:offset + count].copy())


def _wrap_column(arr, pa) -> Column:
    t = arr.type
    n = len(arr)
    off = arr.offset
    bufs = arr.buffers()
    validity = None
    if arr.null_count:
        validity = _unpack_bits(bufs[0], off, n)

    if pa.types.is_boolean(t):
        data = _unpack_bits(bufs[1], off, n)
        return Column(dtypes.BOOL8, n, data=data, validity=validity)

    if pa.types.is_timestamp(t):
        if t.unit != "us":
            raise ArrowIngestException(
                f"timestamp unit {t.unit!r} unsupported (Spark "
                f"timestamps are micros)")
        return Column(dtypes.TIMESTAMP_MICROS, n,
                      data=_view(bufs[1], torch.int64, off, n),
                      validity=validity)

    fixed = _FIXED_TYPES(pa).get(t.id)
    if fixed is not None:
        dt = fixed
        return Column(dt, n, data=_view(bufs[1], dt.torch_dtype, off, n),
                      validity=validity)

    if pa.types.is_decimal128(t):
        limbs = _view(bufs[1], torch.int32, 4 * off, 4 * n).reshape(n, 4)
        return Column(dtypes.decimal128(-t.scale), n, data=limbs,
                      validity=validity)

    if pa.types.is_string(t) or pa.types.is_binary(t):
        offs = (_view(bufs[1], torch.int32, off, n + 1)
                if bufs[1] is not None else torch.zeros(1, dtype=torch.int32))
        chars = _view(bufs[2], torch.uint8, 0,
                      bufs[2].size if bufs[2] is not None else 0)
        if len(offs) and int(offs[0]) != 0:
            # sliced string column: re-base offsets + trim chars (the
            # documented copy exception — offsets must start at 0)
            base = int(offs[0])
            chars = chars[base:int(offs[-1])].clone()
            offs = offs - base
        return Column(dtypes.STRING, n, data=chars, validity=validity,
                      offsets=offs if len(offs)
                      else torch.zeros(1, dtype=torch.int32))

    raise ArrowIngestException(
        f"arrow type {t} is outside the zero-copy ingest contract "
        f"(fixed-width, bool, decimal128, utf8/binary)")


def _FIXED_TYPES(pa):
    """pyarrow type id -> DType.  Built lazily so the module imports
    without pyarrow present."""
    global _FIXED_CACHE
    if _FIXED_CACHE is None:
        _FIXED_CACHE = {
            pa.int8().id: dtypes.INT8,
            pa.int16().id: dtypes.INT16,
            pa.int32().id: dtypes.INT32,
            pa.int64().id: dtypes.INT64,
            pa.uint8().id: dtypes.UINT8,
            pa.uint16().id: dtypes.UINT16,
            pa.uint32().id: dtypes.UINT32,
            pa.uint64().id: dtypes.UINT64,
            pa.float32().id: dtypes.FLOAT32,
            pa.float64().id: dtypes.FLOAT64,
            pa.date32().id: dtypes.TIMESTAMP_DAYS,
        }
    return _FIXED_CACHE


_FIXED_CACHE = None


def _to_device(col: Column, device) -> Column:
    """One upload per buffer (the CPU keeps the aliasing views)."""
    if torch.device(device).type == "cpu":
        return col

    def put(t):
        return None if t is None else t.to(device)

    return Column(col.dtype, col.length, data=put(col.data),
                  validity=put(col.validity), offsets=put(col.offsets))


def ingest(obj, device="cuda") -> Tuple[List[Column], List[str]]:
    """Wrap an Arrow batch as columns without copying, on ``device``.

    Accepts a ``pyarrow.RecordBatch``, a single-chunk
    ``pyarrow.Table``, or ANY object exporting the Arrow C data
    interface (``__arrow_c_array__`` — the PyCapsule protocol a
    JVM/Spark caller's FFI surface speaks); the C-interface import is
    itself zero-copy.  Returns ``(columns, names)``."""
    try:
        import pyarrow as pa
    except ImportError as e:
        raise ArrowIngestException(
            f"arrow ingest requires pyarrow: {e}") from e
    if isinstance(obj, pa.Table):
        # refuse BEFORE any chunk combining: combine_chunks() would
        # deep-copy a multi-chunk table, silently breaking the
        # pointer-identity contract this door exists to keep
        if any(obj.column(i).num_chunks > 1
               for i in range(obj.num_columns)):
            raise ArrowIngestException(
                "multi-chunk Table cannot ingest zero-copy; hand over "
                "RecordBatches individually")
        batches = obj.to_batches()
        batch = batches[0] if batches else pa.record_batch(
            [pa.array([], f.type) for f in obj.schema], obj.schema)
    elif isinstance(obj, pa.RecordBatch):
        batch = obj
    elif hasattr(obj, "__arrow_c_array__"):
        batch = pa.record_batch(obj)   # zero-copy C-interface import
    else:
        raise ArrowIngestException(
            f"cannot ingest {type(obj).__name__}: expected a pyarrow "
            f"RecordBatch/Table or an __arrow_c_array__ exporter")
    cols = [_to_device(_wrap_column(batch.column(i), pa), device)
            for i in range(batch.num_columns)]
    return cols, list(batch.schema.names)


def ingest_table(obj, device="cuda"):
    """:func:`ingest` packaged as a named :class:`Table`."""
    from spark_rapids_tpu_torch.columns.table import Table
    cols, names = ingest(obj, device)
    return Table(cols, names=names)
