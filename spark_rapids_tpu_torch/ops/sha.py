"""SHA-2 family hashes with null preservation + host CRC32.

Reference: src/main/cpp/src/hash/sha.cpp (sha224/256/384/512_nulls_preserved
-- hex-digest string output, input nulls preserved as nulls) and
HashJni.cpp:134-157 (hostCrc32 -- zlib crc32 over a host buffer, used for
shuffle block checksums).

Per-row messages are independent, so SHA runs one lane per row:
ops/sha_device.py runs the block compression for every row at once on
the column's device.  A column on the card goes there and a column on
the CPU to the hashlib host path, which doubles as the differential
oracle; SPARK_RAPIDS_TPU_SHA=host|device pins either engine on any
device (the host engine's result lands on the column's device).  CRC32
stays host zlib: the same decision the reference makes (HashJni.cpp
hostCrc32).
"""

from __future__ import annotations

import hashlib
import os
import zlib
from typing import Optional, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columns.column import Column

def _use_device(col: Column) -> bool:
    mode = os.environ.get("SPARK_RAPIDS_TPU_SHA", "auto")
    if mode == "host":
        return False
    if not (col.dtype.is_string or col.dtype.is_fixed_width):
        return False
    return mode == "device" or col.device.type == "cuda"


def _row_bytes(col: Column):
    """Yield per-row byte strings (None for null rows)."""
    mask = (np.ones(col.length, bool) if col.validity is None
            else col.validity.cpu().numpy().astype(bool)[: col.length])
    if col.dtype.is_string:
        chars = (col.data.cpu().numpy().tobytes() if col.data is not None
                 else b"")
        offs = col.offsets.cpu().numpy()
        for i in range(col.length):
            yield chars[offs[i]: offs[i + 1]] if mask[i] else None
    elif col.dtype.is_fixed_width:
        host = col.data.cpu().numpy()
        for i in range(col.length):
            yield host[i].tobytes() if mask[i] else None
    else:
        raise NotImplementedError(f"sha of {col.dtype.kind}")


def _sha_impl(algo_name: str, col: Column) -> Column:
    out = [None if b is None else hashlib.new(algo_name, b).hexdigest()
           for b in _row_bytes(col)]
    res = Column.from_strings(out, col.device)
    if col.validity is not None and res.validity is None:
        # a validity buffer wherever the input has one, as the device
        # engine keeps it: both engines give the same buffers
        res = Column(res.dtype, res.length, data=res.data,
                     offsets=res.offsets,
                     validity=torch.ones(col.length, dtype=torch.uint8,
                                         device=col.device))
    return res


def _sha(algo_name: str, bits: int, col: Column) -> Column:
    if _use_device(col):
        from spark_rapids_tpu_torch.ops import sha_device
        return sha_device._sha_device(col, bits)
    return _sha_impl(algo_name, col)


def sha224_nulls_preserved(col: Column) -> Column:
    return _sha("sha224", 224, col)


def sha256_nulls_preserved(col: Column) -> Column:
    return _sha("sha256", 256, col)


def sha384_nulls_preserved(col: Column) -> Column:
    return _sha("sha384", 384, col)


def sha512_nulls_preserved(col: Column) -> Column:
    return _sha("sha512", 512, col)


def host_crc32(crc: int, buffer: Optional[Union[bytes, np.ndarray]],
               length: Optional[int] = None) -> int:
    """zlib CRC32 over a host buffer (reference Hash.hostCrc32).  `buffer`
    may be None only when length is 0."""
    if buffer is None:
        if length not in (0, None):
            raise ValueError("len is not zero for empty buffer")
        return crc & 0xFFFFFFFF
    # raw buffer bytes, like the reference's unsigned char* + len
    data = buffer.tobytes() if isinstance(buffer, np.ndarray) else \
        bytes(buffer)
    if length is not None:
        data = data[:length]
    return zlib.crc32(data, crc) & 0xFFFFFFFF
