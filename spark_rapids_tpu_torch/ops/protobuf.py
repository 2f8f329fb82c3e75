"""Protobuf decoder (reference protobuf/ 4,956 LoC: protobuf.hpp:26-67
nested_field_descriptor schema, the wire-type parsing kernels,
Protobuf.java / ProtobufSchemaDescriptor.java): decode a binary column
of serialized protobuf messages into a STRUCT column given a schema
descriptor.

Descriptor model as in the reference: each field is (field_number,
output dtype, encoding DEFAULT/FIXED/ZIGZAG, repeated, required,
default, children for a message).  Unknown fields are skipped by wire
type; missing optional fields take their default (or null); missing
required fields null the row (proto2); nesting depth is capped at 10
(protobuf.hpp MAX_NESTING_DEPTH).

This module is the host oracle and the router.  The oracle copies the
column's bytes to the host, walks each message in Python and builds the
result on the column's device; invalid UTF-8 in a STRING field becomes
U+FFFD here, where the device engine (ops/protobuf_device.py) passes
the bytes through, as in the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType, Kind

MAX_NESTING_DEPTH = 10

# encodings (protobuf.hpp proto_encoding)
DEFAULT = 0
FIXED = 1
ZIGZAG = 2

# wire types
VARINT = 0
I64BIT = 1
LEN = 2
I32BIT = 5


@dataclass
class Field:
    field_number: int
    dtype: DType                       # output column type
    encoding: int = DEFAULT
    repeated: bool = False
    required: bool = False
    default: Any = None
    name: Optional[str] = None
    children: Sequence["Field"] = field(default_factory=tuple)  # message

    @property
    def is_message(self) -> bool:
        return len(self.children) > 0


class _Malformed(Exception):
    pass


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise _Malformed()
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == I64BIT:
        pos += 8
    elif wire == I32BIT:
        pos += 4
    elif wire == LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    else:
        raise _Malformed()
    if pos > len(buf):
        raise _Malformed()  # truncated field payload
    return pos


def _decode_scalar(f: Field, buf: bytes, pos: int, wire: int):
    kind = f.dtype.kind
    if wire == VARINT:
        v, pos = _read_varint(buf, pos)
        if f.encoding == ZIGZAG:
            v = _zigzag(v)
        elif kind in (Kind.INT32, Kind.INT64):
            if v >= 1 << 63:
                v -= 1 << 64   # two's complement
        if kind == Kind.BOOL8:
            v = bool(v)
        elif kind == Kind.INT32:
            v = ((v + 2**31) % 2**32) - 2**31
        return v, pos
    if wire == I64BIT:
        raw = buf[pos:pos + 8]
        if len(raw) < 8:
            raise _Malformed()
        pos += 8
        if kind == Kind.FLOAT64:
            return struct.unpack("<d", raw)[0], pos
        return struct.unpack("<q", raw)[0], pos
    if wire == I32BIT:
        raw = buf[pos:pos + 4]
        if len(raw) < 4:
            raise _Malformed()
        pos += 4
        if kind == Kind.FLOAT32:
            return struct.unpack("<f", raw)[0], pos
        return struct.unpack("<i", raw)[0], pos
    if wire == LEN:
        n, pos = _read_varint(buf, pos)
        raw = buf[pos:pos + n]
        if len(raw) < n:
            raise _Malformed()
        pos += n
        if kind == Kind.STRING:
            return raw.decode("utf-8", errors="replace"), pos
        raise _Malformed()
    raise _Malformed()


def _expected_wire(f: Field) -> int:
    kind = f.dtype.kind
    if f.is_message or kind == Kind.STRING:
        return LEN
    if f.encoding == FIXED:
        return I64BIT if kind in (Kind.INT64, Kind.FLOAT64) else I32BIT
    if kind == Kind.FLOAT64:
        return I64BIT
    if kind == Kind.FLOAT32:
        return I32BIT
    return VARINT


def _decode_message(buf: bytes, fields: Sequence[Field],
                    depth: int) -> dict:
    if depth > MAX_NESTING_DEPTH:
        raise _Malformed()
    by_num = {f.field_number: f for f in fields}
    out: dict = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        wire = tag & 7
        num = tag >> 3
        f = by_num.get(num)
        if f is None:
            pos = _skip(buf, pos, wire)
            continue
        if f.is_message:
            if wire != LEN:
                raise _Malformed()
            n, pos = _read_varint(buf, pos)
            sub = _decode_message(buf[pos:pos + n], f.children, depth + 1)
            pos += n
            if f.repeated:
                out.setdefault(num, []).append(sub)
            else:
                out[num] = sub
            continue
        exp = _expected_wire(f)
        if f.repeated and wire == LEN and exp != LEN:
            # packed repeated scalars
            n, pos = _read_varint(buf, pos)
            end = pos + n
            vals = out.setdefault(num, [])
            while pos < end:
                v, pos = _decode_scalar(f, buf, pos, exp)
                vals.append(v)
            continue
        if wire != exp:
            pos = _skip(buf, pos, wire)  # tolerate mismatched wire type
            continue
        v, pos = _decode_scalar(f, buf, pos, wire)
        if f.repeated:
            out.setdefault(num, []).append(v)
        else:
            out[num] = v  # last value wins (proto3)
    # nested required enforcement propagates up as malformed
    # (reference maybe_check_required_fields nulls the top row)
    for f in fields:
        if f.required and f.field_number not in out:
            raise _Malformed()
    return out


def _build_column(f: Field, values: List, rows: int, device) -> Column:
    """values: one decoded python value (or None) per row; the column
    is built on `device`."""
    if f.repeated:
        child_vals = []
        offsets = np.zeros(rows + 1, np.int32)
        for i, v in enumerate(values):
            if v is None:
                v = []
            child_vals.extend(v)
            offsets[i + 1] = len(child_vals)
        inner = Field(f.field_number, f.dtype, f.encoding, False,
                      f.required, f.default, f.name, f.children)
        child = _build_column(inner, child_vals, len(child_vals), device)
        return Column.make_list(offsets, child, device=device)
    if f.is_message:
        validity = np.array([v is not None for v in values], np.uint8)
        children = []
        for ch in f.children:
            ch_vals = [None if v is None else v.get(ch.field_number,
                                                    ch.default)
                       for v in values]
            children.append(_build_column(ch, ch_vals, rows, device))
        return Column(dtypes.STRUCT, rows,
                      validity=None if validity.all() else
                      torch.from_numpy(validity).to(device),
                      children=tuple(children))
    if f.dtype.is_string:
        return Column.from_strings(values, device)
    return Column.from_pylist(values, f.dtype, device)


def decode_protobuf_host(col: Column, fields: Sequence[Field]) -> Column:
    """The host oracle: the column's bytes to the host, each message
    decoded in Python, the STRUCT built on the column's device.
    Malformed rows and rows missing required fields are null."""
    rows = col.length
    if col.dtype.kind == Kind.LIST:
        chars = col.children[0].data
    elif col.dtype.is_string:
        chars = col.data
    else:
        raise ValueError("binary column required")
    raw = chars.cpu().numpy().tobytes() if chars is not None else b""
    offs = col.offsets.cpu().numpy()
    mask = (np.ones(rows, bool) if col.validity is None
            else col.validity.cpu().numpy().astype(bool))
    decoded: List[Optional[dict]] = []
    for i in range(rows):
        if not mask[i]:
            decoded.append(None)
            continue
        try:
            msg = _decode_message(raw[offs[i]:offs[i + 1]], fields, 0)
        except _Malformed:
            decoded.append(None)
            continue
        decoded.append(msg)
    root = Field(0, dtypes.STRUCT, children=tuple(fields))
    return _build_column(root, decoded, rows, col.device)


def decode_protobuf_to_struct(col: Column,
                              fields: Sequence[Field]) -> Column:
    """Binary (LIST<UINT8> or STRING) column of serialized messages ->
    STRUCT column (protobuf.hpp:64 decode_protobuf_to_struct).  Malformed
    rows and rows missing required fields are null.

    A card column with a schema the device engine supports goes to the
    engine (ops/protobuf_device.py, the field-step counterpart of the
    reference's protobuf_kernels.cu); a CPU column, an unsupported
    schema, and a column the engine hands back (a row past the repeat
    cap) take the host oracle, whole-column.
    PD.LAST_CALL names the route each call took."""
    from spark_rapids_tpu_torch.ops import protobuf_device as PD
    if col.dtype.kind != Kind.LIST and not col.dtype.is_string:
        raise ValueError("binary column required")
    if PD.use_device(col, fields):
        out = PD.decode_protobuf_to_struct_device(col, fields)
        if out is not None:
            PD.note_route("device")
            return out
        PD.note_route("host", fallback=True, rows=col.length)
    else:
        PD.note_route("host", rows=col.length)
    return decode_protobuf_host(col, fields)
