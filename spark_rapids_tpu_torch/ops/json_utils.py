"""from_json family (reference from_json_to_raw_map.cu,
from_json_to_structs.cu, json_utils.hpp helpers; JSONUtils.java:159-188):
Spark from_json to MAP<STRING,STRING> and to typed structs, plus the
remove_quotes / concat_json helpers, all over the tolerant parser in
ops/json_path.py.  Every entry returns its columns on the input column's
device."""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType, Kind
from spark_rapids_tpu_torch.ops import cast_string, json_path
from spark_rapids_tpu_torch.ops.json_path import (_Invalid, _Parser,
                                                  _render_json)


def _parse_rows(col: Column, allow_leading_zeros: bool = False):
    for v in col.to_pylist():
        if v is None:
            yield None
            continue
        try:
            yield _Parser(v, allow_leading_zeros).parse()
        except _Invalid:
            yield None


def _value_as_raw_string(v) -> str:
    """Raw-map value rendering: string scalars unescaped, everything
    else as JSON text with number tokens VERBATIM -- the reference's
    from_json_to_raw_map copies raw token substrings, no Double
    normalization (from_json_to_raw_map.cu)."""
    if v[0] == "str":
        return v[1]
    return _render_json(v, normalize_numbers=False)


def _raw_pairs(tree) -> List[Tuple[str, str]]:
    """An object tree's (key, raw value) pairs: keys in first-seen
    order, a duplicated key keeping its LAST value."""
    seen = {}
    for k, v in tree[1]:
        seen[k] = _value_as_raw_string(v)
    return list(seen.items())


def _on_card(col: Column) -> bool:
    return col.device.type == "cuda"


def from_json_to_raw_map(col: Column,
                         allow_leading_zeros: bool = False) -> Column:
    """JSON object rows -> MAP<STRING,STRING>
    (JSONUtils.extractRawMapFromJsonString:159).  Non-object / invalid
    rows are null; duplicate keys keep the last value.

    Engine choice is a measurement: the structural-index tokenizer
    (ops/json_tokenizer), the device multi-capture scan
    (ops/raw_map_device.py) and this host tree-builder are
    byte-identical candidates; the calibrator picks per (doc shape,
    device).  The tree-builder stays the oracle and handles every
    engine's fallback rows."""
    from spark_rapids_tpu_torch.ops import json_tokenizer as JT
    from spark_rapids_tpu_torch.ops import raw_map_device as RM
    min_rows = int(os.environ.get(
        "SPARK_RAPIDS_TPU_RAW_MAP_DEVICE_MIN", "256"))
    force = os.environ.get(
        "SPARK_RAPIDS_TPU_FORCE_DEVICE_RAW_MAP") == "1"
    if force:
        engine = "device_scan"
    elif col.length < min_rows:
        engine = "host"
    else:
        engines = {
            "host": lambda c: _raw_map_host(c, allow_leading_zeros),
            "device_scan": lambda c:
                RM.from_json_to_raw_map_device(c, allow_leading_zeros),
            "tokenizer": lambda c:
                JT.from_json_to_raw_map_tokenized(c,
                                                  allow_leading_zeros),
        }
        # static default below the calibration floor: the device scan on
        # the card, the host on the CPU; above it the measurement decides
        engine = json_path.route_json_engine(
            "json.raw_map", col, engines,
            "device_scan" if _on_card(col) else "host")
    # record the path AFTER fallback resolution: a device scan that
    # declines the shape (returns None) really ran on the host
    if engine == "tokenizer":
        _obs.record_kernel_path("from_json_raw_map", "tokenizer",
                                col.length)
        return JT.from_json_to_raw_map_tokenized(col, allow_leading_zeros)
    if engine == "device_scan":
        out = RM.from_json_to_raw_map_device(col, allow_leading_zeros)
        if out is not None:
            _obs.record_kernel_path("from_json_raw_map", "device_scan",
                                    col.length)
            return out
    _obs.record_kernel_path("from_json_raw_map", "host", col.length)
    return _raw_map_host(col, allow_leading_zeros)


def _raw_map_host(col: Column,
                  allow_leading_zeros: bool = False) -> Column:
    """The host tree-builder -- the oracle every raw-map engine falls
    back to per row."""
    assert col.dtype.is_string
    rows = col.length
    keys: List[str] = []
    vals: List[str] = []
    new_offs = np.zeros(rows + 1, np.int32)
    validity = np.zeros(rows, bool)
    for i, tree in enumerate(_parse_rows(col, allow_leading_zeros)):
        if tree is not None and tree[0] == "obj":
            validity[i] = True
            for k, v in _raw_pairs(tree):
                keys.append(k)
                vals.append(v)
        new_offs[i + 1] = len(keys)
    dev = col.device
    st = Column.make_struct(len(keys), [Column.from_strings(keys, dev),
                                        Column.from_strings(vals, dev)])
    return Column(dtypes.LIST, rows,
                  validity=None if validity.all()
                  else torch.from_numpy(validity.astype(np.uint8)).to(dev),
                  offsets=torch.from_numpy(new_offs).to(dev),
                  children=(st,))


def from_json_to_structs(col: Column,
                         fields: Sequence[Tuple[str, DType]]) -> Column:
    """JSON object rows -> STRUCT column with the requested fields
    (JSONUtils.fromJSONToStructs:188; schema as parallel vectors in the
    reference json_utils.hpp:10-23).  Missing/mistyped fields are null;
    invalid rows null the whole struct.

    A flat schema is just a one-level nested schema: delegate so the
    routing and null/leniency rules live in exactly one place
    (from_json_to_structs_nested)."""
    return from_json_to_structs_nested(col, ("struct", list(fields)))


def convert_from_strings(col: Column, dtype: DType) -> Column:
    """String column -> typed column with Spark cast semantics
    (json_utils.hpp:67 convert_from_strings)."""
    if dtype.is_string:
        return col
    if dtype.kind == Kind.BOOL8:
        # exact 'true'/'false' compares at each row's first bytes
        lens = col.string_lengths()
        starts = col.offsets[:-1].to(torch.int64)
        n = col.data.shape[0]

        def _eq(word: bytes):
            m = lens == len(word)
            if n:
                for k, b in enumerate(word):
                    m &= col.data[(starts + k).clamp(0, n - 1)] == b
            return m
        is_t = _eq(b"true")
        valid = (is_t | _eq(b"false")) & col.valid_mask()
        return Column(dtype, col.length, data=is_t.to(torch.uint8),
                      validity=None if bool(valid.all())
                      else valid.to(torch.uint8))
    if dtype.kind in (Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64):
        return cast_string.string_to_integer(col, dtype)
    if dtype.kind in (Kind.FLOAT32, Kind.FLOAT64):
        return cast_string.string_to_float(col, dtype)
    raise NotImplementedError(f"from_json field type {dtype.kind}")


def remove_quotes(col: Column, nullify_if_not_quoted: bool = False
                  ) -> Column:
    """Strip one pair of surrounding double quotes (json_utils.hpp:84)."""
    assert col.dtype.is_string
    out = []
    for v in col.to_pylist():
        if v is None:
            out.append(None)
        elif len(v) >= 2 and v[0] == '"' and v[-1] == '"':
            out.append(v[1:-1])
        else:
            out.append(None if nullify_if_not_quoted else v)
    return Column.from_strings(out, col.device)


def concat_json(col: Column) -> Tuple[bytes, str, Column]:
    """Join all rows into one JSON-lines buffer with a chosen delimiter
    (json_utils.hpp:110 concat_json): returns (buffer, delimiter,
    is_valid-and-non-empty BOOL8 column).  Null/empty/whitespace rows are
    replaced by empty entries."""
    assert col.dtype.is_string
    candidates = "\n\r\x01\x02\x03"
    vals = col.to_pylist()
    joined_src = "".join(v for v in vals if v)
    delim = next((c for c in candidates if c not in joined_src), None)
    if delim is None:
        raise ValueError("no usable delimiter byte found")
    parts = []
    valid = np.zeros(col.length, np.uint8)
    for i, v in enumerate(vals):
        if v is None or not v.strip():
            parts.append("")
        else:
            parts.append(v)
            valid[i] = 1
    buffer = (delim.join(parts) + delim).encode()
    return buffer, delim, Column(dtypes.BOOL8, col.length,
                                 data=torch.from_numpy(valid).to(
                                     col.device))


# ----------------------------------------- nested from_json schemas

def _struct(n: int, children, validity: np.ndarray, device) -> Column:
    v = None if validity.all() else \
        torch.from_numpy(validity.astype(np.uint8)).to(device)
    return Column(dtypes.STRUCT, n, validity=v, children=tuple(children))


def _build_json_column(values, spec, device) -> Column:
    """Recursive column builder from parsed JSON value trees, on
    `device`.

    spec: a leaf DType, ("struct", [(name, spec), ...]), or
    ("list", spec) -- mirroring the reference's nested schema vectors
    (json_utils.hpp:10-23, JSONUtils.fromJSONToStructs).  Mistyped
    values null the row at that level (Spark from_json leniency)."""
    if isinstance(spec, DType):
        raw = [None if v is None or v == ("lit", "null")
               else _value_as_raw_string(v) for v in values]
        return convert_from_strings(Column.from_strings(raw, device), spec)
    tag, arg = spec
    n = len(values)
    if tag == "struct":
        validity = np.array(
            [v is not None and v[0] == "obj" for v in values], bool)
        # one dict per row (duplicate keys: last wins), not per field
        dicts = [dict(v[1]) if v is not None and v[0] == "obj" else None
                 for v in values]
        children = []
        for name, child_spec in arg:
            sub = []
            for d in dicts:
                got = None if d is None else d.get(name)
                sub.append(None if got == ("lit", "null") else got)
            children.append(_build_json_column(sub, child_spec, device))
        return _struct(n, children, validity, device)
    if tag == "list":
        validity = np.array(
            [v is not None and v[0] == "arr" for v in values], bool)
        offs = np.zeros(n + 1, np.int32)
        flat = []
        for i, v in enumerate(values):
            if validity[i]:
                flat.extend(None if it == ("lit", "null") else it
                            for it in v[1])
            offs[i + 1] = len(flat)
        return Column.make_list(
            offs, _build_json_column(flat, arg, device),
            validity=None if validity.all() else validity.astype(np.uint8),
            device=device)
    raise ValueError(f"unknown schema node {tag!r}")


def from_json_to_structs_nested(col: Column, schema,
                                allow_leading_zeros: bool = False
                                ) -> Column:
    """JSON rows -> arbitrarily nested STRUCT/LIST column
    (JSONUtils.fromJSONToStructs:188 with a nested Schema).  `schema`
    must be a ("struct", ...) node; invalid JSON rows are null.

    Nested schemas route to the device scan too: struct fields compose
    scan paths, list nodes split elements with tensor ops and recurse
    (ops/from_json_device.py).  The engine choice is a measurement
    (host tree-builder / device scan / the structural-index tokenizer
    for FLAT schemas), calibrated per (schema shape, doc shape, device);
    the tree-builder stays the oracle and the per-row fallback."""
    assert col.dtype.is_string
    if not (isinstance(schema, tuple) and schema[0] == "struct"):
        raise ValueError("top-level schema must be a struct")
    from spark_rapids_tpu_torch.ops import from_json_device as FJ
    from spark_rapids_tpu_torch.ops import json_tokenizer as JT
    min_rows = int(os.environ.get(
        "SPARK_RAPIDS_TPU_FROM_JSON_DEVICE_MIN", "256"))
    force = os.environ.get(
        "SPARK_RAPIDS_TPU_FORCE_DEVICE_FROM_JSON") == "1"
    fields = list(schema[1])
    flat = all(isinstance(spec, DType) for _n, spec in fields)

    def _host(c):
        return _build_json_column(
            list(_parse_rows(c, allow_leading_zeros)), schema, c.device)

    if force:
        engine = "device_scan"
    elif col.length < min_rows:
        engine = "host"
    else:
        engines = {
            "host": _host,
            "device_scan": lambda c: FJ.from_json_to_structs_device(
                c, fields, allow_leading_zeros),
        }
        if flat:
            engines["tokenizer"] = \
                lambda c: JT.from_json_to_structs_tokenized(
                    c, fields, allow_leading_zeros)
        engine = json_path.route_json_engine(
            "json.from_json", col, engines,
            "device_scan" if _on_card(col) else "host",
            extra=f"f{len(fields)}|flat{int(flat)}")
    # record the path AFTER fallback resolution: an engine that
    # declines the shape (returns None) really ran on the host
    if engine == "tokenizer" and flat:
        out = JT.from_json_to_structs_tokenized(col, fields,
                                                allow_leading_zeros)
        if out is not None:
            _obs.record_kernel_path("from_json_structs", "tokenizer",
                                    col.length)
            return out
    if engine == "device_scan":
        out = FJ.from_json_to_structs_device(
            col, fields, allow_leading_zeros)
        if out is not None:
            _obs.record_kernel_path("from_json_structs", "device_scan",
                                    col.length)
            return out
    _obs.record_kernel_path("from_json_structs", "host", col.length)
    return _host(col)
