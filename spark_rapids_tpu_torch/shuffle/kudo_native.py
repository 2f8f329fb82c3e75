"""ctypes binding over the pure-C++ kudo engine (native/kudo_cabi.cpp
with native/kudo_native.hpp), built at first use into build/native/
(utils/native.py).

The Python engine in shuffle/kudo.py is the golden-validated SPEC; this
binding routes the JNI door's kudo write and merge through C++ so that
(a) JVM executor threads crossing via JNI never hold the GIL for the
serialization (the reference's kudo is pure JVM for exactly this reason:
kudo/KudoSerializer.java:48-170), and (b) Python callers get true
multi-thread scaling: ctypes releases the GIL for the duration of each
C call, so concurrent writes on one immutable native table run in
parallel.  Host only: a table's buffers are read to the host once
(``.cpu()`` to numpy, shuffle/kudo.prepare_host_columns) and a merged
table is uploaded to ``device`` one buffer at a time.

Differential contract: byte-identical output to shuffle/kudo.py on
every input.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.shuffle.kudo import (HostColumnView,
                                                 prepare_host_columns)
from spark_rapids_tpu_torch.shuffle.schema import Field
from spark_rapids_tpu_torch.utils import native as _native

_lock = threading.Lock()
_lib = None
_tried = False


def available() -> bool:
    return _load() is not None


def _bind(lib):
    lib.kudo_last_error.restype = ctypes.c_char_p
    lib.kudo_table_create.restype = ctypes.c_void_p
    lib.kudo_table_create.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.kudo_col_set_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64]
    lib.kudo_col_set_validity.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64]
    lib.kudo_col_set_offsets.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64]
    lib.kudo_table_free.argtypes = [ctypes.c_void_p]
    lib.kudo_write.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.kudo_write.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.kudo_write_row_count_only.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.kudo_write_row_count_only.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.kudo_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.kudo_merge.restype = ctypes.c_void_p
    lib.kudo_merge.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.kudo_table_num_rows.restype = ctypes.c_int64
    lib.kudo_table_num_rows.argtypes = [ctypes.c_void_p]
    lib.kudo_table_n_flat.restype = ctypes.c_int32
    lib.kudo_table_n_flat.argtypes = [ctypes.c_void_p]
    for name in ("kudo_col_data_len", "kudo_col_validity_len",
                 "kudo_col_offsets_len"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name in ("kudo_col_has_validity", "kudo_col_has_offsets"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.kudo_col_get_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p]
    lib.kudo_col_get_validity.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p]
    lib.kudo_col_get_offsets.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p]


def _load():
    """The library, built on first use (None when g++ fails, or with
    SPARK_RAPIDS_TPU_DISABLE_NATIVE=1)."""
    global _lib, _tried
    if _native.disabled():
        return None
    with _lock:
        if _tried:
            return _lib
    # build and bind outside the lock (utils/native.py)
    lib = None
    try:
        lib = ctypes.CDLL(str(_native.build_library(
            "kudo_native", "kudo_cabi.cpp", headers=("kudo_native.hpp",))))
        _bind(lib)
    except (OSError, subprocess.SubprocessError):
        lib = None
    with _lock:
        if not _tried:
            _lib, _tried = lib, True
        return _lib


def library_path():
    """Where the built library lives (None when unavailable)."""
    return (_native.library_path("kudo_native", ("kudo_cabi.cpp",
                                                 "kudo_native.hpp"))
            if available() else None)


KIND_FIXED, KIND_STRING, KIND_LIST, KIND_STRUCT = 0, 1, 2, 3


def _flat_schema(fields: Sequence[Field]):
    """Flatten a Field tree to (kinds, item_sizes, num_children) in
    depth-first pre-order — the C++ engine's schema encoding."""
    kinds: List[int] = []
    items: List[int] = []
    nch: List[int] = []

    def rec(f: Field):
        kind = f.dtype.kind
        if kind == Kind.STRING:
            kinds.append(KIND_STRING)
            items.append(0)
            nch.append(0)
        elif kind == Kind.LIST:
            kinds.append(KIND_LIST)
            items.append(0)
            nch.append(1)
            rec(f.children[0])
        elif kind == Kind.STRUCT:
            kinds.append(KIND_STRUCT)
            items.append(0)
            nch.append(len(f.children))
            for ch in f.children:
                rec(ch)
        else:
            kinds.append(KIND_FIXED)
            items.append(16 if kind == Kind.DECIMAL128
                         else f.dtype.size_bytes)
            nch.append(0)

    for f in fields:
        rec(f)
    return kinds, items, nch


def _i32_arr(values: List[int]):
    return (ctypes.c_int32 * len(values))(*values)


class NativeKudoTable:
    """Owns a C++ kudo::Table handle.  Immutable once built; concurrent
    write() calls are safe and GIL-free."""

    def __init__(self, handle: int, fields: List[Field]):
        self._handle = handle
        self.fields = fields

    def __del__(self):
        # interpreter teardown may have cleared module globals; the
        # OS reclaims the native memory then anyway
        try:
            lib = _lib
            if lib is not None and self._handle:
                lib.kudo_table_free(self._handle)
        except Exception:
            pass
        self._handle = 0

    @property
    def num_rows(self) -> int:
        return int(_load().kudo_table_num_rows(self._handle))

    def write(self, row_offset: int, num_rows: int) -> bytes:
        lib = _load()
        n = ctypes.c_int64()
        buf = lib.kudo_write(self._handle, row_offset, num_rows,
                             ctypes.byref(n))
        if not buf or n.value < 0:
            raise ValueError(lib.kudo_last_error().decode())
        try:
            return ctypes.string_at(buf, n.value)
        finally:
            lib.kudo_buf_free(buf)

    def to_table(self, device="cuda") -> Table:
        """Import the native host table as Columns on `device` (one
        crossing; used on the merge side): one upload a buffer."""
        lib = _load()
        idx = [0]

        def buf(getter, i, length):
            raw = ctypes.create_string_buffer(max(int(length), 1))
            getter(self._handle, i, raw)
            return raw.raw[:length]

        def up(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

        def read_col(f: Field, rows: int) -> Column:
            i = idx[0]
            idx[0] += 1
            validity = None
            if lib.kudo_col_has_validity(self._handle, i):
                vlen = lib.kudo_col_validity_len(self._handle, i)
                bits = np.unpackbits(
                    np.frombuffer(buf(lib.kudo_col_get_validity, i, vlen),
                                  np.uint8), bitorder="little")[:rows]
                validity = up(bits.astype(np.uint8))
            kind = f.dtype.kind
            if kind in (Kind.STRING, Kind.LIST):
                olen = lib.kudo_col_offsets_len(self._handle, i)
                offsets = np.frombuffer(
                    buf(lib.kudo_col_get_offsets, i, olen * 4), "<i4").copy()
                child_rows = int(offsets[-1]) if len(offsets) else 0
                if kind == Kind.STRING:
                    dlen = lib.kudo_col_data_len(self._handle, i)
                    chars = np.frombuffer(buf(lib.kudo_col_get_data, i, dlen),
                                          np.uint8).copy()
                    return Column(f.dtype, rows, data=up(chars),
                                  validity=validity, offsets=up(offsets))
                child = read_col(f.children[0], child_rows)
                return Column(f.dtype, rows, validity=validity,
                              offsets=up(offsets), children=(child,))
            if kind == Kind.STRUCT:
                children = tuple(read_col(ch, rows) for ch in f.children)
                return Column(f.dtype, rows, validity=validity,
                              children=children)
            dlen = lib.kudo_col_data_len(self._handle, i)
            raw = buf(lib.kudo_col_get_data, i, dlen)
            if kind == Kind.DECIMAL128:
                data = np.frombuffer(raw, "<i4").reshape(rows, 4).copy()
            else:
                data = np.frombuffer(raw, f.dtype.np_dtype).copy()
            return Column(f.dtype, rows, data=up(data), validity=validity)

        rows = self.num_rows
        return Table([read_col(f, rows) for f in self.fields])


def table_from_columns(columns: Sequence[Column]) -> NativeKudoTable:
    """One-time host materialization (each buffer read to the host
    once) + export into the C++ engine.  After this, every write() is
    pure C++ (no GIL, no numpy)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native kudo library is unavailable "
                           "(g++ build failed or disabled)")
    views = prepare_host_columns(list(columns))
    fields = [_field_of_view(v) for v in views]
    kinds, items, nch = _flat_schema(fields)
    num_rows = columns[0].length if columns else 0
    handle = lib.kudo_table_create(
        num_rows, len(kinds), _i32_arr(kinds), _i32_arr(items),
        _i32_arr(nch))
    if not handle:
        raise MemoryError(lib.kudo_last_error().decode())
    nt = NativeKudoTable(handle, fields)
    idx = [0]

    def load(v: HostColumnView):
        i = idx[0]
        idx[0] += 1
        if v.validity is not None:
            b = v.validity.tobytes()
            lib.kudo_col_set_validity(handle, i, b, len(b))
        if v.offsets is not None:
            b = np.ascontiguousarray(v.offsets, "<i4").tobytes()
            lib.kudo_col_set_offsets(handle, i, b, len(b) // 4)
        if v.data is not None and v.dtype.kind not in (Kind.LIST,
                                                       Kind.STRUCT):
            b = np.ascontiguousarray(v.data).tobytes()
            lib.kudo_col_set_data(handle, i, b, len(b))
        for ch in v.children:
            load(ch)

    for v in views:
        load(v)
    return nt


def _field_of_view(v: HostColumnView) -> Field:
    return Field(v.dtype, tuple(_field_of_view(c) for c in v.children))


def write_to_bytes(columns: Sequence[Column], row_offset: int,
                   num_rows: int) -> bytes:
    """Convenience one-shot: export + single partition write.  For
    per-partition loops, hold a NativeKudoTable (or go through the
    JNI path, whose handle-keyed memo amortizes the export and is
    purged when handles are released)."""
    return table_from_columns(columns).write(row_offset, num_rows)


def merge_blob(blob: bytes, fields: Sequence[Field]) -> NativeKudoTable:
    """Merge a concatenated stream of kudo blocks natively
    (KudoTableMerger analog; byte-semantics of kudo.merge_to_table)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native kudo library is unavailable "
                           "(g++ build failed or disabled)")
    kinds, items, nch = _flat_schema(fields)
    handle = lib.kudo_merge(blob, len(blob), len(kinds), _i32_arr(kinds),
                            _i32_arr(items), _i32_arr(nch))
    if not handle:
        raise ValueError(lib.kudo_last_error().decode())
    return NativeKudoTable(handle, list(fields))


def merge_to_table(blob: bytes, fields: Sequence[Field],
                   device="cuda") -> Table:
    return merge_blob(blob, fields).to_table(device)
