"""Embedded-interpreter entry points for the JNI shim
(native/jni/spark_rapids_tpu_jni.cpp calls the JAX package's module of
the same name by these names; a JNI library that embeds this one is open
work, ROADMAP).

Every function here takes and returns only primitives, strings, bytes
and flat lists of them: the shapes a hand-written JNI layer can marshal
without any Python C-API object gymnastics.  This is the
process-boundary twin of shim/jni_api.py: jni_api mirrors the
reference's *Jni.cpp export signatures (unwrap jlong handles -> op ->
wrap), and this module adapts those to the embedded-CPython calling
convention (reference: src/main/cpp/src/hash/HashJni.cpp:31-46 unwraps
jlongs the same way before calling the native op).  Names and arguments
are the JAX package's.  Columns made from host values go to `device`:
when the caller passes none, the entries' device
(utils/platform.entry_device(): the card unless initialize() read
SPARK_RAPIDS_TPU_PLATFORM=cpu).  Every op runs on the device of the
columns its handles name.  The op entries open with maybe_inject and an
op_range, through jni_api or the op layer's brackets (ops/__init__),
as the JAX package's do.

flagship_q5_mesh and flagship_q72_mesh run q5 and q72 as mesh programs
over a process group of rank processes that the door starts at first
use and keeps (shim/jni_mesh.py); shutdown() stops them.
"""

from __future__ import annotations

import io
import os
import sys
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.analysis.lockdep import make_lock
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType, Kind
from spark_rapids_tpu_torch.ops import arithmetic as _arith
from spark_rapids_tpu_torch.ops import bloom_filter as _bf
from spark_rapids_tpu_torch.ops import cast_more as _cm
from spark_rapids_tpu_torch.ops import decimal_utils as _du
from spark_rapids_tpu_torch.ops import histogram as _hist
from spark_rapids_tpu_torch.ops import hllpp as _hllpp
from spark_rapids_tpu_torch.ops import iceberg as _ib
from spark_rapids_tpu_torch.ops import protobuf as _pb
from spark_rapids_tpu_torch.ops.case_when import select_first_true_index \
    as _first_true
from spark_rapids_tpu_torch.ops.string_utils import random_uuids as _uuids
from spark_rapids_tpu_torch.ops.substring_index import substring_index \
    as _substring_index
from spark_rapids_tpu_torch.ops import zorder as _zorder
from spark_rapids_tpu_torch.shim import jni_api
from spark_rapids_tpu_torch.shim.errors import (ShimArgumentError,
                                                ShimStateError)
from spark_rapids_tpu_torch.shim.handles import REGISTRY
from spark_rapids_tpu_torch.utils import platform as _platform
from spark_rapids_tpu_torch.utils.fault_injection import maybe_inject
from spark_rapids_tpu_torch.utils.profiler import op_range

_INITIALIZED = False


def initialize() -> None:
    """One-time runtime init inside the embedded interpreter
    (idempotent).  Reads SPARK_RAPIDS_TPU_PLATFORM: ``cpu`` makes the
    CPU the entries' device; empty, ``cuda`` or ``gpu`` the card, and
    then a process without a usable card raises ShimStateError (it
    does not carry on on the CPU).  Any other value raises
    ShimArgumentError.  SPARK_RAPIDS_TPU_CPU_DEVICES (the JAX package's
    virtual CPU device count) sets how many CPU ranks the mesh entries
    may run (default 1); a value that is not an integer raises
    ValueError, one below 1 ShimArgumentError.  On the card the mesh
    entries may run one rank per card."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    platform = os.environ.get("SPARK_RAPIDS_TPU_PLATFORM", "")
    if platform == "cpu":
        device = "cpu"
    elif platform in ("", "cuda", "gpu"):
        device = "cuda"
        if not torch.cuda.is_available():
            raise ShimStateError(
                f"SPARK_RAPIDS_TPU_PLATFORM={platform!r} asks for the "
                f"card, and torch sees no CUDA device")
    else:
        raise ShimArgumentError(
            f"SPARK_RAPIDS_TPU_PLATFORM={platform!r}: expected cpu, "
            f"cuda or gpu (empty: the card)")
    ndev = os.environ.get("SPARK_RAPIDS_TPU_CPU_DEVICES", "")
    if ndev:
        n = int(ndev)              # malformed values must FAIL loudly
        if n < 1:
            raise ShimArgumentError(
                f"SPARK_RAPIDS_TPU_CPU_DEVICES={ndev!r}: at least 1")
        _platform.set_mesh_cpu_ranks(n)
    _platform.set_entry_device(device)
    _INITIALIZED = True


def shutdown() -> None:
    """Stop the query server (only when spark_rapids_tpu_torch.server is
    already loaded: its pool threads hold handles, and shutdown must
    not import the server into a process that never used it) and the
    mesh entries' rank pools (likewise), clear the kudo write memo, the
    handle registry and the host tables, then shut the profiler down
    (stops its flusher, closes file sinks)."""
    from spark_rapids_tpu_torch.utils.profiler import Profiler
    srv = sys.modules.get("spark_rapids_tpu_torch.server")
    if srv is not None:
        try:
            srv.stop_server(timeout_s=5)
        except Exception:
            pass
    mesh = sys.modules.get("spark_rapids_tpu_torch.shim.jni_mesh")
    if mesh is not None:
        mesh.stop_pools()
    with _KUDO_CACHE_LOCK:
        _KUDO_WRITE_CACHE.clear()
    REGISTRY.clear()
    with _HOST_TABLES_LOCK:
        _HOST_TABLES.clear()   # spilled buffers are handles too
    Profiler.shutdown()


def live_handles() -> int:
    return REGISTRY.live_count()


def _device(device):
    return _platform.entry_device() if device is None else device


# ------------------------------------------------------------- columns


def from_longs(values: Sequence[int], device=None) -> int:
    return jni_api.make_column_from_host(list(values), dtypes.INT64,
                                         _device(device))


def from_ints(values: Sequence[int], device=None) -> int:
    return jni_api.make_column_from_host(list(values), dtypes.INT32,
                                         _device(device))


def from_doubles(values: Sequence[float], device=None) -> int:
    return jni_api.make_column_from_host(list(values), dtypes.FLOAT64,
                                         _device(device))


def from_strings(values: Sequence[Optional[str]], device=None) -> int:
    return jni_api.make_column_from_host(list(values), dtypes.STRING,
                                         _device(device))


def from_strings_bulk(chars: bytes, offsets_le: bytes,
                      validity: Optional[bytes], device=None) -> int:
    """Bulk string-column ingest: ONE chars buffer + ONE little-endian
    int32 offsets buffer (+ optional packed LSB-first validity) cross
    the JNI boundary as whole primitive arrays, no per-element boxing
    (reference discipline: HashJni.cpp:31-46 moves handles and
    primitive arrays, never object lists).  One upload a buffer."""
    offs = np.frombuffer(offsets_le, "<i4")
    if len(offs) == 0:
        raise ShimArgumentError(
            "offsets must hold at least one entry (the leading 0)")
    rows = len(offs) - 1
    if offs[0] != 0 or (rows > 0 and (np.diff(offs) < 0).any()):
        raise ShimArgumentError("offsets must start at 0 and be "
                                "non-decreasing")
    if int(offs[-1]) > len(chars):
        raise ShimArgumentError(
            f"last offset {int(offs[-1])} exceeds chars length "
            f"{len(chars)}")
    if validity is not None and len(validity) < (rows + 7) // 8:
        raise ShimArgumentError("validity shorter than ceil(rows/8) bytes")
    return REGISTRY.register(_string_column_from_buffers(
        np.frombuffer(chars, np.uint8), offs, validity, rows,
        _device(device)))


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`: one host-to-device copy of
    a read-only view (the bytes a JNI caller handed over) on the card,
    a private copy of it on the CPU."""
    arr = np.ascontiguousarray(arr)
    if arr.flags.writeable:
        return torch.from_numpy(arr).to(device)
    if torch.device(device).type == "cpu":
        return torch.from_numpy(arr.copy())
    with warnings.catch_warnings():
        # the view is only read: .to() copies it to the card
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr).to(device)


def _unpack_validity(validity: Optional[bytes], rows: int, device):
    if validity is None:
        return None
    bits = np.unpackbits(np.frombuffer(validity, np.uint8),
                         bitorder="little")[:rows]
    return _upload(bits, device)


def _string_column_from_buffers(chars_np, offs_np, validity, rows,
                                device) -> Column:
    """Shared STRING Column assembly from raw host buffers (packed
    LSB-first validity or None): the bulk ingest above and the kudo
    host-table import below."""
    return Column(dtypes.STRING, rows, data=_upload(chars_np, device),
                  validity=_unpack_validity(validity, rows, device),
                  offsets=_upload(offs_np.astype(np.int32, copy=False),
                                  device))


def string_column_chars(handle: int) -> bytes:
    """Bulk readback: the whole UTF-8 chars buffer as one byte[] (one
    device-to-host copy)."""
    col = REGISTRY.get(handle)
    if not col.dtype.is_string:
        raise ShimArgumentError(f"handle {handle} is {col.dtype.kind}, "
                                f"not a STRING column")
    return (b"" if col.data is None
            else col.data.cpu().numpy().tobytes())


def string_column_offsets(handle: int) -> bytes:
    """Bulk readback: the int32 offsets as one little-endian byte[]."""
    col = REGISTRY.get(handle)
    if not col.dtype.is_string:
        raise ShimArgumentError(f"handle {handle} is {col.dtype.kind}, "
                                f"not a STRING column")
    return np.ascontiguousarray(col.offsets.cpu().numpy(),
                                "<i4").tobytes()


def free(handle: int) -> None:
    """Release a column handle (exactly once: a double free raises
    ``ValueError`` from the registry without corrupting the table).
    Release happens FIRST: once it succeeds this caller owns the
    cleanup, and a concurrent ``kudo_write`` can no longer resolve the
    handle, so it cannot re-insert a memo entry for freed columns after
    the purge below."""
    jni_api.release_column(handle)
    _kudo_cache_purge(handle)


def gather(values_handle: int, indices_handle: int) -> int:
    """TpuColumns.gather: take rows of `values` at `indices` (the
    composition primitive GpuExec-shaped plans use between a join's
    index columns and downstream ops)."""
    from spark_rapids_tpu_torch.ops import copying
    vals = REGISTRY.get(values_handle)
    idx = REGISTRY.get(indices_handle)
    return REGISTRY.register(copying.gather(vals, idx.data))


def column_to_host(handle: int):
    return jni_api.column_to_host(handle)


def struct_child(handle: int, index: int) -> int:
    """Child column of a STRUCT/LIST handle (cudf-java
    ColumnView.getChildColumnView shape)."""
    return REGISTRY.register(REGISTRY.get(handle).children[index])


def from_decimals(unscaled: Sequence[int], scale: int, type_id: str,
                  device=None) -> int:
    """Decimal column from UNSCALED int values (cudf-java
    ColumnVector.decimalFromLongs shape; scale follows the cudf
    convention -- negative scale = fraction digits)."""
    return jni_api.make_column_from_host(list(unscaled),
                                         DType(type_id, scale),
                                         _device(device))


# ----------------------------------------------------------------- ops
# (every op entry opens maybe_inject and an op_range: jni_api's exports
# open their own, the op layer brackets the ops of its table
# (ops/__init__._TRACED), and _bracketed the ops outside that table)


def _bracketed(fn, *args):
    """fn(*args) inside maybe_inject and an op_range named after the op,
    for the ops the op layer's table leaves unbracketed."""
    maybe_inject(fn.__name__)
    with op_range(fn.__name__):
        return fn(*args)


def murmur_hash3_32(seed: int, handles: Sequence[int]) -> int:
    return jni_api.murmur_hash3_32(seed, handles)


def xx_hash_64(seed: int, handles: Sequence[int]) -> int:
    return jni_api.xx_hash_64(seed, handles)


def hive_hash(handles: Sequence[int]) -> int:
    return jni_api.hive_hash(handles)


def convert_to_rows(handles: Sequence[int]) -> int:
    """Columns -> JCUDF rows (one LIST<UINT8> handle): the fixed-width
    kernel, or the variable-width one when a column is a STRING, on
    the card (ops/row_assembly_cuda.py)."""
    return jni_api.convert_to_rows(handles)


def convert_from_rows(rows_handle: int, type_ids: Sequence[str],
                      scales: Sequence[int]) -> List[int]:
    """JCUDF rows -> one handle a column of the schema."""
    return jni_api.convert_from_rows(rows_handle, type_ids, scales)


def string_to_integer(handle: int, type_id: str, ansi: bool,
                      strip: bool) -> int:
    return jni_api.string_to_integer(handle, type_id, ansi, strip)


def string_to_float(handle: int, type_id: str, ansi: bool) -> int:
    from spark_rapids_tpu_torch.ops.cast_string import \
        string_to_float as stf
    return REGISTRY.register(
        stf(REGISTRY.get(handle), DType(type_id), ansi))


def float_to_string(handle: int) -> int:
    from spark_rapids_tpu_torch.ops.cast_string import \
        float_to_string as fts
    return REGISTRY.register(fts(REGISTRY.get(handle)))


def get_json_object(handle: int, path: str) -> int:
    return jni_api.get_json_object(handle, path)


def random_uuids(rows: int, seed: int, device=None) -> int:
    return REGISTRY.register(_uuids(rows, seed, _device(device)))


def parse_uri(handle: int, what: str, ansi: bool) -> int:
    """ParseURI.java surface: what in protocol|host|query|path."""
    from spark_rapids_tpu_torch.ops import parse_uri as PU
    fn = {"protocol": PU.parse_uri_to_protocol,
          "host": PU.parse_uri_to_host,
          "query": PU.parse_uri_to_query,
          "path": PU.parse_uri_to_path}[what]
    return REGISTRY.register(_bracketed(fn, REGISTRY.get(handle), ansi))


def parse_uri_query_with_key(handle: int, key: str, ansi: bool) -> int:
    from spark_rapids_tpu_torch.ops import parse_uri as PU
    return REGISTRY.register(_bracketed(PU.parse_uri_to_query_with_key,
                                        REGISTRY.get(handle), key, ansi))


def charset_decode_to_utf8(handle: int, charset: str,
                           on_error: str) -> int:
    from spark_rapids_tpu_torch.ops.strings_misc import decode_to_utf8
    return REGISTRY.register(
        decode_to_utf8(REGISTRY.get(handle), charset, on_error))


def number_converter_convert(handle: int, from_base: int,
                             to_base: int) -> int:
    from spark_rapids_tpu_torch.ops.strings_misc import convert
    return REGISTRY.register(
        convert(REGISTRY.get(handle), from_base, to_base))


def datetime_truncate(handle: int, component: str) -> int:
    from spark_rapids_tpu_torch.ops.datetime_ops import truncate
    return REGISTRY.register(_bracketed(truncate, REGISTRY.get(handle),
                                        component))


def datetime_rebase(handle: int, to_julian: bool) -> int:
    from spark_rapids_tpu_torch.ops import datetime_ops as DT
    fn = (DT.rebase_gregorian_to_julian if to_julian
          else DT.rebase_julian_to_gregorian)
    return REGISTRY.register(_bracketed(fn, REGISTRY.get(handle)))


def sort_merge_inner_join(left_handles: Sequence[int],
                          right_handles: Sequence[int],
                          nulls_equal: bool) -> List[int]:
    return jni_api.sort_merge_inner_join(left_handles, right_handles,
                                         nulls_equal)


def extract_chunk32_from_64bit(handle: int, type_id: str,
                               chunk: int) -> int:
    from spark_rapids_tpu_torch.ops.aggregation64 import \
        extract_chunk32_from_64bit as ec
    return REGISTRY.register(
        ec(REGISTRY.get(handle), DType(type_id), chunk))


def assemble64_from_sum(low_handle: int, high_handle: int,
                        type_id: str) -> List[int]:
    from spark_rapids_tpu_torch.ops.aggregation64 import \
        assemble64_from_sum as asm
    out = asm(REGISTRY.get(low_handle), REGISTRY.get(high_handle),
              DType(type_id))
    return [REGISTRY.register(c) for c in out]


def literal_range_pattern(handle: int, literal: str, range_len: int,
                          start: int, end: int) -> int:
    from spark_rapids_tpu_torch.ops.strings_misc import \
        literal_range_pattern as lrp
    return REGISTRY.register(lrp(REGISTRY.get(handle), literal,
                                 range_len, start, end))


def timezone_convert(handle: int, zone_id: str, to_utc: bool) -> int:
    from spark_rapids_tpu_torch.ops import datetime_ops as DT
    fn = (DT.convert_timestamp_to_utc if to_utc
          else DT.convert_utc_timestamp_to_timezone)
    return REGISTRY.register(_bracketed(fn, REGISTRY.get(handle), zone_id))


def get_json_object_multiple_paths(handle: int, paths: Sequence[str],
                                   mem_budget: int,
                                   parallel_override: int) -> List[int]:
    from spark_rapids_tpu_torch.ops.json_path import \
        get_json_object_multiple_paths as gj
    out = gj(REGISTRY.get(handle), list(paths), mem_budget,
             parallel_override)
    return [REGISTRY.register(c) for c in out]


def map_sort(handle: int, descending: bool) -> int:
    from spark_rapids_tpu_torch.ops.map_utils import sort_map_column
    return REGISTRY.register(_bracketed(sort_map_column,
                                        REGISTRY.get(handle), descending))


def substring_index(handle: int, delim: str, count: int) -> int:
    return REGISTRY.register(_substring_index(REGISTRY.get(handle), delim,
                                              count))


def interleave_bits(handles: Sequence[int]) -> int:
    return REGISTRY.register(_zorder.interleave_bits(
        jni_api._cols(handles)))


def hilbert_index(num_bits: int, handles: Sequence[int]) -> int:
    return REGISTRY.register(_zorder.hilbert_index(
        num_bits, jni_api._cols(handles)))


def select_first_true_index(handles: Sequence[int]) -> int:
    return REGISTRY.register(_first_true(jni_api._cols(handles)))


def bloom_filter_create(num_hashes: int, num_longs: int, version: int,
                        device=None) -> int:
    return REGISTRY.register(_bf.create(num_hashes, num_longs, version,
                                        device=_device(device)))


def bloom_filter_put(bf_handle: int, col_handle: int) -> int:
    return REGISTRY.register(
        _bf.put(REGISTRY.get(bf_handle), REGISTRY.get(col_handle)))


def bloom_filter_probe(bf_handle: int, col_handle: int) -> int:
    return REGISTRY.register(
        _bf.probe(REGISTRY.get(bf_handle), REGISTRY.get(col_handle)))


def bloom_filter_merge(bf_handles: Sequence[int]) -> int:
    return REGISTRY.register(
        _bf.merge([REGISTRY.get(h) for h in bf_handles]))


def bloom_filter_serialize(bf_handle: int) -> bytes:
    return _bf.serialize(REGISTRY.get(bf_handle))


def bloom_filter_deserialize(data: bytes, device=None) -> int:
    return REGISTRY.register(_bf.deserialize(bytes(data),
                                             _device(device)))


def arithmetic_multiply(lhs: int, rhs: int, ansi: bool,
                        try_mode: bool) -> int:
    return REGISTRY.register(_arith.multiply(
        REGISTRY.get(lhs), REGISTRY.get(rhs), ansi, try_mode))


def arithmetic_round(handle: int, decimal_places: int, mode: str) -> int:
    return REGISTRY.register(_arith.round_column(
        REGISTRY.get(handle), decimal_places, method=mode))


def histogram_create(values: int, frequencies: int) -> int:
    return REGISTRY.register(_hist.create_histogram_if_valid(
        REGISTRY.get(values), REGISTRY.get(frequencies)))


def histogram_percentile(histogram: int,
                         percentages: Sequence[float]) -> int:
    return REGISTRY.register(_hist.percentile_from_histogram(
        REGISTRY.get(histogram), list(percentages)))


def cast_strings_to_date(handle: int, ansi: bool) -> int:
    return REGISTRY.register(_cm.parse_strings_to_date(
        REGISTRY.get(handle), ansi))


def long_to_binary_string(handle: int) -> int:
    return REGISTRY.register(_cm.long_to_binary_string(
        REGISTRY.get(handle)))


def format_number(handle: int, digits: int) -> int:
    return REGISTRY.register(_cm.format_number(REGISTRY.get(handle),
                                               digits))


def protobuf_decode_to_struct(handle: int,
                              field_numbers: Sequence[int],
                              type_ids: Sequence[str],
                              encodings: Sequence[int],
                              required: Sequence[bool]) -> int:
    """Protobuf.java surface over the decoder's router (ops/protobuf.py;
    ProtobufSchemaDescriptor's parallel vectors collapse to these arrays
    for flat messages)."""
    fields = [_pb.Field(n, DType(t), enc, False, bool(req))
              for n, t, enc, req in zip(field_numbers, type_ids,
                                        encodings, required)]
    return REGISTRY.register(
        _pb.decode_protobuf_to_struct(REGISTRY.get(handle), fields))


def iceberg_bucket(handle: int, num_buckets: int) -> int:
    return REGISTRY.register(_ib.bucket(REGISTRY.get(handle), num_buckets))


def iceberg_truncate(handle: int, width: int) -> int:
    return REGISTRY.register(_ib.truncate(REGISTRY.get(handle), width))


def iceberg_datetime(handle: int, component: str) -> int:
    table = {"year": _ib.year, "month": _ib.month, "day": _ib.day,
             "hour": _ib.hour}
    if component not in table:
        raise ShimArgumentError(f"unsupported component {component!r}: "
                                f"expected year|month|day|hour")
    return REGISTRY.register(table[component](REGISTRY.get(handle)))


def hllpp_reduce(handle: int, precision: int) -> int:
    """HLL++ sketch of a whole column (reduce path,
    hyper_log_log_plus_plus.hpp reduce_hyper_log_log_plus_plus)."""
    return REGISTRY.register(_hllpp.reduce_hllpp(REGISTRY.get(handle),
                                                 precision))


def hllpp_estimate(handle: int, precision: int) -> int:
    return REGISTRY.register(_hllpp.estimate_from_hll_sketches(
        REGISTRY.get(handle), precision))


def arrow_ingest(batch, device=None) -> List[int]:
    """Zero-copy Arrow ingest door (embedded-interpreter twin of
    jni_api.arrow_ingest): the JVM hands over a PyCapsule-protocol
    object (``__arrow_c_array__``) or a pyarrow RecordBatch it built
    through its own Arrow FFI; on the CPU the buffers are wrapped, on
    the card each is uploaded once."""
    return jni_api.arrow_ingest(batch, _device(device))


def parquet_read_table(path: str, columns: Sequence[str] = (),
                       case_sensitive: bool = True,
                       device=None) -> List[int]:
    """File->columns door: columnar parquet read with projection
    pushdown; an empty ``columns`` list reads every column."""
    return jni_api.parquet_read_table(
        str(path), columns=list(columns) or None,
        case_sensitive=bool(case_sensitive), device=_device(device))


def parquet_footer_read_and_filter(data: bytes,
                                   keep_names: Sequence[str],
                                   case_sensitive: bool) -> bytes:
    """ParquetFooter.readAndFilter (ParquetFooter.java:225): parse the
    thrift footer, prune to the requested columns, re-serialize."""
    from spark_rapids_tpu_torch.io import parquet_footer as PF
    tree = PF.parse_footer(bytes(data))
    pruned = PF.prune_columns(tree, list(keep_names),
                              case_sensitive=case_sensitive)
    return PF.serialize_footer(pruned)


def version_is_vanilla_320(platform: int, major: int, minor: int,
                           patch: int) -> bool:
    return _platform.SparkSystem(platform, major, minor,
                                 patch).is_vanilla_320()


def registry_add_thread(native_id: int) -> None:
    from spark_rapids_tpu_torch.memory.thread_state_registry import \
        REGISTRY as THREADS
    THREADS.add_thread(native_id)


def registry_remove_thread(native_id: int) -> None:
    from spark_rapids_tpu_torch.memory.thread_state_registry import \
        REGISTRY as THREADS
    THREADS.remove_thread(native_id)


def registry_known_threads() -> List[int]:
    from spark_rapids_tpu_torch.memory.thread_state_registry import \
        REGISTRY as THREADS
    return THREADS.known_threads()


def task_priority_get(attempt_id: int) -> int:
    from spark_rapids_tpu_torch.memory import task_priority
    return task_priority.get_task_priority(attempt_id)


def task_priority_done(attempt_id: int) -> None:
    from spark_rapids_tpu_torch.memory import task_priority
    task_priority.task_done(attempt_id)


def decimal128_binop(op: str, a: int, b: int, out_scale: int) -> List[int]:
    """DecimalUtils surface: returns (overflow BOOL8, result) handles
    (the decimal_utils.hpp:2-33 (flag, column) table shape)."""
    fn = {"multiply": _du.multiply_decimal128,
          "divide": _du.divide_decimal128,
          "add": _du.add_decimal128,
          "sub": _du.sub_decimal128}[op]
    ovf, res = fn(REGISTRY.get(a), REGISTRY.get(b), out_scale)
    return [REGISTRY.register(ovf), REGISTRY.register(res)]


def device_attr_is_integrated() -> bool:
    """DeviceAttr.isIntegratedGPU for the entries' device
    (utils/platform.is_integrated_gpu: false on an H100)."""
    return _platform.is_integrated_gpu()


# ---------------------------------------------------------- Profiler


def profiler_init(output_path: str, flush_period_millis: int,
                  alloc_capture: bool) -> None:
    """Profiler.init with a file sink (the reference's DataWriter
    callback shape delivered to a path instead of a JVM method —
    Profiler.java:36-120, profiler_serializer.hpp:30-65).  'wb': a
    profile file holds ONE process's records (t_ns is per-process
    monotonic; appended runs would interleave in the converter)."""
    from spark_rapids_tpu_torch.utils.profiler import Config, Profiler
    f = open(output_path, "wb")

    def writer(blob: bytes):
        f.write(blob)
        f.flush()

    cfg = Config(flush_period_millis=flush_period_millis,
                 alloc_capture=alloc_capture)
    try:
        prof = Profiler.init(writer, cfg)
    except Exception:
        f.close()          # double-init must not leak the descriptor
        raise
    prof.sink_close = f.close  # Profiler.shutdown closes every path


def profiler_start() -> None:
    from spark_rapids_tpu_torch.utils.profiler import Profiler
    inst = Profiler.get()
    if inst is not None:
        inst.start()


def profiler_stop() -> None:
    from spark_rapids_tpu_torch.utils.profiler import Profiler
    inst = Profiler.get()
    if inst is not None:
        inst.stop()


def profiler_shutdown() -> None:
    from spark_rapids_tpu_torch.utils.profiler import Profiler
    Profiler.shutdown()


# ------------------------------------------------------- observability
# (primitive-only twins of jni_api's metrics entries: the JVM pulls the
# registry as a Prometheus text blob or a JSON string and dumps the
# journal to a path it owns)


def metrics_set_enabled(enabled: bool) -> bool:
    return jni_api.metrics_set_enabled(bool(enabled))


def metrics_enabled() -> bool:
    return jni_api.metrics_enabled()


def metrics_expose_text() -> str:
    return jni_api.metrics_expose_text()


def metrics_snapshot_json() -> str:
    return jni_api.metrics_snapshot_json()


def metrics_journal_dump(path: str) -> int:
    return jni_api.metrics_journal_dump(path)


def metrics_reset() -> None:
    jni_api.metrics_reset()


def tracing_set_enabled(enabled: bool) -> bool:
    return jni_api.tracing_set_enabled(bool(enabled))


def tracing_enabled() -> bool:
    return jni_api.tracing_enabled()


def tracing_dump(path: str) -> int:
    return jni_api.tracing_dump(path)


def tracing_flush(path: str) -> int:
    return jni_api.tracing_flush(path)


def tracing_reset() -> None:
    jni_api.tracing_reset()


# ------------------------------------------- profiles, incidents, caches
# (primitive-only twins of jni_api's query-profile, flight-recorder,
# telemetry-plane, attribution, compile-cache, result-cache and
# data-statistics entries)


def profile_set_enabled(enabled: bool) -> bool:
    return jni_api.profile_set_enabled(bool(enabled))


def profile_enabled() -> bool:
    return jni_api.profile_enabled()


def profile_last_json() -> str:
    return jni_api.profile_last_json()


def server_profile_json(query_id: str) -> str:
    return jni_api.server_profile_json(str(query_id))


def flight_recorder_set_enabled(enabled: bool) -> bool:
    return jni_api.flight_recorder_set_enabled(bool(enabled))


def flight_recorder_enabled() -> bool:
    return jni_api.flight_recorder_enabled()


def flight_recorder_configure(out_dir: str = "", max_bytes: int = 0,
                              min_interval_s: float = -1.0) -> None:
    jni_api.flight_recorder_configure(str(out_dir), int(max_bytes),
                                      float(min_interval_s))


def incident_dump(reason: str = "manual") -> str:
    return jni_api.incident_dump(str(reason))


def incident_list() -> str:
    return jni_api.incident_list()


def health_json() -> str:
    return jni_api.health_json()


def timeseries_set_enabled(enabled: bool) -> bool:
    return jni_api.timeseries_set_enabled(bool(enabled))


def timeseries_enabled() -> bool:
    return jni_api.timeseries_enabled()


def timeseries_snapshot_json() -> str:
    return jni_api.timeseries_snapshot_json()


def slo_set_enabled(enabled: bool) -> bool:
    return jni_api.slo_set_enabled(bool(enabled))


def slo_enabled() -> bool:
    return jni_api.slo_enabled()


def slo_status_json() -> str:
    return jni_api.slo_status_json()


def slo_evaluate_json() -> str:
    return jni_api.slo_evaluate_json()


def attribution_set_enabled(enabled: bool) -> bool:
    return jni_api.attribution_set_enabled(bool(enabled))


def attribution_enabled() -> bool:
    return jni_api.attribution_enabled()


def attribution_last_json() -> str:
    return jni_api.attribution_last_json()


def fault_injection_install(config_path: str = "", watch: bool = True,
                            interval_ms: int = 0) -> int:
    return jni_api.fault_injection_install(str(config_path),
                                           bool(watch),
                                           int(interval_ms))


def fault_injection_uninstall() -> None:
    jni_api.fault_injection_uninstall()


def fault_injection_config_path() -> str:
    return jni_api.fault_injection_config_path()


def fault_injection_rules_json() -> str:
    return jni_api.fault_injection_rules_json()


def jit_cache_stats() -> str:
    return jni_api.jit_cache_stats()


def jit_cache_clear(reset_stats: bool = False) -> int:
    return jni_api.jit_cache_clear(bool(reset_stats))


def result_cache_stats() -> str:
    return jni_api.result_cache_stats()


def result_cache_clear(reset_stats: bool = False) -> int:
    return jni_api.result_cache_clear(bool(reset_stats))


def result_cache_bump_epoch(source: str) -> int:
    return jni_api.result_cache_bump_epoch(str(source))


def stats_set_enabled(enabled: bool) -> bool:
    return jni_api.stats_set_enabled(bool(enabled))


def stats_enabled() -> bool:
    return jni_api.stats_enabled()


def stats_snapshot_json() -> str:
    return jni_api.stats_snapshot_json()


def stats_store_clear() -> None:
    return jni_api.stats_store_clear()


def kudo_set_crc_enabled(enabled: bool) -> bool:
    return jni_api.kudo_set_crc_enabled(bool(enabled))


def kudo_crc_enabled() -> bool:
    return jni_api.kudo_crc_enabled()


# --------------------------------------------------------- query server
# (primitive-only twins of jni_api's server entries)


def server_start(max_concurrency: int = 0, max_queue: int = 0,
                 socket_path: str = "") -> bool:
    return jni_api.server_start(int(max_concurrency), int(max_queue),
                                str(socket_path))


def server_stop() -> None:
    jni_api.server_stop()


def server_set_tenant_quota(tenant: str, max_inflight: int = -1,
                            max_device_bytes: int = -1,
                            weight: float = -1.0) -> None:
    jni_api.server_set_tenant_quota(str(tenant), int(max_inflight),
                                    int(max_device_bytes),
                                    float(weight))


def server_submit(tenant: str, query: str,
                  params_json: str = "",
                  deadline_s: float = -1.0) -> str:
    return jni_api.server_submit(str(tenant), str(query),
                                 str(params_json), float(deadline_s))


def server_poll(query_id: str, timeout_s: float = -1.0) -> str:
    return jni_api.server_poll(str(query_id), float(timeout_s))


def server_cancel(query_id: str) -> bool:
    return jni_api.server_cancel(str(query_id))


def server_stats_json() -> str:
    return jni_api.server_stats_json()


def server_drain(deadline_s: float = -1.0, flush_dir: str = "") -> str:
    return jni_api.server_drain(float(deadline_s), str(flush_dir))


# --------------------------------------------------------- HostTable
# (spilled buffers are handles too: same lock-protected allocate/free
# discipline as the column registry, so concurrent query-server callers
# can neither race the id counter nor double-free an entry)


_HOST_TABLES: dict = {}
_HOST_TABLE_NEXT = [1]
_HOST_TABLES_LOCK = make_lock("shim.host_tables")


def _host_table_get(handle: int):
    with _HOST_TABLES_LOCK:
        try:
            return _HOST_TABLES[handle]
        except KeyError:
            raise ShimArgumentError(
                f"invalid or released host-table handle {handle}")


def host_table_from_table(handles: Sequence[int]) -> int:
    """HostTable.fromTableAsync (HostTable.java:46): copy a device
    table into one contiguous host buffer; returns a host-table
    handle."""
    from spark_rapids_tpu_torch.columns.table import Table
    from spark_rapids_tpu_torch.memory.host_table import HostTable
    ht = HostTable.from_table(Table(jni_api._cols(handles)))
    with _HOST_TABLES_LOCK:
        h = _HOST_TABLE_NEXT[0]
        _HOST_TABLE_NEXT[0] += 1
        _HOST_TABLES[h] = ht
    return h


def host_table_size_bytes(handle: int) -> int:
    return _host_table_get(handle).size_bytes


def host_table_to_device(handle: int) -> List[int]:
    """HostTable.toDeviceColumnViews: upload back to the device the
    table came from; returns column handles."""
    table = _host_table_get(handle).to_table()
    return [REGISTRY.register(c) for c in table.columns]


def host_table_free(handle: int) -> None:
    """Free exactly once; a double free raises cleanly like the
    column registry's (HandleRegistry.release contract)."""
    with _HOST_TABLES_LOCK:
        if _HOST_TABLES.pop(handle, None) is None:
            raise ShimArgumentError(
                f"double free or invalid host-table handle {handle}")


# ----------------------------------------------------- kudo over JNI


# per-handle-tuple memo for the write path: partition loops call
# kudo_write repeatedly on the SAME handles, and one export of the
# table's host buffers serves them all.  Entries are PURGED when any of
# their handles is released (free() above) and on shutdown: the memo
# never outlives the columns' ownership.  All access is under
# _KUDO_CACHE_LOCK, and an insert re-validates that every handle is
# still live, so a free() racing a kudo_write can never park an export
# of already-released columns in the memo (free releases FIRST, so the
# liveness check is authoritative).
_KUDO_WRITE_CACHE: dict = {}
_KUDO_WRITE_CACHE_MAX = 4
_KUDO_CACHE_LOCK = make_lock("shim.kudo_cache")


def _kudo_cache_purge(handle: int) -> None:
    with _KUDO_CACHE_LOCK:
        for key in [k for k in _KUDO_WRITE_CACHE if handle in k]:
            del _KUDO_WRITE_CACHE[key]


def kudo_write(handles: Sequence[int], row_offset: int,
               num_rows: int) -> bytes:
    """KudoSerializer.writeToStreamWithMetrics: serialize a row slice
    of a table to one kudo block (bytes cross the JNI boundary as
    jbyteArray).  Routes through the byte-identical C++ engine when it
    is available (the GIL releases for the duration of the native
    write), the table's host buffers exported once a handle tuple
    (memoized); the Python spec engine otherwise, and always with CRC
    on (KCRC trailers are a spec-engine feature)."""
    from spark_rapids_tpu_torch.shuffle import kudo, kudo_native
    cols = jni_api._cols(handles)
    if kudo_native.available() and not kudo.crc_enabled():
        key = tuple(handles)
        with _KUDO_CACHE_LOCK:
            nt = _KUDO_WRITE_CACHE.get(key)
        if nt is None:
            nt = kudo_native.table_from_columns(cols)
            with _KUDO_CACHE_LOCK:
                # memoize only while every handle is still live: a
                # concurrent free() has already purged this key and
                # must not have a stale export re-inserted behind it
                if all(REGISTRY.is_live(h) for h in key):
                    _KUDO_WRITE_CACHE[key] = nt
                    while len(_KUDO_WRITE_CACHE) > \
                            _KUDO_WRITE_CACHE_MAX:
                        del _KUDO_WRITE_CACHE[
                            next(iter(_KUDO_WRITE_CACHE))]
        return nt.write(row_offset, num_rows)
    out = io.BytesIO()
    kudo.write_to_stream(cols, out, row_offset, num_rows)
    return out.getvalue()


def export_kudo_host(handles: Sequence[int]) -> list:
    """ONE-crossing export of a table's host buffers for the pure-C++
    kudo engine (native/kudo_native.hpp): after this, every partition
    write or merge runs without the GIL (the reference's kudo hot path
    is pure JVM, kudo/KudoSerializer.java).  Each buffer is read to the
    host once.

    Returns the flat list
      [num_rows, n_flat,
       then 8 entries per flat column (depth-first pre-order):
       kudo_kind:int, item_size:int, num_children:int,
       type_id:str, scale:int,
       data:bytes|None, validity:bytes|None, offsets:bytes|None]
    """
    from spark_rapids_tpu_torch.shuffle.kudo import prepare_host_columns
    cols = jni_api._cols(handles)
    views = prepare_host_columns(cols)
    out: list = [int(cols[0].length) if cols else 0, 0]

    def rec(v):
        out[1] += 1
        kind = v.dtype.kind
        if kind == Kind.STRING:
            kkind, item = 1, 0
        elif kind == Kind.LIST:
            kkind, item = 2, 0
        elif kind == Kind.STRUCT:
            kkind, item = 3, 0
        else:
            kkind = 0
            item = 16 if kind == Kind.DECIMAL128 else v.dtype.size_bytes
        out.extend([
            kkind, item, len(v.children) if kkind != 1 else 0,
            str(v.dtype.kind), int(getattr(v.dtype, "scale", 0) or 0),
            None if v.data is None or kkind in (2, 3)
            else np.ascontiguousarray(v.data).tobytes(),
            None if v.validity is None else v.validity.tobytes(),
            None if v.offsets is None
            else np.ascontiguousarray(v.offsets, "<i4").tobytes(),
        ])
        for ch in v.children:
            rec(ch)

    for v in views:
        rec(v)
    return out


def columns_from_kudo_host(num_rows: int, flat: Sequence,
                           device=None) -> List[int]:
    """Inverse of export_kudo_host: rebuild Columns on `device` from
    the C++ engine's merged host buffers (one crossing on the merge
    side, one upload a buffer) and register them, returning root-column
    handles."""
    device = _device(device)
    flat = list(flat)
    pos = [0]

    def read_col(rows: int) -> Column:
        (kkind, item, nch, type_id, scale, data, validity,
         offsets) = flat[pos[0]: pos[0] + 8]
        pos[0] += 8
        dtype = DType(type_id, scale)
        if kkind == 1:  # string: shared buffer->Column assembly
            offs = np.frombuffer(offsets, "<i4") if offsets \
                is not None else np.zeros(rows + 1, np.int32)
            return _string_column_from_buffers(
                np.frombuffer(data or b"", np.uint8), offs, validity,
                rows, device)
        mask = _unpack_validity(validity, rows, device)
        if kkind == 2:  # list
            offs = np.frombuffer(offsets, "<i4").copy() if offsets \
                is not None else np.zeros(rows + 1, np.int32)
            child = read_col(int(offs[-1]) if len(offs) else 0)
            return Column(dtype, rows, validity=mask,
                          offsets=_upload(offs, device), children=(child,))
        if kkind == 3:  # struct
            children = tuple(read_col(rows) for _ in range(nch))
            return Column(dtype, rows, validity=mask, children=children)
        raw = data or b""
        if dtype.kind == Kind.DECIMAL128:
            arr = np.frombuffer(raw, "<i4").reshape(rows, 4)
        else:
            arr = np.frombuffer(raw, dtype.np_dtype)
        return Column(dtype, rows, data=_upload(arr, device), validity=mask)

    roots = []
    while pos[0] < len(flat):
        roots.append(read_col(int(num_rows)))
    return [REGISTRY.register(c) for c in roots]


def kudo_merge(blob: bytes, type_ids: Sequence[str],
               scales: Sequence[int], device=None) -> List[int]:
    """KudoSerializer.mergeToTable over a concatenated stream of kudo
    blocks (flat schemas; the Python API handles nested), the merged
    table's columns on `device`.  Routes through the C++ engine when
    it is available (GIL released for the native merge); the Python
    spec engine otherwise, with CRC on, and whenever the stream itself
    carries KCRC trailers (a peer may have written them whatever the
    local setting; the check walks the records, so payload bytes that
    spell "KCRC" cannot misroute it)."""
    from spark_rapids_tpu_torch.shuffle import kudo, kudo_native
    from spark_rapids_tpu_torch.shuffle.schema import Field
    device = _device(device)
    fields = [Field(DType(k, s)) for k, s in zip(type_ids, scales)]
    blob = bytes(blob)
    if kudo_native.available() and not kudo.crc_enabled() \
            and not kudo.stream_has_crc_trailers(blob):
        table = kudo_native.merge_to_table(blob, fields, device)
        return [REGISTRY.register(c) for c in table.columns]
    kts = kudo.read_tables(io.BytesIO(blob))
    table = kudo.merge_to_table(kts, fields, device)
    return [REGISTRY.register(c) for c in table.columns]


def flagship_q5_mesh(n_devices: int, rows: int,
                     stores: int) -> List[int]:
    """Run the q5-shape flagship as ONE SPMD program over an n-rank
    process group and return the live group rows flattened as
    [store_id, sales, returns, profit, ...]: the multi-rank path driven
    end to end from the JVM.  Raises ShimStateError when fewer ranks
    are allowed than requested (platform.mesh_ranks_allowed): a silent
    single-device run would fake the distribution being proven.  The
    ranks are processes the door keeps (shim/jni_mesh.py)."""
    from spark_rapids_tpu_torch.shim import jni_mesh
    return jni_mesh.run_entry(int(n_devices), jni_mesh.q5_rank,
                              int(rows), int(stores))


def flagship_q72_mesh(n_devices: int, cs_rows: int,
                      items: int) -> List[int]:
    """q72-shape (fact-fact join chain) over an n-rank process group
    from the JVM; returns live (item, week, count) triples flattened."""
    from spark_rapids_tpu_torch.shim import jni_mesh
    return jni_mesh.run_entry(int(n_devices), jni_mesh.q72_rank,
                              int(cs_rows), int(items))


# ---------------------------------------------------------- RmmSpark


def rmm_set_event_handler(limit_bytes: int) -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.set_event_handler(limit_bytes)


def rmm_clear_event_handler() -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.clear_event_handler()


def rmm_start_dedicated_task_thread(thread_id: int, task_id: int) -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.start_dedicated_task_thread(thread_id, task_id)


def rmm_task_done(task_id: int) -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.task_done(task_id)


def rmm_force_retry_oom(thread_id: int, num_ooms: int) -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.force_retry_oom(thread_id, num_ooms)


def rmm_get_state_of(thread_id: int) -> str:
    from spark_rapids_tpu_torch.memory import rmm_spark
    return rmm_spark.get_state_of(thread_id)


def rmm_current_thread_id() -> int:
    """The calling JVM thread's runtime-side id (stable per OS thread:
    PyGILState attaches the same interpreter thread state)."""
    from spark_rapids_tpu_torch.memory import rmm_spark
    return rmm_spark.current_thread_id()


def rmm_register_current_thread(task_id: int) -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.current_thread_is_dedicated_to_task(task_id)


def rmm_force_split_and_retry_oom(thread_id: int, num_ooms: int) -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.force_split_and_retry_oom(thread_id, num_ooms)


def rmm_block_thread_until_ready() -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.block_thread_until_ready()


def rmm_alloc(nbytes: int) -> None:
    """Device-allocation notification for the calling thread; forced
    OOMs (forceRetryOOM / forceSplitAndRetryOOM) fire here and cross
    JNI as the matching typed Java exceptions."""
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.get_adaptor().allocate(nbytes)


def rmm_dealloc(nbytes: int) -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.get_adaptor().deallocate(nbytes)


def rmm_shuffle_thread_working_on_tasks(task_ids: Sequence[int]
                                        ) -> None:
    """RmmSpark.shuffleThreadWorkingOnTasks for the calling JVM
    thread (pool/shuffle thread registration: shuffle threads take
    priority in the BUFN victim selection)."""
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.shuffle_thread_working_on_tasks(
        [int(t) for t in task_ids])


def rmm_pool_thread_finished_for_tasks(task_ids: Sequence[int]
                                       ) -> None:
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.pool_thread_finished_for_tasks(
        rmm_spark.current_thread_id(), [int(t) for t in task_ids])


# ------------------------------------------- list/map utils over JNI


def list_slice(handle: int, start, length, start_is_col: bool,
               length_is_col: bool, check: bool) -> int:
    """GpuListSliceUtils.listSlice (4 scalar/column overloads folded
    into one entry: *_is_col picks handle vs scalar operands)."""
    from spark_rapids_tpu_torch.ops.strings_misc import list_slice as LS
    col = REGISTRY.get(handle)
    s = REGISTRY.get(int(start)) if start_is_col else int(start)
    ln = REGISTRY.get(int(length)) if length_is_col else (
        None if length is None else int(length))
    return REGISTRY.register(LS(col, s, ln, bool(check)))


def map_is_valid(handle: int, throw_on_null_key: bool) -> bool:
    from spark_rapids_tpu_torch.ops.map_utils import is_valid_map
    return bool(_bracketed(is_valid_map, REGISTRY.get(handle),
                           bool(throw_on_null_key)))


def map_from_entries_jni(handle: int, throw_on_null_key: bool) -> int:
    from spark_rapids_tpu_torch.ops.map_utils import map_from_entries
    return REGISTRY.register(_bracketed(
        map_from_entries, REGISTRY.get(handle), bool(throw_on_null_key)))


def map_zip_jni(h1: int, h2: int) -> int:
    from spark_rapids_tpu_torch.ops.map_utils import map_zip_full
    return REGISTRY.register(_bracketed(map_zip_full, REGISTRY.get(h1),
                                        REGISTRY.get(h2)))


# --------------------------------------- ORC timezone info over JNI


def orc_timezone_packed(zone_id: str) -> List[int]:
    """OrcDstRuleExtractor packing: [rawOffsetMillis, hasDst, n,
    transitions_ms.., offsets_ms..]."""
    from spark_rapids_tpu_torch.ops.orc_timezones import (
        get_orc_timezone_info, has_daylight_saving_time)
    info = get_orc_timezone_info(zone_id)
    trans = ([] if info.transitions is None
             else [int(x) for x in info.transitions])
    offs = ([] if info.offsets is None
            else [int(x) for x in info.offsets])
    has_dst = 1 if has_daylight_saving_time(zone_id) else 0
    return ([int(info.raw_offset), has_dst, len(trans)]
            + trans + offs)


def all_timezone_ids() -> List[str]:
    from spark_rapids_tpu_torch.utils.tzdb import TZDIR
    base = TZDIR   # honors $TZDIR like every other zone lookup
    out = []
    for root, _dirs, names in os.walk(base):
        for n in names:
            p = os.path.relpath(os.path.join(root, n), base)
            if "/" in p or p[0].isupper():
                if not p.endswith(".tab") and "posix" not in p \
                        and "right" not in p:
                    out.append(p)
    return sorted(set(out))


# ----------------------------------------- device telemetry over JNI
# (``device``: None = the entries' device, the one ``initialize`` chose;
# "cpu" = the host's one device)


def telemetry_device_count(device=None) -> int:
    from spark_rapids_tpu_torch.utils import telemetry
    return telemetry.get_device_count(_device(device))


def telemetry_snapshot_packed(index: int, device=None) -> List[int]:
    """NVML.getSnapshotPacked: [memTotal, memUsed, memFree, util%,
    powerW, clockMhz, tempC]; -1 = metric not supported here."""
    from spark_rapids_tpu_torch.utils import telemetry
    device = _device(device)
    out = [-1] * 7
    try:
        mem = telemetry.get_memory_info(index, device)
        out[0] = int(mem.get("total", -1))
        out[1] = int(mem.get("used", -1))
        out[2] = int(mem.get("free", -1))
    except Exception:
        pass
    try:
        # utilization is a [0,1] fraction; the packed slot is percent
        out[3] = int(telemetry.get_device_utilization(index, device)
                     * 100)
    except Exception:
        pass
    for slot, fn in ((4, telemetry.get_power_usage_watts),
                     (5, telemetry.get_clock_mhz)):
        try:
            out[slot] = int(fn(index, device))
        except Exception:
            pass
    return out


def telemetry_device_name(index: int, device=None) -> str:
    from spark_rapids_tpu_torch.utils import telemetry
    info = telemetry.get_device_info(index, _device(device))
    return f"{info.platform}:{info.kind}"


# ------------------------------------------------------- test support
# (comparison happens Python-side so the emitted JVM test bytecode can
# stay straight-line: a native assert throws on failure)


def make_list_of_ints(offsets: Sequence[int], values: Sequence[int],
                      device=None) -> int:
    """Test helper: LIST<INT64> column from offsets + flat values
    (drives the GpuListSliceUtils smoke: the JVM has no list builder of
    its own)."""
    device = _device(device)
    child = Column.from_pylist(list(values), dtypes.INT64, device)
    return REGISTRY.register(Column.make_list(
        np.asarray(list(offsets), np.int32), child))


def make_map_column(offsets: Sequence[int], keys: Sequence[str],
                    values: Sequence[str], device=None) -> int:
    """Test helper: MAP-shaped LIST<STRUCT<key,value>> column (drives
    the MapUtils / GpuMapZipWithUtils smoke)."""
    device = _device(device)
    n = len(keys)
    entry = Column.make_struct(n, [Column.from_strings(list(keys), device),
                                   Column.from_strings(list(values),
                                                       device)])
    return REGISTRY.register(Column.make_list(
        np.asarray(list(offsets), np.int32), entry, device=device))


def check_int_column(handle: int, expected: Sequence[int]) -> int:
    got = REGISTRY.get(handle).to_pylist()
    return 1 if got == list(expected) else 0


def check_long_column(handle: int, expected: Sequence[int]) -> int:
    return check_int_column(handle, expected)


def check_string_column(handle: int, expected: Sequence[str]) -> int:
    got = REGISTRY.get(handle).to_pylist()
    return 1 if got == list(expected) else 0


def check_columns_equal(h1: int, h2: int) -> int:
    a = REGISTRY.get(h1).to_pylist()
    b = REGISTRY.get(h2).to_pylist()
    return 1 if a == b else 0


def describe_column(handle: int) -> str:
    col = REGISTRY.get(handle)
    return f"{col.dtype.kind}[{col.length}]"
