"""Embedded-interpreter entry points for the JNI shim, the op half
(native/jni/spark_rapids_tpu_jni.cpp calls these by name).

Every function here takes and returns only primitives, strings, bytes
and flat lists of them: the shapes a hand-written JNI layer can marshal
without any Python C-API object gymnastics.  This is the
process-boundary twin of shim/jni_api.py: jni_api mirrors the
reference's *Jni.cpp export signatures (unwrap jlong handles -> op ->
wrap), and this module adapts those to the embedded-CPython calling
convention (reference: src/main/cpp/src/hash/HashJni.cpp:31-46 unwraps
jlongs the same way before calling the native op).  Names and arguments
are the JAX package's; columns made from host values go to `device`,
"cuda" unless the caller asks for the CPU, and every op runs on the
device of the columns its handles name.

The observability entries (``metrics_*``, ``tracing_*``, ``profile_*``,
``flight_recorder_*``, ``incident_*``, ``health_json``,
``timeseries_*``, ``slo_*``, ``attribution_*``, ``jit_cache_*``,
``result_cache_*``, ``stats_*``), device telemetry (``telemetry_*``),
the op layer's sidecars (``profiler_*``, ``fault_injection_*``) and the
query server's entries (``server_*``) are here.
ROADMAP step 6 (A16's rest) brings the remainder of the JAX module to
this one: initialize/shutdown (which configured JAX there), the bulk
string ingest and readback, the kudo write memo that `free` purges and
the host tables (guarded there by the lockdep locks
``shim.kudo_cache`` and ``shim.host_tables``, which come with them),
and the entries of the ops
that earlier slices ported into jni_api (hashes, row conversion, the
string casts, parse_url, JSON, joins, datetime, ingest).  The
comments below mark where each group goes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.dtypes import DType
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
from spark_rapids_tpu_torch.shim.errors import ShimArgumentError
from spark_rapids_tpu_torch.shim.handles import REGISTRY

# ROADMAP step 6: initialize() and shutdown() go here.  shutdown() stops
# the query server first (server.stop_server, only when the server
# package is already loaded: its pool threads hold handles), then
# clears the kudo memo and the host tables and shuts the profiler down.


def live_handles() -> int:
    return REGISTRY.live_count()


# ------------------------------------------------------------- columns


def from_longs(values: Sequence[int], device="cuda") -> int:
    return jni_api.make_column_from_host(list(values), dtypes.INT64,
                                         device)


def from_ints(values: Sequence[int], device="cuda") -> int:
    return jni_api.make_column_from_host(list(values), dtypes.INT32,
                                         device)


def from_doubles(values: Sequence[float], device="cuda") -> int:
    return jni_api.make_column_from_host(list(values), dtypes.FLOAT64,
                                         device)


def from_strings(values: Sequence[Optional[str]], device="cuda") -> int:
    return jni_api.make_column_from_host(list(values), dtypes.STRING,
                                         device)


# ROADMAP step 6: from_strings_bulk, string_column_chars and
# string_column_offsets (whole-buffer string ingest and readback) go
# here.


def free(handle: int) -> None:
    """Release a column handle (exactly once: a double free raises
    ``ValueError`` from the registry without corrupting the table)."""
    jni_api.release_column(handle)
    # ROADMAP step 6: the JAX package purges the handle's kudo write
    # memo entries here, after the release


# ROADMAP step 6: gather (copying.gather over two handles) goes here.


def column_to_host(handle: int):
    return jni_api.column_to_host(handle)


def struct_child(handle: int, index: int) -> int:
    """Child column of a STRUCT/LIST handle (cudf-java
    ColumnView.getChildColumnView shape)."""
    return REGISTRY.register(REGISTRY.get(handle).children[index])


def from_decimals(unscaled: Sequence[int], scale: int, type_id: str,
                  device="cuda") -> int:
    """Decimal column from UNSCALED int values (cudf-java
    ColumnVector.decimalFromLongs shape; scale follows the cudf
    convention -- negative scale = fraction digits)."""
    return jni_api.make_column_from_host(list(unscaled),
                                         DType(type_id, scale), device)


# ----------------------------------------------------------------- ops
# ROADMAP step 6: the entries of the ops earlier slices put in jni_api
# (murmur_hash3_32, xx_hash_64, hive_hash, convert_to_rows,
# convert_from_rows, string_to_integer, string_to_float,
# float_to_string, get_json_object, parse_uri,
# parse_uri_query_with_key, charset_decode_to_utf8,
# number_converter_convert, datetime_truncate, datetime_rebase,
# sort_merge_inner_join, extract_chunk32_from_64bit,
# assemble64_from_sum, literal_range_pattern, timezone_convert,
# get_json_object_multiple_paths, map_sort) go beside these.  ROADMAP
# step 6: the JAX package's op layer opens each with maybe_inject and an
# op_range.


def random_uuids(rows: int, seed: int, device="cuda") -> int:
    return REGISTRY.register(_uuids(rows, seed, device))


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
                        device="cuda") -> int:
    return REGISTRY.register(_bf.create(num_hashes, num_longs, version,
                                        device=device))


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


def bloom_filter_deserialize(data: bytes, device="cuda") -> int:
    return REGISTRY.register(_bf.deserialize(bytes(data), device))


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


# ROADMAP step 6: arrow_ingest, parquet_read_table,
# parquet_footer_read_and_filter, version_is_vanilla_320, the thread
# registry and task priority entries go here.


def decimal128_binop(op: str, a: int, b: int, out_scale: int) -> List[int]:
    """DecimalUtils surface: returns (overflow BOOL8, result) handles
    (the decimal_utils.hpp:2-33 (flag, column) table shape)."""
    fn = {"multiply": _du.multiply_decimal128,
          "divide": _du.divide_decimal128,
          "add": _du.add_decimal128,
          "sub": _du.sub_decimal128}[op]
    ovf, res = fn(REGISTRY.get(a), REGISTRY.get(b), out_scale)
    return [REGISTRY.register(ovf), REGISTRY.register(res)]


# ------------------------------------------------------- observability
# (primitive-only twins of jni_api's metrics entries: the JVM pulls the
# registry as a Prometheus text blob or a JSON string and dumps the
# journal to a path it owns)


def metrics_set_enabled(enabled: bool) -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.metrics_set_enabled(bool(enabled))


def metrics_enabled() -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.metrics_enabled()


def metrics_expose_text() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.metrics_expose_text()


def metrics_snapshot_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.metrics_snapshot_json()


def metrics_journal_dump(path: str) -> int:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.metrics_journal_dump(path)


def metrics_reset() -> None:
    from spark_rapids_tpu_torch.shim import jni_api
    jni_api.metrics_reset()


def tracing_set_enabled(enabled: bool) -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.tracing_set_enabled(bool(enabled))


def tracing_enabled() -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.tracing_enabled()


def tracing_dump(path: str) -> int:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.tracing_dump(path)


def tracing_flush(path: str) -> int:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.tracing_flush(path)


def tracing_reset() -> None:
    from spark_rapids_tpu_torch.shim import jni_api
    jni_api.tracing_reset()


# ------------------------------------------- profiles, incidents, caches
# (primitive-only twins of jni_api's query-profile, flight-recorder,
# telemetry-plane, attribution, compile-cache, result-cache and
# data-statistics entries)


def profile_set_enabled(enabled: bool) -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.profile_set_enabled(bool(enabled))


def profile_enabled() -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.profile_enabled()


def profile_last_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.profile_last_json()


def server_profile_json(query_id: str) -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.server_profile_json(str(query_id))


def flight_recorder_set_enabled(enabled: bool) -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.flight_recorder_set_enabled(bool(enabled))


def flight_recorder_enabled() -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.flight_recorder_enabled()


def flight_recorder_configure(out_dir: str = "", max_bytes: int = 0,
                              min_interval_s: float = -1.0) -> None:
    from spark_rapids_tpu_torch.shim import jni_api
    jni_api.flight_recorder_configure(str(out_dir), int(max_bytes),
                                      float(min_interval_s))


def incident_dump(reason: str = "manual") -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.incident_dump(str(reason))


def incident_list() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.incident_list()


def health_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.health_json()


def timeseries_set_enabled(enabled: bool) -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.timeseries_set_enabled(bool(enabled))


def timeseries_enabled() -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.timeseries_enabled()


def timeseries_snapshot_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.timeseries_snapshot_json()


def slo_set_enabled(enabled: bool) -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.slo_set_enabled(bool(enabled))


def slo_enabled() -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.slo_enabled()


def slo_status_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.slo_status_json()


def slo_evaluate_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.slo_evaluate_json()


def attribution_set_enabled(enabled: bool) -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.attribution_set_enabled(bool(enabled))


def attribution_enabled() -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.attribution_enabled()


def attribution_last_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.attribution_last_json()


def fault_injection_install(config_path: str = "", watch: bool = True,
                            interval_ms: int = 0) -> int:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.fault_injection_install(str(config_path),
                                           bool(watch),
                                           int(interval_ms))


def fault_injection_uninstall() -> None:
    from spark_rapids_tpu_torch.shim import jni_api
    jni_api.fault_injection_uninstall()


def fault_injection_config_path() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.fault_injection_config_path()


def fault_injection_rules_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.fault_injection_rules_json()


def jit_cache_stats() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.jit_cache_stats()


def jit_cache_clear(reset_stats: bool = False) -> int:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.jit_cache_clear(bool(reset_stats))


def result_cache_stats() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.result_cache_stats()


def result_cache_clear(reset_stats: bool = False) -> int:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.result_cache_clear(bool(reset_stats))


def result_cache_bump_epoch(source: str) -> int:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.result_cache_bump_epoch(str(source))


def stats_set_enabled(enabled: bool) -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.stats_set_enabled(bool(enabled))


def stats_enabled() -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.stats_enabled()


def stats_snapshot_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.stats_snapshot_json()


def stats_store_clear() -> None:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.stats_store_clear()


# ----------------------------------------- device telemetry over JNI
# (``device``: None = the card, "cpu" = the host's one device)


def telemetry_device_count(device=None) -> int:
    from spark_rapids_tpu_torch.utils import telemetry
    return telemetry.get_device_count(device)


def telemetry_snapshot_packed(index: int, device=None) -> List[int]:
    """NVML.getSnapshotPacked: [memTotal, memUsed, memFree, util%,
    powerW, clockMhz, tempC]; -1 = metric not supported here."""
    from spark_rapids_tpu_torch.utils import telemetry
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
    info = telemetry.get_device_info(index, device)
    return f"{info.platform}:{info.kind}"


# ROADMAP step 6: device_attr_is_integrated goes here, before the
# profiler's entries; kudo write/merge (with its memo) and the
# host-table spill entries go after them, before the query server's.


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


# --------------------------------------------------------- query server
# (primitive-only twins of jni_api's server entries)


def server_start(max_concurrency: int = 0, max_queue: int = 0,
                 socket_path: str = "") -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.server_start(int(max_concurrency), int(max_queue),
                                str(socket_path))


def server_stop() -> None:
    from spark_rapids_tpu_torch.shim import jni_api
    jni_api.server_stop()


def server_set_tenant_quota(tenant: str, max_inflight: int = -1,
                            max_device_bytes: int = -1,
                            weight: float = -1.0) -> None:
    from spark_rapids_tpu_torch.shim import jni_api
    jni_api.server_set_tenant_quota(str(tenant), int(max_inflight),
                                    int(max_device_bytes),
                                    float(weight))


def server_submit(tenant: str, query: str,
                  params_json: str = "",
                  deadline_s: float = -1.0) -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.server_submit(str(tenant), str(query),
                                 str(params_json), float(deadline_s))


def server_poll(query_id: str, timeout_s: float = -1.0) -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.server_poll(str(query_id), float(timeout_s))


def server_cancel(query_id: str) -> bool:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.server_cancel(str(query_id))


def server_stats_json() -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.server_stats_json()


def server_drain(deadline_s: float = -1.0, flush_dir: str = "") -> str:
    from spark_rapids_tpu_torch.shim import jni_api
    return jni_api.server_drain(float(deadline_s), str(flush_dir))
