"""Flat handle-based API mirroring the reference JNI export surface
(src/main/cpp/src/*Jni.cpp pattern: unwrap jlong handles -> column views
-> call the op -> release_as_jlong).  This is the layer a JNI or C-FFI
binding calls; every function takes and returns int64 handles and plain
scalars, mirroring the Java native method signatures (Hash.java:44
murmurHash32, RowConversion.java:35 convertToRows, ...).

The ops run on the device of the columns the handles name; columns made
from host values go to `device`, "cuda" unless the caller asks for the
CPU.
"""

from __future__ import annotations

from typing import List, Sequence

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import cast_string as _cast
from spark_rapids_tpu_torch.ops import hash as _hash
from spark_rapids_tpu_torch.ops import joins as _joins
from spark_rapids_tpu_torch.ops import row_conversion as _rc
from spark_rapids_tpu_torch.shim.handles import REGISTRY
from spark_rapids_tpu_torch.shuffle import kudo as _kudo
from spark_rapids_tpu_torch.utils.fault_injection import maybe_inject
from spark_rapids_tpu_torch.utils.profiler import op_range


def _cols(handles: Sequence[int]) -> List[Column]:
    return [REGISTRY.get(h) for h in handles]


def make_column_from_host(values, dtype, device="cuda") -> int:
    return REGISTRY.register(Column.from_pylist(values, dtype, device))


def release_column(handle: int) -> None:
    REGISTRY.release(handle)


def column_to_host(handle: int):
    return REGISTRY.get(handle).to_pylist()


# --------------------------------------------------------------- ops
# (each export follows the reference JNI shape: inject-check, NVTX-like
# range, unwrap handles, run, wrap result; the op layer's own traced
# bracket sees the door's and is skipped, so one call records once)


def murmur_hash3_32(seed: int, column_handles: Sequence[int]) -> int:
    maybe_inject("murmur3_32")
    with op_range("murmur3_32"):
        return REGISTRY.register(
            _hash.murmur3_32(_cols(column_handles), seed))


def xx_hash_64(seed: int, column_handles: Sequence[int]) -> int:
    maybe_inject("xxhash64")
    with op_range("xxhash64"):
        return REGISTRY.register(
            _hash.xxhash64(_cols(column_handles), seed))


def hive_hash(column_handles: Sequence[int]) -> int:
    maybe_inject("hive_hash")
    with op_range("hive_hash"):
        return REGISTRY.register(_hash.hive_hash(_cols(column_handles)))


def convert_to_rows(table_handles: Sequence[int]) -> int:
    maybe_inject("convert_to_rows")
    with op_range("convert_to_rows"):
        return REGISTRY.register(
            _rc.convert_to_rows(Table(_cols(table_handles))))


def convert_from_rows(rows_handle: int, type_ids: Sequence[str],
                      scales: Sequence[int]) -> List[int]:
    maybe_inject("convert_from_rows")
    with op_range("convert_from_rows"):
        schema = [DType(k, s) for k, s in zip(type_ids, scales)]
        out = _rc.convert_from_rows(REGISTRY.get(rows_handle), schema)
        return [REGISTRY.register(c) for c in out.columns]


def string_to_integer(column_handle: int, type_id: str,
                      ansi_mode: bool, strip: bool) -> int:
    """CAST(string AS integral) of a STRING column handle
    (CastStrings.toInteger)."""
    maybe_inject("string_to_integer")
    with op_range("string_to_integer"):
        return REGISTRY.register(_cast.string_to_integer(
            REGISTRY.get(column_handle), DType(type_id), ansi_mode,
            strip))


def get_json_object(column_handle: int, path: str) -> int:
    """Spark get_json_object over a STRING column handle
    (JSONUtils.getJsonObject)."""
    maybe_inject("get_json_object")
    with op_range("get_json_object"):
        from spark_rapids_tpu_torch.ops import json_path
        return REGISTRY.register(json_path.get_json_object(
            REGISTRY.get(column_handle), path))


def sort_merge_inner_join(left_handles: Sequence[int],
                          right_handles: Sequence[int],
                          compare_nulls_equal: bool) -> List[int]:
    """The inner join's gather maps as two INT32 column handles (left
    indices, right indices)."""
    maybe_inject("sort_merge_inner_join")
    with op_range("sort_merge_inner_join"):
        li, ri = _joins.sort_merge_inner_join(
            Table(_cols(left_handles)), Table(_cols(right_handles)),
            _joins.NULL_EQUAL if compare_nulls_equal
            else _joins.NULL_UNEQUAL)
        return [REGISTRY.register(Column(dtypes.INT32, int(li.shape[0]),
                                         data=li)),
                REGISTRY.register(Column(dtypes.INT32, int(ri.shape[0]),
                                         data=ri))]


# --------------------------------------------------------------- ingest
# (the storage-side doors: zero-copy Arrow C-interface hand-off and the
# columnar parquet reader — reference NativeParquetJni surface)


def arrow_ingest(batch, device="cuda") -> List[int]:
    """Wrap an Arrow RecordBatch (or any ``__arrow_c_array__``
    exporter) as columns on ``device``, without copying on the CPU and
    with one upload per buffer on the card; returns one handle per
    column.  The registry entries keep the Arrow buffers alive — the
    caller may free its batch immediately."""
    maybe_inject("arrow_ingest")
    with op_range("arrow_ingest"):
        from spark_rapids_tpu_torch.io.arrow_cabi import ingest
        cols, _names = ingest(batch, device)
        handles = [REGISTRY.register(c) for c in cols]
        # ingest-epoch door: an Arrow batch has no stable file
        # identity, so every hand-off is new data — results keyed over
        # the "arrow" source go stale unconditionally
        from spark_rapids_tpu_torch.perf.result_cache import \
            bump_ingest_epoch
        bump_ingest_epoch("arrow")
        return handles


def parquet_read_table(path: str, columns=None,
                       case_sensitive: bool = True,
                       device="cuda") -> List[int]:
    """Columnar parquet read with footer-pruned projection pushdown;
    returns one handle per (kept) column, in file schema order."""
    maybe_inject("parquet_read_table")
    with op_range("parquet_read_table"):
        from spark_rapids_tpu_torch.io.parquet_reader import read_table
        table = read_table(path, columns=columns,
                           case_sensitive=case_sensitive, device=device)
        return [REGISTRY.register(c) for c in table.columns]


# ------------------------------------------------------------ kudo crc


def kudo_set_crc_enabled(enabled: bool) -> bool:
    """Flip KCRC-trailer writing for the kudo writer; returns the prior
    setting.  Read-side verification is always on when a trailer is
    present."""
    return _kudo.set_crc_enabled(bool(enabled))


def kudo_crc_enabled() -> bool:
    return _kudo.crc_enabled()


# -------------------------------------------------------- spill store
# (the JVM installs/uninstalls the tiered spill store around a
# workload, asks for synchronous headroom before its own device
# allocations, and polls tier occupancy for executor dashboards)


def spill_store_install() -> bool:
    """Install the process spill store and wire it into the installed
    SparkResourceAdaptor's OOM state machine (idempotent).  Returns
    True when an adaptor was present to hook."""
    from spark_rapids_tpu_torch.memory import rmm_spark, spill
    spill.install()
    return rmm_spark.installed_adaptor() is not None


def spill_store_uninstall() -> None:
    """Unhook and drop the process spill store (every handle and its
    disk files released)."""
    from spark_rapids_tpu_torch.memory import spill
    spill.uninstall()


def spill_ensure_headroom(num_bytes: int) -> int:
    """Synchronously spill registered batches until ``num_bytes`` of
    device memory are free (or nothing spillable remains); returns the
    bytes actually freed (0 with no store installed)."""
    from spark_rapids_tpu_torch.memory import spill
    store = spill.installed_store()
    if store is None:
        return 0
    return int(store.ensure_headroom(int(num_bytes)))


def spill_store_stats_json() -> str:
    """Tier occupancy + lifetime spill/restore/corruption counters for
    the installed store as JSON (``{"installed": false}`` without
    one)."""
    import json

    from spark_rapids_tpu_torch.memory import spill
    store = spill.installed_store()
    if store is None:
        return json.dumps({"installed": False})
    out = {"installed": True}
    out.update(store.stats())
    return json.dumps(out, sort_keys=True)


# --------------------------------------------------------- observability
# (reference: RmmSpark getAndReset* + Profiler control surface; here the
# unified registry/journal is exported to the JVM as text/JSON blobs so
# the binding needs no schema compiler).


def metrics_set_enabled(enabled: bool) -> bool:
    """Flip the process-wide observability switch; returns prior state."""
    from spark_rapids_tpu_torch import observability as obs
    prior = obs.is_enabled()
    (obs.enable if enabled else obs.disable)()
    return prior


def metrics_enabled() -> bool:
    from spark_rapids_tpu_torch import observability as obs
    return obs.is_enabled()


def metrics_expose_text() -> str:
    """Prometheus text-format exposition of the process registry."""
    from spark_rapids_tpu_torch import observability as obs
    return obs.expose_text()


def metrics_snapshot_json() -> str:
    """JSON snapshot (registry + per-task rollup + journal stats) for
    the JVM shim."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    return json.dumps(obs.snapshot(), sort_keys=True)


def metrics_journal_dump(path: str) -> int:
    """Dump the event journal (+ task rollups + registry snapshot) as
    JSONL; returns records written."""
    from spark_rapids_tpu_torch import observability as obs
    return obs.dump_journal_jsonl(path)


def metrics_reset() -> None:
    from spark_rapids_tpu_torch import observability as obs
    obs.reset()


# -------------------------------------------------------------- tracing
# (span tracing control surface: the JVM enables tracing around a query
# and flushes finished spans to a JSONL file it owns)


def tracing_set_enabled(enabled: bool) -> bool:
    """Flip structured span tracing; returns prior state."""
    from spark_rapids_tpu_torch import observability as obs
    prior = obs.is_tracing_enabled()
    (obs.enable_tracing if enabled else obs.disable_tracing)()
    return prior


def tracing_enabled() -> bool:
    from spark_rapids_tpu_torch import observability as obs
    return obs.is_tracing_enabled()


def tracing_dump(path: str) -> int:
    """Write the finished-span ring as JSONL; returns spans written."""
    from spark_rapids_tpu_torch import observability as obs
    return obs.dump_spans_jsonl(path)


def tracing_flush(path: str) -> int:
    """Like tracing_dump but DRAINS the ring (repeated flushes between
    export intervals never re-export a span).  The write is atomic
    (tmp + rename): a failure mid-write leaves any previous flush file
    intact AND requeues the drained spans."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    from spark_rapids_tpu_torch.observability.dumpio import atomic_write
    recs = obs.TRACER.drain()

    def _write(f):
        for r in recs:
            f.write(json.dumps(r) + "\n")

    try:
        atomic_write(path, _write)
    except BaseException:
        # an unwritable path OR a mid-write failure (disk full, quota)
        # must not lose the drained spans: put them back so a corrected
        # retry re-exports everything
        obs.TRACER.requeue(recs)
        raise
    return len(recs)


def tracing_reset() -> None:
    from spark_rapids_tpu_torch import observability as obs
    obs.TRACER.reset()


# ------------------------------------------------------- query profiles
# (EXPLAIN ANALYZE control surface: the JVM flips profiling around a
# workload, then pulls per-query artifacts by id — reference analog:
# the profiler sidecar's capture window + profile_converter pull)


def profile_set_enabled(enabled: bool) -> bool:
    """Flip per-query profile assembly; returns prior state."""
    from spark_rapids_tpu_torch import observability as obs
    prior = obs.is_profiling_enabled()
    (obs.enable_profiling if enabled else obs.disable_profiling)()
    return prior


def profile_enabled() -> bool:
    from spark_rapids_tpu_torch import observability as obs
    return obs.is_profiling_enabled()


def profile_last_json() -> str:
    """Most recently assembled query profile as JSON ('' when none
    has been assembled yet)."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    prof = obs.PROFILER.last()
    return json.dumps(prof, sort_keys=True, default=str) \
        if prof is not None else ""


def server_profile_json(query_id: str) -> str:
    """The server-retained profile for one query id as JSON —
    ``{"ok": true, "profile": {...}}`` or a typed miss (never
    profiled / evicted by the tenant's last-K window)."""
    import json

    from spark_rapids_tpu_torch import server as srv
    s = srv.get_server()
    if s is None:
        raise RuntimeError("query server is not running")
    prof = s.profile(str(query_id))
    if prof is None:
        return json.dumps({"ok": False,
                           "error": {"type": "UnknownProfile",
                                     "message": f"no retained "
                                                f"profile for "
                                                f"{query_id!r}"}})
    return json.dumps({"ok": True, "profile": prof},
                      sort_keys=True, default=str)


# ------------------------------------------------------ flight recorder
# (reference: the CUPTI profiler dump + RmmSpark state dump the JVM
# pulls on failure; here the JVM arms the recorder, forces bundles,
# and lists/fetches what the anomaly detectors froze)


def flight_recorder_set_enabled(enabled: bool) -> bool:
    """Arm/disarm the flight recorder; returns prior state."""
    from spark_rapids_tpu_torch import observability as obs
    prior = obs.is_flight_recorder_enabled()
    (obs.enable_flight_recorder if enabled
     else obs.disable_flight_recorder)()
    return prior


def flight_recorder_enabled() -> bool:
    from spark_rapids_tpu_torch import observability as obs
    return obs.is_flight_recorder_enabled()


def flight_recorder_configure(out_dir: str = "", max_bytes: int = 0,
                              min_interval_s: float = -1.0) -> None:
    """Set bundle directory / byte budget / rate-limit interval;
    zero/negative/empty values leave the current setting."""
    from spark_rapids_tpu_torch import observability as obs
    obs.FLIGHT.configure(
        out_dir=out_dir or None,
        max_bytes=int(max_bytes) if max_bytes > 0 else None,
        min_interval_s=(float(min_interval_s)
                        if min_interval_s >= 0 else None))


def incident_dump(reason: str = "manual") -> str:
    """Force an incident bundle NOW (bypasses the enabled flag and the
    rate limit; still honors the byte budget).  Returns the bundle
    path, or '' when the byte budget suppressed it."""
    from spark_rapids_tpu_torch import observability as obs
    path = obs.FLIGHT.trigger("manual", force=True, severity="info",
                              reason=str(reason))
    return path or ""


def incident_list() -> str:
    """JSON list of complete bundles in the recorder's directory
    (path, trigger kind, severity, wall-clock, bytes)."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    return json.dumps(obs.FLIGHT.incident_list())


def health_json() -> str:
    """One-call process health rollup (switches, ring fill/drops,
    recorder stats, memory-ledger summary) as JSON."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    return json.dumps(obs.health(), sort_keys=True, default=str)


# ------------------------------------------------------ telemetry plane
# (windowed time-series + per-tenant SLO control surface: the JVM
# flips the sampler/monitor around a workload, pulls the window ring
# for its own dashboards, and polls burn-rate status between stages)


def timeseries_set_enabled(enabled: bool) -> bool:
    """Flip the windowed time-series sampler; returns prior state."""
    from spark_rapids_tpu_torch import observability as obs
    prior = obs.is_timeseries_enabled()
    (obs.enable_timeseries if enabled else obs.disable_timeseries)()
    return prior


def timeseries_enabled() -> bool:
    from spark_rapids_tpu_torch import observability as obs
    return obs.is_timeseries_enabled()


def timeseries_snapshot_json() -> str:
    """The window ring (per-window counter deltas, gauge last-values,
    windowed histogram buckets) plus SLO status when the monitor is
    armed, as JSON — the same shape the fleet publishes to rank 0."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    return json.dumps(obs.timeseries_snapshot(), sort_keys=True)


def slo_set_enabled(enabled: bool) -> bool:
    """Arm/disarm per-tenant SLO burn-rate monitoring; returns prior
    state."""
    from spark_rapids_tpu_torch import observability as obs
    prior = obs.is_slo_enabled()
    (obs.enable_slo if enabled else obs.disable_slo)()
    return prior


def slo_enabled() -> bool:
    from spark_rapids_tpu_torch import observability as obs
    return obs.is_slo_enabled()


def slo_status_json() -> str:
    """Per-tenant SLO status (target, objective, attainment, fast/slow
    burn rates, breach count) as JSON."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    return json.dumps(obs.SLO.status(), sort_keys=True)


def slo_evaluate_json() -> str:
    """Force a burn-rate evaluation NOW (bypasses the throttle the
    Monitor thread uses) and return any fired alerts as a JSON list —
    each alert also routed through the normal slo_burn incident path."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    return json.dumps(obs.evaluate_slo(), sort_keys=True)


# ----------------------------------------------------- time attribution
# (the "where did the time go" ledger: the JVM arms it around a
# workload and pulls the last query's bucket waterfall for its own
# p99-miss triage)


def attribution_set_enabled(enabled: bool) -> bool:
    """Flip per-query time-attribution ledgers; returns prior state."""
    from spark_rapids_tpu_torch import observability as obs
    prior = obs.is_attribution_enabled()
    (obs.enable_attribution if enabled
     else obs.disable_attribution)()
    return prior


def attribution_enabled() -> bool:
    from spark_rapids_tpu_torch import observability as obs
    return obs.is_attribution_enabled()


def attribution_last_json() -> str:
    """Most recent query's time-attribution ledger (bucket ns,
    fractions, dominant bucket, conservation verdict) as JSON
    ('' when no profiled query has completed with the switch on)."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    led = obs.attribution_last()
    return json.dumps(led, sort_keys=True, default=str) \
        if led is not None else ""


# ------------------------------------------------------ fault injection
# (reference: libcufaultinj loaded via CUDA_INJECTION64_PATH with a
# FAULT_INJECTOR_CONFIG_PATH JSON; here the JVM drives the same
# hot-reloadable injector through the shim)


def fault_injection_install(config_path: str = "", watch: bool = True,
                            interval_ms: int = 0) -> int:
    """Install the process-global injector; an empty path falls back
    to $FAULT_INJECTOR_CONFIG_PATH.  interval_ms <= 0 keeps the
    default watch poll.  Returns the active rule count (a missing
    config is tolerated: 0 rules, watcher retrying)."""
    from spark_rapids_tpu_torch.utils import fault_injection as fi
    interval_ms = int(interval_ms)
    inj = fi.install(config_path or None, watch=bool(watch),
                     interval_ms=interval_ms if interval_ms > 0
                     else None)
    return len(inj.active_rules())


def fault_injection_uninstall() -> None:
    from spark_rapids_tpu_torch.utils import fault_injection as fi
    fi.uninstall()


def fault_injection_config_path() -> str:
    """The installed injector's config path ('' when no injector or no
    path is installed)."""
    from spark_rapids_tpu_torch.utils import fault_injection as fi
    inj = fi.installed()
    return (inj.config_path or "") if inj is not None else ""


def fault_injection_rules_json() -> str:
    """Live rule snapshot as JSON (match/probability/remaining/
    exception per rule) — the JVM-side hot-reload assertion surface."""
    import json

    from spark_rapids_tpu_torch.utils import fault_injection as fi
    inj = fi.installed()
    return json.dumps(inj.active_rules() if inj is not None else [])


# ----------------------------------------------------------- jit cache
# (compile-cache control surface: the JVM polls hit rates between
# stages and clears the cache around schema migrations)


def jit_cache_stats() -> str:
    """JSON stats of the process kernel compile cache (perf/jit_cache):
    entries/bytes, hit/miss/eviction/compile totals, and per-kernel
    breakdowns."""
    import json

    from spark_rapids_tpu_torch.perf import jit_cache
    return json.dumps(jit_cache.CACHE.stats(), sort_keys=True)


def jit_cache_clear(reset_stats: bool = False) -> int:
    """Drop every cached program; returns the number dropped.
    ``reset_stats`` additionally zeroes the cumulative counters."""
    from spark_rapids_tpu_torch.perf import jit_cache
    return jit_cache.CACHE.clear(reset_stats=bool(reset_stats))


# -------------------------------------------------------- result cache
# (semantic result/subplan cache control surface: the JVM
# polls hit rates, clears around catalog reloads, and bumps a source's
# ingest epoch when ITS ingest path — not ours — landed new data)


def result_cache_stats() -> str:
    """JSON stats of the semantic result/subplan cache
    (perf/result_cache): entries/bytes, hit/miss/eviction/put/fold
    totals, per-scope entry counts."""
    import json

    from spark_rapids_tpu_torch.perf import result_cache
    return json.dumps(result_cache.CACHE.stats(), sort_keys=True)


def result_cache_clear(reset_stats: bool = False) -> int:
    """Drop every cached result/subplan entry; returns the number
    dropped.  ``reset_stats`` additionally zeroes the counters."""
    from spark_rapids_tpu_torch.perf import result_cache
    return result_cache.CACHE.clear(reset_stats=bool(reset_stats))


def result_cache_bump_epoch(source: str) -> int:
    """Advance ``source``'s ingest epoch (externally-landed data):
    every cached result keyed over it goes stale; returns the new
    epoch."""
    from spark_rapids_tpu_torch.perf import result_cache
    return result_cache.bump_ingest_epoch(str(source))


# ----------------------------------------------------------- data stats
# (per-node cardinality observatory: the JVM arms the
# collector during plan-quality investigations, then pulls one JSON
# snapshot of est-vs-actual rows per stage/node; disabled it costs one
# attribute read per stage run)


def stats_set_enabled(enabled: bool) -> bool:
    """Arm/disarm the per-node statistics collector; returns the new
    state."""
    from spark_rapids_tpu_torch import observability as obs
    if enabled:
        obs.enable_stats()
    else:
        obs.disable_stats()
    return obs.is_stats_enabled()


def stats_enabled() -> bool:
    from spark_rapids_tpu_torch import observability as obs
    return obs.is_stats_enabled()


def stats_snapshot_json() -> str:
    """JSON snapshot of the statistics collector: observation and
    misestimate totals, registered estimates and source row counts,
    and the latest per-node section per stage."""
    import json

    from spark_rapids_tpu_torch import observability as obs
    return json.dumps(obs.STATS.snapshot(), sort_keys=True,
                      default=str)


def stats_store_clear() -> None:
    """Drop the persistent StatsStore (process map and file layer)."""
    from spark_rapids_tpu_torch import observability as obs
    obs.STATS.store.clear()


# --------------------------------------------------------- query server
# (the resident multi-tenant front door, server/: the JVM starts the
# pool once per executor, then every Spark task thread submits through
# these flat entries; backpressure crosses as a JSON error payload so
# the binding needs no exception-class plumbing)


def server_start(max_concurrency: int = 0, max_queue: int = 0,
                 socket_path: str = "") -> bool:
    """Start the process-global query server (idempotent; returns
    True when this call started it).  Zero values take the
    SPARK_RAPIDS_TPU_SERVER_* env defaults."""
    from spark_rapids_tpu_torch import server as srv
    cfg = srv.ServerConfig.from_env()
    if max_concurrency > 0:
        cfg.max_concurrency = int(max_concurrency)
    if max_queue > 0:
        cfg.max_queue = int(max_queue)
    # created-flag decided under the singleton lock: two racing JVM
    # threads cannot both be told they started the server
    _server, created = srv.ensure_server(
        cfg, socket_path=socket_path or None)
    return created


def server_stop() -> None:
    from spark_rapids_tpu_torch import server as srv
    srv.stop_server()


def server_set_tenant_quota(tenant: str, max_inflight: int = -1,
                            max_device_bytes: int = -1,
                            weight: float = -1.0) -> None:
    from spark_rapids_tpu_torch import server as srv
    s = srv.get_server()
    if s is None:
        raise RuntimeError("query server is not running")
    s.set_tenant_quota(str(tenant), max_inflight=int(max_inflight),
                       max_device_bytes=int(max_device_bytes),
                       weight=float(weight))


def server_submit(tenant: str, query: str,
                  params_json: str = "",
                  deadline_s: float = -1.0) -> str:
    """Submit; returns JSON — {"ok": true, "query_id": ...} or the
    typed backpressure payload {"ok": false, "error": {...,
    "reason": "queue_full"|"quarantined"|"draining"|...}}.
    ``deadline_s > 0`` bounds the query's whole lifetime (the
    lifeguard cancels and escalates past it); <= 0 takes the
    server-wide default."""
    import json

    from spark_rapids_tpu_torch import server as srv
    from spark_rapids_tpu_torch.models import UnknownQueryError
    s = srv.get_server()
    if s is None:
        raise RuntimeError("query server is not running")
    params = json.loads(params_json) if params_json else {}
    try:
        qid = s.submit(str(tenant), str(query), params,
                       deadline_s=float(deadline_s)
                       if deadline_s > 0 else None)
        return json.dumps({"ok": True, "query_id": qid})
    except srv.ServerOverloaded as e:
        return json.dumps({"ok": False, "error": e.to_dict()})
    except UnknownQueryError as e:
        return json.dumps({"ok": False,
                           "error": {"type": "UnknownQuery",
                                     "message": str(e)}})


def server_poll(query_id: str, timeout_s: float = -1.0) -> str:
    """Job status as JSON (state queued|running|done|failed|cancelled
    |unknown, result when done, typed error when failed)."""
    import json

    from spark_rapids_tpu_torch import server as srv
    s = srv.get_server()
    if s is None:
        raise RuntimeError("query server is not running")
    return json.dumps(s.poll(
        str(query_id),
        timeout_s=float(timeout_s) if timeout_s >= 0 else None))


def server_cancel(query_id: str) -> bool:
    from spark_rapids_tpu_torch import server as srv
    s = srv.get_server()
    if s is None:
        return False
    return s.cancel(str(query_id))


def server_stats_json() -> str:
    """Per-tenant accounting + scheduler fair-share evidence + the
    task-priority registry snapshot, as JSON."""
    import json

    from spark_rapids_tpu_torch import server as srv
    s = srv.get_server()
    if s is None:
        return json.dumps({"started": False})
    return json.dumps(s.stats(), sort_keys=True)


def server_drain(deadline_s: float = -1.0,
                 flush_dir: str = "") -> str:
    """Gracefully drain the process-global server: refuse
    new submits typed (``draining``), finish in-flight work under the
    drain deadline, flush journal/spans/metrics via dumpio, stop the
    pool, and clear the singleton — a later ``server_start`` serves
    again with the compiled stages warm.  Returns the drain report as
    JSON (``{"state": "not_running"}`` when no server exists)."""
    import json

    from spark_rapids_tpu_torch import server as srv
    report = srv.drain_server(
        deadline_s=float(deadline_s) if deadline_s > 0 else None,
        flush_dir=str(flush_dir) or None)
    return json.dumps(report, sort_keys=True, default=str)
