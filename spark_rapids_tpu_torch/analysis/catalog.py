"""Checked-in metrics/knobs catalog: the port's own copy of the JAX
package's ``analysis/catalog.py`` (the same names, kinds and knobs, as
data this package owns).

The observable surface (every ``srt_*`` metric family and every
``SPARK_RAPIDS_TPU_*`` env knob) has one source of truth, and srt-lint
enforces it both ways:

  * every metric name passed to the :class:`MetricsRegistry`
    (``.counter``/``.gauge``/``.histogram`` with a literal name) must
    match ``srt_*`` AND appear in :data:`METRICS` (rules SRT001/002);
  * every ``os.environ``-read ``SPARK_RAPIDS_TPU_*`` knob must appear
    in :data:`KNOBS` (rule SRT003; dynamic families like
    ``SPARK_RAPIDS_TPU_PATH_<OP>`` match :data:`KNOB_WILDCARDS`);
  * :func:`check_docs` cross-checks the catalog against the docs tree
    (rule SRT008): metrics must appear in docs/observability.md,
    knobs in at least one docs/*.md (docs/analysis.md carries the
    full knob table; server knobs may ride docs/server.md's
    prefix-factored ``SPARK_RAPIDS_TPU_SERVER_*`` matrix).

Both packages read the same knobs, so both catalogs hold the same
names; adding a metric or knob means adding it here, in the JAX
catalog, and to the docs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

# --------------------------------------------------------------- metrics
# name -> (kind, one-line description).  Kind is the registry family
# kind ('counter' | 'gauge' | 'histogram'); SRT002 checks the
# registration call matches it.

METRICS: Dict[str, Tuple[str, str]] = {
    "srt_op_latency_ns": ("histogram", "host-side op bracket latency"),
    "srt_shuffle_write_bytes_total": ("counter", "kudo bytes serialized"),
    "srt_shuffle_write_time_ns_total": ("counter", "kudo write time"),
    "srt_shuffle_merge_rows_total": ("counter", "kudo merged rows"),
    "srt_shuffle_merge_time_ns_total": ("counter", "kudo merge time"),
    "srt_shuffle_link_bytes_total": (
        "counter", "shuffle bytes per process-boundary link"),
    "srt_shuffle_link_msgs_total": (
        "counter", "shuffle messages delivered per link"),
    "srt_shuffle_link_retries_total": (
        "counter", "shuffle link send retries (NAK/reconnect)"),
    "srt_fleet_epoch": ("gauge", "elastic-fleet membership epoch"),
    "srt_fleet_rebalances_total": (
        "counter", "membership changes that moved shard ownership"),
    "srt_fleet_deaths_total": ("counter", "peer ranks observed dead"),
    "srt_fleet_speculations_total": (
        "counter", "speculative re-executions by outcome"),
    "srt_fleet_resplits_total": (
        "counter", "hot partitions re-split into sub-partitions"),
    "srt_fleet_stale_naks_total": (
        "counter", "elastic frames fenced for a stale epoch"),
    "srt_shuffle_dup_dropped_total": (
        "counter", "duplicate (op, partition) deliveries dropped"),
    "srt_oom_retry_total": ("counter", "retry-OOM throws"),
    "srt_oom_split_retry_total": ("counter", "split-and-retry throws"),
    "srt_thread_blocked_time_ns_total": (
        "counter", "time blocked in the OOM state machine"),
    "srt_device_memory_allocated_bytes": (
        "gauge", "device bytes reserved through the adaptor"),
    "srt_hbm_bytes_in_use": ("gauge", "backend-reported HBM in use"),
    "srt_exchange_capacity_doublings_total": (
        "counter", "exchange capacity-retry doublings"),
    "srt_journal_dropped_total": (
        "counter", "journal events lost to ring wrap"),
    "srt_retry_episodes_total": ("counter", "failed retry episodes"),
    "srt_retry_attempts_total": ("counter", "retry attempts started"),
    "srt_retry_splits_total": ("counter", "split-and-retry halvings"),
    "srt_retry_time_lost_ns_total": (
        "counter", "compute burned by failed attempts"),
    "srt_kudo_corrupt_total": ("counter", "kudo integrity events"),
    "srt_kudo_resync_skipped_bytes_total": (
        "counter", "bytes skipped resyncing kudo streams"),
    "srt_jit_cache_hits_total": ("counter", "compile-cache hits"),
    "srt_jit_cache_misses_total": ("counter", "compile-cache misses"),
    "srt_jit_cache_evictions_total": (
        "counter", "compile-cache LRU evictions"),
    "srt_jit_compile_ns": ("histogram", "lower+compile wall time"),
    "srt_kernel_path_total": (
        "counter", "executions per calibrated kernel path"),
    "srt_stage_fusion_total": (
        "counter", "whole-stage executions by outcome"),
    "srt_incidents_total": ("counter", "incident bundles written"),
    "srt_incidents_suppressed_total": (
        "counter", "incident triggers suppressed"),
    "srt_memory_leak_total": (
        "counter", "tasks finished still holding device memory"),
    "srt_memory_leaked_bytes_total": (
        "counter", "device bytes held at task end"),
    "srt_span_duration_ns": ("histogram", "span durations"),
    "srt_spans_finished_total": ("counter", "spans finished"),
    "srt_server_admitted_total": ("counter", "server admissions"),
    "srt_server_rejected_total": ("counter", "typed server rejections"),
    "srt_server_completed_total": ("counter", "server jobs finished"),
    "srt_server_requeued_total": ("counter", "load-shed requeues"),
    "srt_server_queued": ("gauge", "queued jobs per tenant"),
    "srt_server_running": ("gauge", "running jobs per tenant"),
    "srt_server_tenant_device_bytes": (
        "gauge", "device bytes attributed per tenant"),
    "srt_server_fair_share_deficit": (
        "gauge", "scheduler vruntime deficit per tenant"),
    "srt_server_queue_wait_ns": (
        "histogram", "admission-to-dispatch wait"),
    "srt_server_watchdog_total": (
        "counter", "lifeguard watchdog interventions"),
    "srt_server_quarantine_total": (
        "counter", "poison-query breaker transitions"),
    "srt_server_drain_total": ("counter", "graceful-drain markers"),
    "srt_io_read_bytes_total": ("counter", "storage range-read bytes"),
    "srt_io_read_ns": ("histogram", "storage range-read latency"),
    "srt_io_files_total": ("counter", "parquet files decoded"),
    "srt_io_pages_total": ("counter", "parquet pages decoded"),
    "srt_io_rows_total": ("counter", "rows materialized from parquet"),
    "srt_io_decode_ns_total": ("counter", "parquet decode wall time"),
    # -- lockdep evidence --
    "srt_lockdep_cycles_total": (
        "counter", "lock-order cycles detected (ABBA potential)"),
    "srt_lockdep_blocking_total": (
        "counter", "locks held across known blocking calls"),
    # -- query profiles (EXPLAIN ANALYZE) --
    "srt_profile_queries_total": (
        "counter", "per-query profiles assembled at query end"),
    "srt_profile_assembly_ns": (
        "histogram", "wall time assembling one query profile"),
    "srt_profile_dropped_total": (
        "counter", "profile sessions dropped instead of assembled"),
    # -- telemetry plane & SLOs --
    "srt_timeseries_windows_total": (
        "counter", "time-series windows sampled since boot"),
    "srt_timeseries_tick_ns": (
        "histogram", "wall time taking one window snapshot"),
    "srt_timeseries_merge_total": (
        "counter", "fleet window-snapshot merges by outcome"),
    "srt_monitor_last_sample_age_s": (
        "gauge", "seconds since the Monitor thread last sampled"),
    "srt_slo_burn_rate": (
        "gauge", "per-tenant error-budget burn rate per window"),
    "srt_slo_attainment_ratio": (
        "gauge", "per-tenant since-boot SLO attainment"),
    "srt_slo_breaches_total": (
        "counter", "slo_burn alerts fired per tenant"),
    # -- time attribution & critical path --
    "srt_shuffle_wire_ns_total": (
        "counter", "exchange serialize+send wall time"),
    "srt_shuffle_wait_ns_total": (
        "counter", "exchange inbox/gather idle time by cause"),
    "srt_attribution_ns_total": (
        "counter", "attributed wall ns per tenant and bucket"),
    "srt_attribution_queries_total": (
        "counter", "attribution ledgers built by conservation verdict"),
    # -- tiered spill store & out-of-core operators --
    "srt_spill_bytes_total": (
        "counter", "device bytes spilled down-tier by stage and tier"),
    "srt_spill_restores_total": (
        "counter", "spilled batches streamed back by stage and tier"),
    "srt_spill_ns_total": (
        "counter", "spill-store wall ns by stage and direction"),
    "srt_spill_corrupt_total": (
        "counter", "corrupt spill payloads on read-back by outcome"),
    # -- semantic result/subplan cache --
    "srt_result_cache_hits_total": (
        "counter", "semantic-cache hits by scope and tenant"),
    "srt_result_cache_misses_total": (
        "counter", "semantic-cache misses by scope and tenant"),
    "srt_result_cache_evictions_total": (
        "counter", "semantic-cache LRU evictions by scope"),
    "srt_result_cache_bytes_total": (
        "counter", "payload bytes admitted into the cache by scope"),
    "srt_result_cache_incremental_folds_total": (
        "counter", "batches folded into resident partial states"),
    # -- per-node cardinality & statistics observatory --
    "srt_stats_observations_total": (
        "counter", "per-node row-count observations folded by stage"),
    "srt_stats_misestimate_total": (
        "counter", "cardinality misestimates by stage and plan node"),
    "srt_stats_rows_total": (
        "counter", "result rows returned to tenants by completed jobs"),
    "srt_stats_sketch_ns": (
        "histogram", "wall ns of one memoized column sketch pass"),
}

# ----------------------------------------------------------------- knobs
# name -> one-line description.  The docs cross-check requires each to
# appear somewhere under docs/ (docs/analysis.md holds the full table).

KNOBS: Dict[str, str] = {
    "SPARK_RAPIDS_TPU_METRICS": "=1 enables the metrics spine at import",
    "SPARK_RAPIDS_TPU_TRACE": "=1 enables span tracing at import",
    "SPARK_RAPIDS_TPU_LOCKDEP":
        "=1 instruments make_lock locks for lock-order detection",
    "SPARK_RAPIDS_TPU_PLAN_VERIFY":
        "=0 skips the plan-IR verifier before stage lowering",
    "SPARK_RAPIDS_TPU_FLIGHT_RECORDER": "=1 arms the flight recorder",
    "SPARK_RAPIDS_TPU_FLIGHT_RECORDER_DIR": "incident bundle directory",
    "SPARK_RAPIDS_TPU_FLIGHT_RECORDER_MAX_BYTES":
        "byte budget over the incident directory",
    "SPARK_RAPIDS_TPU_FLIGHT_RECORDER_HBM_BYTES":
        "arms the HBM-pressure detector at this threshold",
    "SPARK_RAPIDS_TPU_JIT_CACHE": "=0 disables the kernel compile cache",
    "SPARK_RAPIDS_TPU_JIT_CACHE_ENTRIES": "compile-cache entry budget",
    "SPARK_RAPIDS_TPU_JIT_CACHE_BYTES": "compile-cache byte budget",
    "SPARK_RAPIDS_TPU_STAGE_FUSION":
        "1|0|unset=auto: whole-stage fusion engine choice",
    "SPARK_RAPIDS_TPU_CALIB_CACHE":
        "calibration verdict file (empty disables the file layer)",
    "SPARK_RAPIDS_TPU_CALIB_CACHE_TTL": "verdict file TTL seconds",
    "SPARK_RAPIDS_TPU_CALIB_BUDGET_S": "calibration wall budget",
    "SPARK_RAPIDS_TPU_PALLAS_ROWCONV":
        "pin the Pallas row-conversion path on/off",
    "SPARK_RAPIDS_TPU_KUDO_CRC": "=0 disables kudo KCRC trailers",
    "SPARK_RAPIDS_TPU_DIST_MESH":
        "0=process harness, auto=attempt a multi-process mesh (the "
        "port runs the process harness either way)",
    "SPARK_RAPIDS_TPU_DIST_FAULT":
        "inject corrupt|trunc|drop:dst:op or slow:dst:ms on a "
        "shuffle link",
    "SPARK_RAPIDS_TPU_DIST_TRACE_CTX":
        "launcher-seeded trace context for fleet trace stitching",
    "SPARK_RAPIDS_TPU_DIST_DIE":
        "inject a worker death (boot|q5:scan|q5:partials[:rc])",
    "SPARK_RAPIDS_TPU_DIST_RESPAWN":
        "=1 marks a respawned worker incarnation (rejoin + replay)",
    "SPARK_RAPIDS_TPU_FLEET_SPEC_DELAY_S":
        "speculation wall-clock floor for a missing partition",
    "SPARK_RAPIDS_TPU_FLEET_SKEW_RATIO":
        "payload-over-median ratio that re-splits a hot partition",
    "SPARK_RAPIDS_TPU_FLEET_BARRIER_S":
        "elastic-barrier deadline before departed ranks are dropped",
    "SPARK_RAPIDS_TPU_FLEET_RESPAWN":
        "=1: the elastic barrier awaits the full original world "
        "(a dead rank is being respawned)",
    "SPARK_RAPIDS_TPU_INGEST_DIR": "seeded parquet dataset directory",
    "SPARK_RAPIDS_TPU_INGEST_COMPRESSION":
        "codec for seeded parquet datasets",
    "SPARK_RAPIDS_TPU_PLATFORM":
        "the shim's initialize(): cpu puts the JNI door's columns on "
        "the CPU; empty, cuda or gpu on the card",
    "SPARK_RAPIDS_TPU_CPU_DEVICES":
        "the shim's initialize(): how many CPU ranks the mesh entries "
        "(flagship_q5_mesh, flagship_q72_mesh) may run (default 1)",
    "SPARK_RAPIDS_TPU_DISABLE_NATIVE":
        "=1 skips the native C++ runtime (pure-python fallbacks)",
    "SPARK_RAPIDS_TPU_FORCE_DEVICE_SHUFFLE":
        "force the device shuffle path regardless of backend",
    "SPARK_RAPIDS_TPU_FORCE_DEVICE_JOIN":
        "force the device join path regardless of backend",
    "SPARK_RAPIDS_TPU_FORCE_DEVICE_GROUPBY":
        "force the device groupby path regardless of backend",
    "SPARK_RAPIDS_TPU_FORCE_DEVICE_DECIMAL":
        "force the device decimal path regardless of backend",
    "SPARK_RAPIDS_TPU_FORCE_DEVICE_FROM_JSON":
        "force the device from_json path regardless of backend",
    "SPARK_RAPIDS_TPU_FORCE_DEVICE_RAW_MAP":
        "force the device raw-map path regardless of backend",
    "SPARK_RAPIDS_TPU_FORCE_DEVICE_PARSE_URI":
        "force the device parse_uri path regardless of backend",
    "SPARK_RAPIDS_TPU_FORCE_DEVICE_PROTOBUF":
        "force the device protobuf path regardless of backend",
    "SPARK_RAPIDS_TPU_JSON": "JSON engine pin (host|device_scan|...)",
    "SPARK_RAPIDS_TPU_JSON_MIN_ROWS": "device JSON row threshold",
    "SPARK_RAPIDS_TPU_JSON_TOKENIZER_THREADS":
        "tokenizer thread-pool width",
    "SPARK_RAPIDS_TPU_FROM_JSON_DEVICE_MIN":
        "from_json device row threshold",
    "SPARK_RAPIDS_TPU_RAW_MAP_DEVICE_MIN":
        "raw-map device row threshold",
    "SPARK_RAPIDS_TPU_PARSE_URI_DEVICE_MIN":
        "parse_uri device row threshold",
    "SPARK_RAPIDS_TPU_PARSE_URI_CACHE_BYTES":
        "parse_uri compiled-program cache budget",
    "SPARK_RAPIDS_TPU_PROTOBUF_DEVICE_MIN":
        "protobuf device row threshold",
    "SPARK_RAPIDS_TPU_PROTOBUF_REPEAT_CAP":
        "bound on repeated-field expansion",
    "SPARK_RAPIDS_TPU_STOD": "string-to-double engine pin",
    "SPARK_RAPIDS_TPU_STOD_MIN_ROWS": "stod device row threshold",
    "SPARK_RAPIDS_TPU_FTOS": "float-to-string engine pin",
    "SPARK_RAPIDS_TPU_FTOS_MIN_ROWS": "ftos device row threshold",
    "SPARK_RAPIDS_TPU_SHA": "SHA engine pin",
    "SPARK_RAPIDS_TPU_SHA_MIN_ROWS": "SHA device row threshold",
    "SPARK_RAPIDS_TPU_PATH_JOIN_INNER":
        "pin the calibrated inner-join engine "
        "(host_rank|host_hash|device_sort|device_hash)",
    "SPARK_RAPIDS_TPU_SERVER_MAX_CONCURRENCY": "server pool threads",
    "SPARK_RAPIDS_TPU_SERVER_MAX_QUEUE": "server admission queue depth",
    "SPARK_RAPIDS_TPU_SERVER_TENANT_MAX_INFLIGHT":
        "per-tenant in-flight quota",
    "SPARK_RAPIDS_TPU_SERVER_TENANT_MAX_BYTES":
        "per-tenant device-byte quota (0=unlimited)",
    "SPARK_RAPIDS_TPU_SERVER_MAX_REQUEUES":
        "load-shed demotions before a job fails alone",
    "SPARK_RAPIDS_TPU_SERVER_STALL_MS":
        "admission-stall incident threshold (0=off)",
    "SPARK_RAPIDS_TPU_SERVER_FINISHED_KEEP":
        "finished jobs kept pollable before eviction",
    "SPARK_RAPIDS_TPU_SERVER_DEFAULT_DEADLINE_S":
        "default per-query deadline (0=off)",
    "SPARK_RAPIDS_TPU_SERVER_HANG_S":
        "silent-worker hang threshold (0=off)",
    "SPARK_RAPIDS_TPU_SERVER_WATCHDOG_MS": "lifeguard scan cadence",
    "SPARK_RAPIDS_TPU_SERVER_QUARANTINE_FAILURES":
        "deaths before a signature quarantines (0=off)",
    "SPARK_RAPIDS_TPU_SERVER_QUARANTINE_COOLDOWN_S":
        "first quarantine cooldown (doubles, cap 8x)",
    "SPARK_RAPIDS_TPU_SERVER_DRAIN_DEADLINE_S":
        "in-flight budget for graceful drain",
    "SPARK_RAPIDS_TPU_SERVER_DRAIN_DIR": "drain flush directory",
    "SPARK_RAPIDS_TPU_SERVER_SOCKET": "unix-socket front-door path",
    "SPARK_RAPIDS_TPU_SERVER_SOCKET_IDLE_S":
        "per-connection read/idle timeout",
    # -- query profiles (EXPLAIN ANALYZE) --
    "SPARK_RAPIDS_TPU_PROFILE":
        "=1 enables per-query profile assembly (EXPLAIN ANALYZE)",
    "SPARK_RAPIDS_TPU_PROFILE_KEEP":
        "finished query profiles retained in the process ring "
        "(0=off)",
    "SPARK_RAPIDS_TPU_SERVER_PROFILE_KEEP":
        "query profiles the server retains per tenant (0=off)",
    # -- telemetry plane & SLOs --
    "SPARK_RAPIDS_TPU_TIMESERIES":
        "=1 enables the windowed time-series sampler at import",
    "SPARK_RAPIDS_TPU_TIMESERIES_WINDOW_S":
        "time-series window length seconds",
    "SPARK_RAPIDS_TPU_TIMESERIES_CAPACITY":
        "window-ring depth (windows retained)",
    "SPARK_RAPIDS_TPU_SLO":
        "=1 arms per-tenant SLO burn-rate monitoring at import",
    "SPARK_RAPIDS_TPU_SLO_CONFIG":
        "per-tenant SLO spec: inline JSON or @path",
    "SPARK_RAPIDS_TPU_SLO_FAST_S": "fast burn-rate window seconds",
    "SPARK_RAPIDS_TPU_SLO_SLOW_S": "slow burn-rate window seconds",
    "SPARK_RAPIDS_TPU_SLO_BURN_THRESHOLD":
        "burn rate both windows must reach to fire slo_burn",
    # -- time attribution & critical path --
    "SPARK_RAPIDS_TPU_ATTRIBUTION":
        "=1 builds a time-attribution ledger per profiled query",
    "SPARK_RAPIDS_TPU_ATTRIBUTION_TOLERANCE":
        "overcount fraction of wall before conservation is broken",
    # -- tiered spill store & out-of-core operators --
    "SPARK_RAPIDS_TPU_DEVICE_BUDGET_BYTES":
        "build-side device budget past which join/agg run out-of-core "
        "(unset=unlimited, the disabled path)",
    "SPARK_RAPIDS_TPU_SPILL_DIR": "disk-tier kudo spill directory",
    "SPARK_RAPIDS_TPU_SPILL_HOST_LIMIT_BYTES":
        "host-tier byte budget before spills demote to disk",
    "SPARK_RAPIDS_TPU_SPILL_PARTITIONS":
        "out-of-core hash partition count override (power of two)",
    # -- semantic result/subplan cache --
    "SPARK_RAPIDS_TPU_RESULT_CACHE":
        "=1 arms the semantic result/subplan cache (off by default)",
    "SPARK_RAPIDS_TPU_RESULT_CACHE_ENTRIES":
        "result-cache entry budget",
    "SPARK_RAPIDS_TPU_RESULT_CACHE_BYTES":
        "result-cache payload byte budget",
    # -- per-node cardinality & statistics observatory --
    "SPARK_RAPIDS_TPU_STATS":
        "=1 arms the per-node statistics collector (off by default)",
    "SPARK_RAPIDS_TPU_STATS_MISEST_RATIO":
        "actual/estimate divergence ratio that fires the misestimate "
        "sentinel",
    "SPARK_RAPIDS_TPU_STATS_STORE":
        "persistent stats-store file (empty string disables the file "
        "layer)",
    "SPARK_RAPIDS_TPU_STATS_STORE_TTL":
        "seconds before persisted per-node actuals expire",
    "SPARK_RAPIDS_TPU_STATS_SKETCH_ROWS":
        "rows one column sketch pass will look at (head slice)",
}

# env families read with a COMPUTED suffix (pinned_path's
# SPARK_RAPIDS_TPU_PATH_<OP>, ServerConfig.from_env's prefix + name).
# These cover only dynamic prefix-concatenation reads — a fully
# LITERAL env read must be in KNOBS by exact name, or new members of
# the biggest knob families would silently skip both the catalog rule
# and the docs cross-check.
KNOB_WILDCARDS: Tuple[str, ...] = (
    "SPARK_RAPIDS_TPU_PATH_",
    "SPARK_RAPIDS_TPU_SERVER_",
)


def knob_known(name: str) -> bool:
    """Exact catalog membership (literal env reads).  Wildcards are
    deliberately NOT consulted here — they exist for computed-suffix
    reads only (see KnobCatalogRule's 'prefix' path)."""
    return name in KNOBS


# ---------------------------------------------------------- docs check


def _docs(root: str) -> Dict[str, str]:
    out = {}
    ddir = os.path.join(root, "docs")
    try:
        names = sorted(os.listdir(ddir))
    except OSError:
        names = []
    for n in names:
        if n.endswith(".md"):
            p = os.path.join(ddir, n)
            try:
                with open(p, encoding="utf-8") as f:
                    out[os.path.join("docs", n)] = f.read()
            except OSError:
                pass
    rp = os.path.join(root, "README.md")
    if os.path.isfile(rp):
        with open(rp, encoding="utf-8") as f:
            out["README.md"] = f.read()
    return out


def check_docs(root: str) -> List[str]:
    """Catalog <-> docs cross-check (the SRT008 engine).  Returns
    human-readable problem strings (empty = clean):

      * every catalogued metric must appear in docs/observability.md;
      * every catalogued knob must appear in some docs/*.md or
        README.md — either by full name, or (server knobs) as its
        backtick-quoted suffix inside a file that names the
        ``SPARK_RAPIDS_TPU_SERVER_*`` family.
    """
    docs = _docs(root)
    problems: List[str] = []
    obs = docs.get(os.path.join("docs", "observability.md"), "")
    for name in sorted(METRICS):
        if name not in obs:
            problems.append(
                f"metric {name} is in analysis/catalog.py but not in "
                f"docs/observability.md")
    for name in sorted(KNOBS):
        found = any(name in t for t in docs.values())
        if not found and name.startswith("SPARK_RAPIDS_TPU_SERVER_"):
            suffix = "`" + name[len("SPARK_RAPIDS_TPU_SERVER_"):] + "`"
            found = any("SPARK_RAPIDS_TPU_SERVER_" in t and suffix in t
                        for t in docs.values())
        if not found:
            problems.append(
                f"knob {name} is in analysis/catalog.py but not "
                f"documented under docs/ or README.md")
    return problems
