"""Unified observability spine: metrics registry + per-task metrics +
structured event journal + span tracing (the port of the JAX package's
``observability/__init__.py``: the same families, record helpers,
switches and dump formats).

  * ``METRICS``  — process-wide :class:`MetricsRegistry` (counters,
    gauges, histograms; Prometheus text + JSON exposition);
  * ``TASKS``    — :class:`TaskMetricsTable` keyed by the task ids the
    OOM runtime tracks (memory/rmm_spark.py registrations feed it);
  * ``JOURNAL``  — ring-buffered :class:`EventJournal` for OOM
    retry/split/block events, spills, shuffle writes/merges, links,
    and exchange capacity-doublings;
  * ``TRACER``   — :class:`Tracer` of query/stage/task/op spans.

Everything is OFF by default; ``enable()`` (or env
``SPARK_RAPIDS_TPU_METRICS=1`` at import) flips one shared bool that
every hook reads first, so the disabled op path costs a single
attribute check; ``enable_tracing()`` (or ``SPARK_RAPIDS_TPU_TRACE=1``)
does the same for spans.  Instrumented layers (shuffle/kudo.py,
parallel/exchange.py, memory/, distributed/, io/) call the
``record_*`` helpers below; they must never import back into those
layers.

Beside them, each behind its own switch: the query profiler
(``PROFILER``) with time attribution (``ATTRIBUTION``), the flight
recorder (``FLIGHT``, ``trigger_incident``), the timeseries sampler
(``TIMESERIES``), the SLO monitor (``SLO``) and the data-statistics
plane (``STATS``); ``health()`` rolls them up.  The query server
(``server/``) reports through the ``record_server_*`` hooks, and its
completions feed the SLO monitor.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from spark_rapids_tpu_torch.observability import flight_recorder as _fr
from spark_rapids_tpu_torch.observability import slo as _slo
from spark_rapids_tpu_torch.observability import stats as _stats
from spark_rapids_tpu_torch.observability import timeseries as _ts
from spark_rapids_tpu_torch.observability.dumpio import dump_via
from spark_rapids_tpu_torch.observability.journal import EventJournal
from spark_rapids_tpu_torch.observability.profile import (  # noqa: F401
    QueryProfiler, diff_profiles, merge_profiles)
from spark_rapids_tpu_torch.observability.registry import (
    DEFAULT_LATENCY_BUCKETS_NS, MetricsRegistry)
from spark_rapids_tpu_torch.observability.task_metrics import (
    UNATTRIBUTED, TaskMetricsTable)
from spark_rapids_tpu_torch.observability.tracing import (  # noqa: F401
    NOOP_SPAN, SpanContext, Tracer)

# process start anchors: snapshots carry wall-clock + uptime so offline
# consumers (srt-doctor, Perfetto export) can place a dump in real time
# instead of guessing from per-process monotonic stamps
_START_MONO = time.monotonic()
_START_UNIX = time.time()


class _Switch:
    """The one shared enable flag (an object so the journal and task
    table can hold a reference instead of importing this module)."""

    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = False


_SWITCH = _Switch()

METRICS = MetricsRegistry(enabled=False)
JOURNAL = EventJournal(capacity=8192, enabled_ref=_SWITCH,
                       on_drop=lambda n: JOURNAL_DROPPED_TOTAL.inc(n))
TASKS = TaskMetricsTable(enabled_ref=_SWITCH)


def enable() -> None:
    METRICS.enabled = True
    _SWITCH.enabled = True


def disable() -> None:
    METRICS.enabled = False
    _SWITCH.enabled = False


def is_enabled() -> bool:
    return _SWITCH.enabled


def enable_tracing() -> None:
    """Turn on structured span tracing (independent of the metrics
    switch: spans cost more than counters, so a metrics-on run does not
    silently pay for them).  Span->journal and span->histogram fan-out
    additionally requires the metrics switch."""
    TRACER.enabled = True


def disable_tracing() -> None:
    TRACER.enabled = False


def is_tracing_enabled() -> bool:
    return TRACER.enabled


def reset() -> None:
    """Zero all registry series, journal records, task rows, and
    finished spans (the families and instrument handles stay valid).
    Parked OOM block-episode spans are discarded too: a stale span
    ended by a post-reset unblock would otherwise record a pre-reset
    trace_id and a bogus multi-run duration into the fresh ring."""
    global _LAST_ATTRIBUTION
    _LAST_ATTRIBUTION = None
    METRICS.reset()
    JOURNAL.clear()
    TASKS.reset()
    with _BLOCK_SPANS_LOCK:
        _BLOCK_SPANS.clear()
    TRACER.reset()
    PROFILER.reset()
    TIMESERIES.reset()
    SLO.reset()
    STATS.reset()


# --------------------------------------------------------------- instruments
# Named families created once at import; mutators on them are no-ops
# while the registry is disabled.

OP_LATENCY = METRICS.histogram(
    "srt_op_latency_ns", "Host-side op bracket latency (op_range)",
    labels=("op",), buckets=DEFAULT_LATENCY_BUCKETS_NS, max_series=256)
SHUFFLE_WRITE_BYTES = METRICS.counter(
    "srt_shuffle_write_bytes_total", "Kudo shuffle bytes serialized")
SHUFFLE_WRITE_TIME = METRICS.counter(
    "srt_shuffle_write_time_ns_total", "Kudo shuffle write copy time")
SHUFFLE_MERGE_ROWS = METRICS.counter(
    "srt_shuffle_merge_rows_total", "Rows concatenated by kudo merges")
SHUFFLE_MERGE_TIME = METRICS.counter(
    "srt_shuffle_merge_time_ns_total",
    "Kudo merge parse+concat time")
SHUFFLE_LINK_BYTES = METRICS.counter(
    "srt_shuffle_link_bytes_total",
    "Kudo shuffle bytes crossing a process-boundary link, by "
    "direction (send/recv) and peer rank", labels=("direction", "peer"),
    max_series=256)
SHUFFLE_LINK_MSGS = METRICS.counter(
    "srt_shuffle_link_msgs_total",
    "Shuffle messages delivered per link (acked sends / verified "
    "receives)", labels=("direction", "peer"), max_series=256)
SHUFFLE_LINK_RETRIES = METRICS.counter(
    "srt_shuffle_link_retries_total",
    "Shuffle link send attempts retried (NAK from the peer verifier, "
    "reconnects, ack timeouts)", labels=("peer", "reason"),
    max_series=256)
OOM_RETRY = METRICS.counter(
    "srt_oom_retry_total", "GpuRetryOOM/CpuRetryOOM throws",
    labels=("device",))
OOM_SPLIT_RETRY = METRICS.counter(
    "srt_oom_split_retry_total",
    "GpuSplitAndRetryOOM/CpuSplitAndRetryOOM throws", labels=("device",))
THREAD_BLOCKED_TIME = METRICS.counter(
    "srt_thread_blocked_time_ns_total",
    "Time threads spent BLOCKED/BUFN in the OOM state machine")
DEVICE_MEM_ALLOCATED = METRICS.gauge(
    "srt_device_memory_allocated_bytes",
    "Device bytes currently reserved through the adaptor")
HBM_BYTES_IN_USE = METRICS.gauge(
    "srt_hbm_bytes_in_use", "Backend-reported HBM bytes in use",
    labels=("device",), max_series=128)
EXCHANGE_DOUBLINGS = METRICS.counter(
    "srt_exchange_capacity_doublings_total",
    "ICI exchange capacity-retry doublings")
JOURNAL_DROPPED_TOTAL = METRICS.counter(
    "srt_journal_dropped_total",
    "Journal events overwritten by ring wrap-around (counted at emit)")
RETRY_EPISODES = METRICS.counter(
    "srt_retry_episodes_total",
    "Retry-driver episodes that saw at least one failure, by outcome",
    labels=("outcome",))
RETRY_ATTEMPTS = METRICS.counter(
    "srt_retry_attempts_total",
    "Attempts started by retry-driver episodes that saw a failure")
RETRY_SPLITS = METRICS.counter(
    "srt_retry_splits_total",
    "Batch halvings performed by split-and-retry drivers")
RETRY_TIME_LOST = METRICS.counter(
    "srt_retry_time_lost_ns_total",
    "Compute time burned by failed retry-driver attempts")
KUDO_CORRUPT = METRICS.counter(
    "srt_kudo_corrupt_total",
    "Kudo stream integrity events by kind (crc = trailer mismatch, "
    "resync = skip-to-next-magic recovery)",
    labels=("reason",))
KUDO_RESYNC_BYTES = METRICS.counter(
    "srt_kudo_resync_skipped_bytes_total",
    "Bytes skipped while resyncing corrupted kudo streams to the "
    "next magic")
SPILL_BYTES = METRICS.counter(
    "srt_spill_bytes_total",
    "Device bytes spilled through the tiered store (memory/spill.py) "
    "by stage and destination tier",
    labels=("stage", "tier"), max_series=256)
SPILL_RESTORES = METRICS.counter(
    "srt_spill_restores_total",
    "Spilled batches streamed back to the device by stage and source "
    "tier", labels=("stage", "tier"), max_series=256)
SPILL_TIME = METRICS.counter(
    "srt_spill_ns_total",
    "Wall nanoseconds inside spill-store work by stage and direction "
    "(spill = serialize+release, restore = re-acquire+deserialize)",
    labels=("stage", "dir"), max_series=256)
SPILL_CORRUPT = METRICS.counter(
    "srt_spill_corrupt_total",
    "Spill payloads failing CRC/parse on read-back (recomputed = "
    "rebuilt from source, failed = escalated)",
    labels=("outcome",))
JIT_CACHE_HITS = METRICS.counter(
    "srt_jit_cache_hits_total",
    "Kernel compile-cache hits (perf/jit_cache.py)", labels=("kernel",))
JIT_CACHE_MISSES = METRICS.counter(
    "srt_jit_cache_misses_total",
    "Kernel compile-cache misses (each one compiled an executable)",
    labels=("kernel",))
JIT_CACHE_EVICTIONS = METRICS.counter(
    "srt_jit_cache_evictions_total",
    "Kernel compile-cache LRU evictions (entry/byte budget)",
    labels=("kernel",))
JIT_COMPILE_TIME = METRICS.histogram(
    "srt_jit_compile_ns",
    "Kernel lower+compile wall time on compile-cache misses",
    labels=("kernel",), buckets=DEFAULT_LATENCY_BUCKETS_NS,
    max_series=128)
RESULT_CACHE_HITS = METRICS.counter(
    "srt_result_cache_hits_total",
    "Semantic result/subplan cache hits (perf/result_cache.py) by "
    "scope (result/stage/subplan) and tenant (result scope only)",
    labels=("scope", "tenant"), max_series=256)
RESULT_CACHE_MISSES = METRICS.counter(
    "srt_result_cache_misses_total",
    "Semantic result/subplan cache misses by scope and tenant",
    labels=("scope", "tenant"), max_series=256)
RESULT_CACHE_EVICTIONS = METRICS.counter(
    "srt_result_cache_evictions_total",
    "Result-cache LRU evictions (entry/byte budget; SpillStore "
    "pressure demotions are spill metrics, not evictions)",
    labels=("scope",))
RESULT_CACHE_BYTES = METRICS.counter(
    "srt_result_cache_bytes_total",
    "Payload bytes admitted into the result cache by scope",
    labels=("scope",))
RESULT_CACHE_FOLDS = METRICS.counter(
    "srt_result_cache_incremental_folds_total",
    "Arriving batches folded into resident partial-aggregate states "
    "(the O(delta) increments) by query", labels=("query",),
    max_series=128)
KERNEL_PATH = METRICS.counter(
    "srt_kernel_path_total",
    "Executions per op by the kernel path actually taken "
    "(calibrated join / JSON engines)", labels=("op", "path"),
    max_series=128)
STAGE_FUSION = METRICS.counter(
    "srt_stage_fusion_total",
    "Whole-stage executions by stage and outcome (fused = one AOT "
    "executable, unfused = op-by-op walk, compile = a fused "
    "executable was built this run)", labels=("stage", "outcome"),
    max_series=128)
FLEET_EPOCH = METRICS.gauge(
    "srt_fleet_epoch",
    "Elastic-fleet membership epoch on this worker (bumps on every "
    "observed leave/join; stale-epoch frames are fenced)")
FLEET_REBALANCES = METRICS.counter(
    "srt_fleet_rebalances_total",
    "Membership changes that moved shard ownership (peer death -> "
    "survivors inherit)", labels=("change",))
FLEET_DEATHS = METRICS.counter(
    "srt_fleet_deaths_total",
    "Peer ranks observed dead by this worker", labels=("peer",),
    max_series=128)
FLEET_SPECULATIONS = METRICS.counter(
    "srt_fleet_speculations_total",
    "Speculative re-executions of a straggler's partition, by "
    "outcome (won = the speculated copy merged first, lost = the "
    "original arrived first, cancelled = the original arrived "
    "mid-compute and the speculative task was cancelled)",
    labels=("outcome",))
FLEET_RESPLITS = METRICS.counter(
    "srt_fleet_resplits_total",
    "Hot partitions re-split into per-rank sub-partitions for a "
    "second exchange round")
FLEET_STALE_NAKS = METRICS.counter(
    "srt_fleet_stale_naks_total",
    "Elastic frames fenced for carrying a stale membership epoch "
    "(answered E, never merged)", labels=("peer",), max_series=128)
SHUFFLE_DUP_DROPPED = METRICS.counter(
    "srt_shuffle_dup_dropped_total",
    "Duplicate (op, partition) deliveries dropped after the byte "
    "compare (speculation losers, rebalance replays)",
    labels=("peer",), max_series=128)
INCIDENTS_TOTAL = METRICS.counter(
    "srt_incidents_total",
    "Flight-recorder incident bundles written, by trigger kind",
    labels=("trigger",))
INCIDENTS_SUPPRESSED = METRICS.counter(
    "srt_incidents_suppressed_total",
    "Flight-recorder triggers suppressed (rate_limit, byte_budget, "
    "error)", labels=("reason",))
MEMORY_LEAK_EVENTS = METRICS.counter(
    "srt_memory_leak_total",
    "Tasks that finished still holding device memory")
MEMORY_LEAKED_BYTES = METRICS.counter(
    "srt_memory_leaked_bytes_total",
    "Device bytes still held when their task finished")
SPAN_DURATION = METRICS.histogram(
    "srt_span_duration_ns", "Span durations by span kind and name",
    labels=("span_kind", "name"),
    buckets=DEFAULT_LATENCY_BUCKETS_NS, max_series=512)
SPANS_FINISHED = METRICS.counter(
    "srt_spans_finished_total", "Spans finished", labels=("span_kind",))
SERVER_ADMITTED = METRICS.counter(
    "srt_server_admitted_total",
    "Query-server submissions admitted, by tenant", labels=("tenant",),
    max_series=128)
SERVER_REJECTED = METRICS.counter(
    "srt_server_rejected_total",
    "Query-server submissions rejected with a typed ServerOverloaded "
    "(queue_full, tenant_inflight, tenant_bytes, shutdown)",
    labels=("tenant", "reason"), max_series=256)
SERVER_COMPLETED = METRICS.counter(
    "srt_server_completed_total",
    "Query-server jobs finished, by tenant and outcome "
    "(success, failed, cancelled, shed)",
    labels=("tenant", "outcome"), max_series=256)
SERVER_REQUEUED = METRICS.counter(
    "srt_server_requeued_total",
    "Jobs re-queued at lower priority by the load-shedding path "
    "(an attempt OOMed against quota instead of killing neighbors)",
    labels=("tenant", "reason"), max_series=128)
SERVER_QUEUED = METRICS.gauge(
    "srt_server_queued", "Queued (admitted, not yet running) jobs",
    labels=("tenant",), max_series=128)
SERVER_RUNNING = METRICS.gauge(
    "srt_server_running", "Jobs currently executing on pool threads",
    labels=("tenant",), max_series=128)
SERVER_TENANT_BYTES = METRICS.gauge(
    "srt_server_tenant_device_bytes",
    "Device bytes currently attributed to a tenant's live tasks "
    "(memory-ledger fold)", labels=("tenant",), max_series=128)
SERVER_FAIR_DEFICIT = METRICS.gauge(
    "srt_server_fair_share_deficit",
    "Weighted service a tenant is behind the most-served tenant "
    "(scheduler vruntime delta, seconds)", labels=("tenant",),
    max_series=128)
SERVER_QUEUE_WAIT = METRICS.histogram(
    "srt_server_queue_wait_ns",
    "Admission-to-dispatch queue wait per tenant",
    labels=("tenant",), buckets=DEFAULT_LATENCY_BUCKETS_NS,
    max_series=128)
SERVER_WATCHDOG = METRICS.counter(
    "srt_server_watchdog_total",
    "Query-lifeguard watchdog interventions (deadline_cancel, "
    "deadline_expired_queued, hang_release)", labels=("action",))
SERVER_QUARANTINE = METRICS.counter(
    "srt_server_quarantine_total",
    "Poison-query circuit-breaker transitions (opened, reopened, "
    "probe, closed, rejected)", labels=("event",))
SERVER_DRAIN = METRICS.counter(
    "srt_server_drain_total",
    "Query-server graceful-drain lifecycle markers (begin, end)",
    labels=("phase",))
IO_READ_BYTES = METRICS.counter(
    "srt_io_read_bytes_total",
    "Bytes fetched by storage range reads (io/fileio.read_range)")
IO_READ_TIME = METRICS.histogram(
    "srt_io_read_ns", "Storage range-read latency",
    buckets=DEFAULT_LATENCY_BUCKETS_NS)
IO_FILES = METRICS.counter(
    "srt_io_files_total",
    "Parquet files fully decoded by io/parquet_reader")
IO_PAGES = METRICS.counter(
    "srt_io_pages_total", "Parquet pages decoded")
IO_ROWS = METRICS.counter(
    "srt_io_rows_total", "Rows materialized from parquet files")
IO_DECODE_TIME = METRICS.counter(
    "srt_io_decode_ns_total",
    "Wall time decoding parquet pages into device columns")
LOCKDEP_CYCLES = METRICS.counter(
    "srt_lockdep_cycles_total",
    "Lock-acquisition-order cycles detected by the lockdep runtime "
    "(ABBA deadlock potential — the deadlock need not fire)")
LOCKDEP_BLOCKING = METRICS.counter(
    "srt_lockdep_blocking_total",
    "Instrumented locks observed held across a known blocking call "
    "(socket send/recv, storage range read)", labels=("op",))
PROFILE_QUERIES = METRICS.counter(
    "srt_profile_queries_total",
    "Per-query profiles assembled at query end (EXPLAIN ANALYZE "
    "artifacts), by tenant", labels=("tenant",), max_series=128)
PROFILE_ASSEMBLY = METRICS.histogram(
    "srt_profile_assembly_ns",
    "Wall time spent assembling one query profile at query end "
    "(the cost the profiling switch buys)",
    buckets=DEFAULT_LATENCY_BUCKETS_NS)
PROFILE_DROPPED = METRICS.counter(
    "srt_profile_dropped_total",
    "Profile sessions dropped instead of assembled (nested begin, "
    "stage record with no session, assembly error)",
    labels=("reason",))
TIMESERIES_WINDOWS = METRICS.counter(
    "srt_timeseries_windows_total",
    "Telemetry windows appended to the timeseries ring")
TIMESERIES_TICK = METRICS.histogram(
    "srt_timeseries_tick_ns",
    "Wall time of one timeseries tick (registry snapshot + delta "
    "fold) — the cost the sampler switch buys",
    buckets=DEFAULT_LATENCY_BUCKETS_NS)
TIMESERIES_MERGE = METRICS.counter(
    "srt_timeseries_merge_total",
    "Per-rank timeseries snapshots offered to the fleet merger, by "
    "outcome (merged, dup = no new windows, stale_epoch = fenced)",
    labels=("outcome",))
MONITOR_SAMPLE_AGE = METRICS.gauge(
    "srt_monitor_last_sample_age_s",
    "Seconds since the Monitor thread last sampled — computed at "
    "exposition time, so a dead sampler shows a growing age instead "
    "of a frozen healthy-looking gauge")
SLO_BURN_RATE = METRICS.gauge(
    "srt_slo_burn_rate",
    "Per-tenant error-budget burn rate (bad fraction / budget) over "
    "the fast and slow windows; 1.0 = spending exactly as "
    "provisioned", labels=("tenant", "window"), max_series=256)
SLO_ATTAINMENT = METRICS.gauge(
    "srt_slo_attainment_ratio",
    "Per-tenant lifetime fraction of budget-consuming completions "
    "that met the SLO (success within the latency target)",
    labels=("tenant",), max_series=128)
SLO_BREACHES = METRICS.counter(
    "srt_slo_breaches_total",
    "slo_burn alerts fired (both burn windows over threshold, "
    "cooldown-filtered), by tenant", labels=("tenant",),
    max_series=128)
SHUFFLE_WIRE_TIME = METRICS.counter(
    "srt_shuffle_wire_ns_total",
    "Query-thread wall spent serializing and sending shuffle frames "
    "(the wire half of an exchange; peers' ACKs included)")
SHUFFLE_WAIT_TIME = METRICS.counter(
    "srt_shuffle_wait_ns_total",
    "Query-thread wall spent idle waiting on peers' shuffle frames, "
    "by cause (inbox = ordinary exchange wait, speculation = gather "
    "idle attributable to parts with a live speculation decision)",
    labels=("cause",))
ATTRIBUTION_TIME = METRICS.counter(
    "srt_attribution_ns_total",
    "Per-query wall nanoseconds classified by attribution bucket "
    "(queue_wait/compile/compute_*/shuffle_*/oom_blocked/retry_lost/"
    "other), by tenant — fed at query end when attribution is armed",
    labels=("tenant", "bucket"), max_series=512)
ATTRIBUTION_QUERIES = METRICS.counter(
    "srt_attribution_queries_total",
    "Attribution ledgers built at query end, by conservation verdict "
    "(true = buckets summed to the wall within tolerance)",
    labels=("conserved",))
STATS_OBSERVATIONS = METRICS.counter(
    "srt_stats_observations_total",
    "Per-node row-count observations folded into the data-statistics "
    "plane (observability/stats.py), by stage", labels=("stage",),
    max_series=128)
STATS_MISESTIMATE = METRICS.counter(
    "srt_stats_misestimate_total",
    "Cardinality misestimates detected (actual vs estimate divergence "
    "past SPARK_RAPIDS_TPU_STATS_MISEST_RATIO), by stage and plan "
    "node", labels=("stage", "node"), max_series=512)
STATS_ROWS = METRICS.counter(
    "srt_stats_rows_total",
    "Result rows returned to tenants by completed server jobs (the "
    "rows/s feed behind srt-top)", labels=("tenant",), max_series=128)
STATS_SKETCH_NS = METRICS.histogram(
    "srt_stats_sketch_ns",
    "Wall time of one column sketch pass (KMV + heavy hitters + "
    "histogram; memoized per stage/input/ingest-epoch)",
    buckets=DEFAULT_LATENCY_BUCKETS_NS)


# ------------------------------------------------------------------ tracer
# Built AFTER the instrument families: the finish hook folds span
# durations into SPAN_DURATION and appends span records to the journal
# so one JSONL dump carries events AND spans on one timeline.


def _on_span_finish(rec: dict) -> None:
    # flight-recorder feed first (independent switch: the straggler
    # detector watches stage spans whether or not metrics are on)
    if FLIGHT.enabled:
        FLIGHT.observe_span(rec)
    if not _SWITCH.enabled:
        return
    SPAN_DURATION.observe(rec["dur_ns"],
                          labels=(rec["span_kind"], rec["name"]))
    SPANS_FINISHED.inc(labels=(rec["span_kind"],))
    # the span record keeps its own start t_ns (emit's now-stamp is
    # overridden by the explicit field)
    JOURNAL.emit("span", **{k: v for k, v in rec.items() if k != "kind"})


TRACER = Tracer(capacity=65536,
                task_lookup=lambda: TASKS.tasks_for(),
                on_finish=_on_span_finish)


# ------------------------------------------------------- query profiler
# EXPLAIN ANALYZE for every query: per-query
# artifacts assembled at query end from the rings above.  Independent
# switch with the tracer's noop discipline — profiling off costs one
# attribute read per hook.


def _on_profile(profile: dict, assembly_ns: int) -> None:
    # attribution rides the profile-end hook (its own switch): the
    # ledger lands INSIDE the artifact, so retention, bundles and
    # srt-explain all carry it without new plumbing
    if ATTRIBUTION.enabled:
        _note_attribution(profile)
    if not _SWITCH.enabled:
        return
    PROFILE_QUERIES.inc(labels=(profile.get("tenant") or "-",))
    PROFILE_ASSEMBLY.observe(assembly_ns)
    JOURNAL.emit("query_profile", query_id=profile.get("query_id"),
                 tenant=profile.get("tenant"),
                 query=profile.get("query"),
                 wall_ns=profile.get("wall_ns"),
                 stages=len(profile.get("stages") or ()),
                 hot_stage=profile.get("hot_stage"))


def _profile_keep() -> int:
    try:
        return int(os.environ.get("SPARK_RAPIDS_TPU_PROFILE_KEEP", "")
                   or 16)
    except ValueError:
        return 16


PROFILER = QueryProfiler(
    journal=JOURNAL, tasks=TASKS, tracer=TRACER, registry=METRICS,
    keep=_profile_keep(), on_profile=_on_profile,
    on_drop=lambda reason: PROFILE_DROPPED.inc(labels=(reason,)))


def enable_profiling() -> None:
    """Turn on per-query profile assembly (independent of the metrics
    and tracing switches; profile counters additionally require the
    metrics switch, trace-scoped span stats require tracing)."""
    PROFILER.enabled = True


def disable_profiling() -> None:
    PROFILER.enabled = False


def is_profiling_enabled() -> bool:
    return PROFILER.enabled


def cache_hit_profile(tenant: str, query: str, query_id: str,
                      lookup_ns: int) -> Optional[dict]:
    """Assemble + retain the profile artifact for a warm result-cache
    hit.  A hit never executes, so there is no session to
    fold — the artifact is the lookup itself: wall == cache.lookup_ns,
    no stages, a ``cache`` section with the one hit.  Returns None
    when profiling is off."""
    if not PROFILER.enabled:
        return None
    from spark_rapids_tpu_torch.observability.profile import PROFILE_VERSION
    profile = {
        "profile_version": PROFILE_VERSION,
        "query_id": query_id,
        "tenant": tenant,
        "query": query,
        "rank": 0,
        "world": 1,
        "trace_id": None,
        "t_unix_ms": int(time.time() * 1000),
        "wall_ns": int(lookup_ns),
        "queue_wait_ns": 0,
        "stages": [],
        "hot_stage": None,
        "cache": {"hits": 1, "misses": 0, "puts": 0, "evictions": 0,
                  "folds": 0, "lookup_ns": int(lookup_ns),
                  "bytes": 0},
    }
    return PROFILER.note_external(profile)


# ----------------------------------------------------- time attribution
# Where did the time go: at profile end the wall is
# classified into exhaustive non-overlapping buckets with a
# conservation contract.  Independent switch; with it off the only
# cost is ONE attribute read inside the profile-end hook (and nothing
# at all when profiling itself is off).

ATTRIBUTION = _Switch()
_LAST_ATTRIBUTION: Optional[dict] = None


def _attribution_tolerance() -> float:
    try:
        return float(os.environ.get(
            "SPARK_RAPIDS_TPU_ATTRIBUTION_TOLERANCE", "") or 0.25)
    except ValueError:
        return 0.25


def _note_attribution(profile: dict) -> None:
    global _LAST_ATTRIBUTION
    try:
        from spark_rapids_tpu_torch.observability.attribution import (
            attribute_profile)
        ledger = attribute_profile(
            profile, tolerance=_attribution_tolerance())
    except Exception:
        return  # a ledger must never fail the query it describes
    profile["attribution"] = ledger
    _LAST_ATTRIBUTION = ledger
    if not _SWITCH.enabled:
        return
    tenant = ledger.get("tenant") or "-"
    for bucket, ns in ledger.get("buckets", {}).items():
        if ns > 0:
            ATTRIBUTION_TIME.inc(int(ns), labels=(tenant, bucket))
    ATTRIBUTION_QUERIES.inc(
        labels=("true" if ledger.get("conserved") else "false",))


def enable_attribution() -> None:
    """Turn on per-query time-attribution ledgers (rides the profiler:
    arming attribution without profiling yields no ledgers; counters
    additionally require the metrics switch)."""
    ATTRIBUTION.enabled = True


def disable_attribution() -> None:
    ATTRIBUTION.enabled = False


def is_attribution_enabled() -> bool:
    return ATTRIBUTION.enabled


def attribution_last() -> Optional[dict]:
    """The most recently built ledger (what a flight-recorder bundle
    freezes as ``attribution.json``)."""
    return _LAST_ATTRIBUTION


# -------------------------------------------------------- flight recorder
# The black box: anomaly detectors fed by the
# record helpers below, freezing the rings above into incident bundles.
# Independent switch — always-on capture is cheap, bundle dumps are
# not, so the recorder arms separately from metrics/tracing.

FLIGHT = _fr.FlightRecorder.from_env()


def enable_flight_recorder(out_dir: Optional[str] = None,
                           max_bytes: Optional[int] = None,
                           min_interval_s: Optional[float] = None
                           ) -> None:
    FLIGHT.configure(out_dir=out_dir, max_bytes=max_bytes,
                     min_interval_s=min_interval_s)
    FLIGHT.enabled = True


def disable_flight_recorder() -> None:
    FLIGHT.enabled = False


def is_flight_recorder_enabled() -> bool:
    return FLIGHT.enabled


def trigger_incident(kind: str, cause: Optional[BaseException] = None,
                     severity: str = "error", **detail) -> Optional[str]:
    """Explicit incident trigger for the instrumented layers
    (RetryExhausted in robustness/retry.py, KudoCorruptException in
    shuffle/kudo.py, task-end leaks in the OOM state machine).  One
    attribute read when the recorder is off."""
    if not FLIGHT.enabled:
        return None
    # bundle dumps take real wall time on the calling thread — beat
    # before and after so the hung-worker watchdog never mistakes a
    # worker busy FREEZING an incident for the incident itself
    hook = _HEARTBEAT_HOOK
    if hook is not None:
        hook(f"incident:{kind}")
    try:
        return FLIGHT.trigger(kind, cause=cause, severity=severity,
                              **detail)
    finally:
        if hook is not None:
            hook(f"incident:{kind}")


# ------------------------------------------------------- telemetry plane
# Windowed time-series + per-tenant SLO burn monitoring.
# Independent switches with the usual noop discipline:
# the Monitor thread calls record_monitor_sample() every period, and
# with both switches off that costs two attribute reads.


def _on_timeseries_tick(elapsed_ns: int) -> None:
    if not _SWITCH.enabled:
        return
    TIMESERIES_WINDOWS.inc()
    TIMESERIES_TICK.observe(elapsed_ns)


def _env_num(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


TIMESERIES = _ts.TimeseriesSampler(
    METRICS,
    window_s=_env_num("SPARK_RAPIDS_TPU_TIMESERIES_WINDOW_S", 5.0),
    capacity=int(_env_num("SPARK_RAPIDS_TPU_TIMESERIES_CAPACITY", 120)),
    on_tick=_on_timeseries_tick)


def _on_slo_burn(tenant: str, alert: dict) -> None:
    """One multi-window burn alert: journal + breach counter, then the
    slo_burn incident bundle freezing the ring tail + the offending
    tenant's SLO snapshot next to the usual evidence (the last
    profile rides along via the recorder's own bundle assembly)."""
    detail = {k: v for k, v in alert.items() if k != "tenant"}
    if _SWITCH.enabled:
        SLO_BREACHES.inc(labels=(tenant,))
        JOURNAL.emit("slo_burn", tenant=tenant, **detail)
    trigger_incident(
        "slo_burn", severity="error", tenant=tenant, **detail,
        tenant_slo=SLO.status().get(tenant, {}),
        timeseries_tail=TIMESERIES.windows(4))


try:
    SLO = _slo.SloMonitor.from_env(on_burn=_on_slo_burn)
except Exception as _e:  # malformed SLO_CONFIG: warn loudly, run bare
    import sys as _sys
    print(f"spark_rapids_tpu_torch: ignoring bad SPARK_RAPIDS_TPU_SLO_* "
          f"config: {_e}", file=_sys.stderr)
    SLO = _slo.SloMonitor(on_burn=_on_slo_burn)

# last Monitor sample, monotonic — the liveness source behind
# srt_monitor_last_sample_age_s (set at exposition, never by the
# sampler itself: a dead thread must show a GROWING age)
_LAST_MONITOR_SAMPLE: Optional[float] = None


def enable_timeseries(window_s: Optional[float] = None,
                      capacity: Optional[int] = None) -> None:
    """Arm the windowed sampler (independent switch; pair with the
    metrics switch — with the registry disabled every delta is
    zero)."""
    if window_s is not None:
        TIMESERIES.window_s = float(window_s)
    if capacity is not None:
        from collections import deque as _dq
        TIMESERIES.capacity = int(capacity)
        TIMESERIES._windows = _dq(TIMESERIES._windows,
                                  maxlen=int(capacity))
    TIMESERIES.enabled = True


def disable_timeseries() -> None:
    TIMESERIES.enabled = False


def is_timeseries_enabled() -> bool:
    return TIMESERIES.enabled


def enable_slo() -> None:
    SLO.enabled = True


def disable_slo() -> None:
    SLO.enabled = False


def is_slo_enabled() -> bool:
    return SLO.enabled


def _apply_slo_gauges() -> None:
    if not _SWITCH.enabled:
        return
    for tenant, st in SLO.status().items():
        SLO_BURN_RATE.set(st["burn_fast"], labels=(tenant, "fast"))
        SLO_BURN_RATE.set(st["burn_slow"], labels=(tenant, "slow"))
        SLO_ATTAINMENT.set(st["attainment"], labels=(tenant,))


# --------------------------------------------------------- data statistics
# The cardinality & statistics observatory: per-node
# observed row counts tapped out of fused stages, column sketches, and
# the est-vs-actual misestimate sentinel.  Independent switch with the
# usual discipline — stats off costs the compiler ONE attribute read
# (``STATS.enabled``) per stage run.


def _on_stats_observation(stage: str, nodes: list,
                          misestimates: list) -> None:
    if not _SWITCH.enabled:
        return
    STATS_OBSERVATIONS.inc(len(nodes), labels=(stage,))
    JOURNAL.emit("node_stats", stage=stage, nodes=len(nodes),
                 misestimates=len(misestimates),
                 thread=threading.get_ident())


def _on_stats_misestimate(stage: str, node: str, est: int, actual: int,
                          ratio: float, first: bool) -> None:
    """One detected cardinality misestimate: metric + journal on every
    detection, the flight-recorder bundle only on the FIRST detection
    of a (stage, node) pair — a misestimate repeats on every run of
    the stage and one bundle is the evidence, fifty are noise."""
    if _SWITCH.enabled:
        STATS_MISESTIMATE.inc(labels=(stage, node))
        JOURNAL.emit("cardinality_misestimate", stage=stage, node=node,
                     est=int(est), actual=int(actual),
                     ratio=float(ratio),
                     thread=threading.get_ident())
    if first:
        trigger_incident(
            "cardinality_misestimate", severity="warn", stage=stage,
            node=node, est=int(est), actual=int(actual),
            ratio=float(ratio), stage_stats=STATS.last(stage))


def _on_stats_sketch(ns: int) -> None:
    if not _SWITCH.enabled:
        return
    STATS_SKETCH_NS.observe(int(ns))


STATS = _stats.StatsCollector(
    on_observation=_on_stats_observation,
    on_misestimate=_on_stats_misestimate,
    on_sketch=_on_stats_sketch)


def enable_stats() -> None:
    """Arm the data-statistics plane (independent switch; the
    srt_stats_* counters additionally require the metrics switch)."""
    STATS.enabled = True


def disable_stats() -> None:
    STATS.enabled = False


def is_stats_enabled() -> bool:
    return STATS.enabled


def record_tenant_rows(tenant: str, rows: int) -> None:
    """Server job-completion hook: result rows delivered to one
    tenant (the rows/s column in srt-top)."""
    if not _SWITCH.enabled:
        return
    STATS_ROWS.inc(int(rows), labels=(str(tenant) or "-",))


def evaluate_slo(now: Optional[float] = None) -> list:
    """Force one burn-rate evaluation + gauge refresh; returns the
    alerts that fired (each already routed through the slo_burn
    incident path).  Tests and the smoke drive this with synthetic
    clocks; production rides record_monitor_sample."""
    fired = SLO.evaluate(now)
    _apply_slo_gauges()
    return fired


def record_monitor_sample(now: Optional[float] = None) -> None:
    """utils/telemetry.Monitor loop hook: stamps sampler liveness and
    drives the telemetry plane at window granularity (maybe_tick /
    maybe_evaluate are no-ops until a window has elapsed)."""
    global _LAST_MONITOR_SAMPLE
    _LAST_MONITOR_SAMPLE = time.monotonic() if now is None else now
    if TIMESERIES.enabled:
        TIMESERIES.maybe_tick()
    if SLO.enabled:
        fired = SLO.maybe_evaluate()
        if fired is not None:
            _apply_slo_gauges()


def _refresh_liveness(now: Optional[float] = None) -> None:
    """Exposition-time liveness: every snapshot/health/expose path
    recomputes the sampler age so a stalled Monitor thread cannot
    freeze a healthy-looking value into dumps and bundles."""
    if not _SWITCH.enabled or _LAST_MONITOR_SAMPLE is None:
        return
    now = time.monotonic() if now is None else now
    MONITOR_SAMPLE_AGE.set(
        round(max(0.0, now - _LAST_MONITOR_SAMPLE), 3))


def timeseries_snapshot(rank: int = 0, epoch: int = 0) -> dict:
    """One publishable per-rank snapshot: the ring dump tagged with
    fleet identity (+ the SLO status when armed) — the unit workers
    send over CTRL frames / dump to ``timeseries_rank{r}.json`` and
    ``FleetTimeseries.offer`` merges."""
    snap = TIMESERIES.snapshot()
    snap["rank"] = int(rank)
    snap["epoch"] = int(epoch)
    if SLO.enabled:
        snap["slo"] = SLO.status()
    return snap


def record_timeseries_merge(outcome: str, rank: int) -> None:
    """Rank 0's fleet-merge hook: one offered per-rank snapshot, by
    outcome ('merged', 'dup', 'stale_epoch')."""
    if not _SWITCH.enabled:
        return
    TIMESERIES_MERGE.inc(labels=(outcome,))
    JOURNAL.emit("timeseries_merge", outcome=outcome, rank=int(rank),
                 thread=threading.get_ident())


# ------------------------------------------------------------ record helpers
# Called from the instrumented layers.  Each starts with the switch
# check so a disabled run pays one attribute read.

# hung-worker heartbeat seam: the lifeguard (robustness/lifeguard.py)
# installs a callback here so every finished op bracket counts as a
# sign of life.  A separate hook — NOT the metrics switch — because
# hang detection must work with metrics off, and the layering rule
# forbids this package importing robustness.
_HEARTBEAT_HOOK: Optional[Callable[[str], None]] = None


def set_heartbeat_hook(fn: Optional[Callable[[str], None]]) -> None:
    global _HEARTBEAT_HOOK
    _HEARTBEAT_HOOK = fn


def op_hooks_idle() -> bool:
    """True when `record_op` would do nothing: no heartbeat hook and
    the metrics switch off."""
    return _HEARTBEAT_HOOK is None and not _SWITCH.enabled


def record_op(op: str, dur_ns: int) -> None:
    """utils/profiler.op_range close hook."""
    hook = _HEARTBEAT_HOOK
    if hook is not None:
        hook(op)
    if not _SWITCH.enabled:
        return
    OP_LATENCY.observe(dur_ns, labels=(op,))
    TASKS.note_op(op, dur_ns)


def record_shuffle_write(num_bytes: int, dur_ns: int, rows: int) -> None:
    if not _SWITCH.enabled:
        return
    SHUFFLE_WRITE_BYTES.inc(num_bytes)
    SHUFFLE_WRITE_TIME.inc(dur_ns)
    TASKS.note_shuffle_write(num_bytes, dur_ns)
    JOURNAL.emit("shuffle_write", bytes=num_bytes, rows=rows,
                 dur_ns=dur_ns, thread=threading.get_ident())


def record_shuffle_merge(rows: int, parse_ns: int, concat_ns: int,
                         tables: int) -> None:
    if not _SWITCH.enabled:
        return
    SHUFFLE_MERGE_ROWS.inc(rows)
    SHUFFLE_MERGE_TIME.inc(parse_ns + concat_ns)
    TASKS.note_shuffle_merge(rows, parse_ns + concat_ns)
    JOURNAL.emit("shuffle_merge", rows=rows, tables=tables,
                 parse_ns=parse_ns, concat_ns=concat_ns,
                 thread=threading.get_ident())


def record_shuffle_link(direction: str, peer: str, nbytes: int,
                        op_id: int = 0) -> None:
    """Distributed shuffle link hook (distributed/transport.py):
    ``direction`` is 'send' (payload acked by the peer) or 'recv'
    (payload received AND CRC-verified)."""
    if not _SWITCH.enabled:
        return
    peer = str(peer)
    SHUFFLE_LINK_BYTES.inc(nbytes, labels=(direction, peer))
    SHUFFLE_LINK_MSGS.inc(labels=(direction, peer))
    JOURNAL.emit("shuffle_link", direction=direction, peer=peer,
                 bytes=nbytes, op=op_id,
                 thread=threading.get_ident())


def record_shuffle_link_retry(peer: str, reason: str) -> None:
    """One failed shuffle-link send attempt about to be retried
    (reason: 'nak' = peer's CRC verifier refused the payload,
    'link' = connect/send/ack transport error)."""
    if not _SWITCH.enabled:
        return
    peer = str(peer)
    SHUFFLE_LINK_RETRIES.inc(labels=(peer, reason))
    JOURNAL.emit("shuffle_link_retry", peer=peer, reason=reason,
                 thread=threading.get_ident())


def record_shuffle_wire(op_id: int, wire_ns: int) -> None:
    """The wire half of one exchange on the query thread: serialize +
    concurrent per-peer sends, ACKs included (distributed/service.py).
    Thread-stamped so the per-query profile claims it."""
    if not _SWITCH.enabled:
        return
    wire_ns = int(wire_ns)
    SHUFFLE_WIRE_TIME.inc(wire_ns)
    JOURNAL.emit("shuffle_wire", op=int(op_id), wire_ns=wire_ns,
                 thread=threading.get_ident())


def record_shuffle_wait(op_id: int, wait_ns: int,
                        spec_ns: int = 0) -> None:
    """The idle half of one exchange/gather: blocked on peers' frames
    (``wait_ns``), with the slice attributable to parts under a live
    speculation decision split out as ``spec_ns`` — a straggler's
    story, not the wire's."""
    if not _SWITCH.enabled:
        return
    wait_ns, spec_ns = int(wait_ns), int(spec_ns)
    if wait_ns > 0:
        SHUFFLE_WAIT_TIME.inc(wait_ns, labels=("inbox",))
    if spec_ns > 0:
        SHUFFLE_WAIT_TIME.inc(spec_ns, labels=("speculation",))
    JOURNAL.emit("shuffle_wait", op=int(op_id), wait_ns=wait_ns,
                 spec_ns=spec_ns, thread=threading.get_ident())


def set_fleet_epoch(epoch: int) -> None:
    """Elastic-fleet membership epoch on this worker
    (robustness/fleet.py)."""
    if not _SWITCH.enabled:
        return
    FLEET_EPOCH.set(int(epoch))


def record_fleet_membership(change: str, *, dead, epoch: int, live,
                            moved=None, joined=None) -> None:
    """One membership transition: ``change`` 'death' (ranks left,
    shards moved to survivors) or 'join' (a worker (re)joined the
    live set).  The journal event is the rebalance evidence the
    elastic-smoke gate and srt-doctor read."""
    if not _SWITCH.enabled:
        return
    FLEET_EPOCH.set(int(epoch))
    if moved:
        FLEET_REBALANCES.inc(labels=(change,))
    for r in dead or ():
        FLEET_DEATHS.inc(labels=(str(r),))
    JOURNAL.emit("fleet_membership", change=change,
                 dead=[int(r) for r in dead or ()],
                 joined=joined, epoch=int(epoch),
                 live=[int(r) for r in live],
                 moved={str(k): int(v)
                        for k, v in (moved or {}).items()},
                 thread=threading.get_ident())


def record_fleet_speculation(op_id: int, part: int, owner: int,
                             by: int, outcome: str,
                             evidence: Optional[dict] = None) -> None:
    """One speculative re-execution decision resolved: ``outcome`` in
    {'won', 'lost', 'cancelled'} — won means the speculated copy
    merged first (the straggling owner's late frames dedup-drop),
    lost/cancelled mean the original beat the speculation."""
    if not _SWITCH.enabled:
        return
    FLEET_SPECULATIONS.inc(labels=(outcome,))
    JOURNAL.emit("fleet_speculation", op=int(op_id), part=int(part),
                 owner=int(owner), by=int(by), outcome=outcome,
                 evidence=evidence or {},
                 thread=threading.get_ident())


def record_fleet_resplit(op_id: int, part: int, nsub: int,
                         nbytes: int,
                         evidence: Optional[dict] = None) -> None:
    """A hot partition re-split into ``nsub`` sub-partitions for a
    second exchange round (skew evidence from the live link-byte
    deltas rides in ``evidence``)."""
    if not _SWITCH.enabled:
        return
    FLEET_RESPLITS.inc()
    JOURNAL.emit("fleet_resplit", op=int(op_id), part=int(part),
                 nsub=int(nsub), bytes=int(nbytes),
                 evidence=evidence or {},
                 thread=threading.get_ident())


def record_fleet_stale_nak(peer, frame_epoch: int,
                           local_epoch: int) -> None:
    """An elastic frame arrived carrying an epoch older than this
    worker's view: fenced with the E verdict, never merged."""
    if not _SWITCH.enabled:
        return
    FLEET_STALE_NAKS.inc(labels=(str(peer),))
    JOURNAL.emit("fleet_stale_nak", peer=str(peer),
                 frame_epoch=int(frame_epoch),
                 local_epoch=int(local_epoch),
                 thread=threading.get_ident())


def record_shuffle_dup_dropped(peer, op_id: int, part: int,
                               identical: Optional[bool]) -> None:
    """A duplicate (op, partition) delivery was dropped: the first
    verified copy won; this one (a speculation loser or a rebalance
    replay) is byte-compared and discarded.  ``identical=False`` is
    recorded loudly — deterministic recomputes must produce the same
    bytes, so a mismatch is corruption-grade evidence.
    ``identical=None`` means the compare was inapplicable: the
    winning copy was stitched from re-split sub-frames, so the same
    rows carry different framing bytes."""
    if not _SWITCH.enabled:
        return
    peer = str(peer)
    SHUFFLE_DUP_DROPPED.inc(labels=(peer,))
    JOURNAL.emit("shuffle_dup_dropped", peer=peer, op=int(op_id),
                 part=int(part),
                 identical=(None if identical is None
                            else bool(identical)),
                 thread=threading.get_ident())


# open OOM block-episode spans keyed by thread id (blocked/unblocked
# arrive as separate hook calls on the same thread; attach=False keeps
# them off the context stack so an out-of-order unblock cannot corrupt
# span nesting)
_BLOCK_SPANS: dict = {}
_BLOCK_SPANS_LOCK = threading.Lock()


def record_oom_event(kind: str, *, thread_id: int,
                     task_id: Optional[int], is_cpu: bool = False,
                     injected: bool = False, **extra) -> None:
    """OOM state machine hook: kind in {'oom_retry', 'oom_split_retry',
    'thread_blocked', 'thread_unblocked', 'thread_removed'}."""
    # the unblock/removed kinds must reach the span layer even with
    # tracing off: a block-episode span opened while tracing was on
    # would otherwise leak open in _BLOCK_SPANS forever
    if TRACER.enabled or kind in ("thread_unblocked", "thread_removed"):
        _record_oom_span(kind, thread_id, task_id, is_cpu, injected)
    if not _SWITCH.enabled:
        return
    device = "cpu" if is_cpu else "device"
    if kind == "oom_retry":
        OOM_RETRY.inc(labels=(device,))
    elif kind == "oom_split_retry":
        OOM_SPLIT_RETRY.inc(labels=(device,))
    elif kind == "thread_unblocked":
        THREAD_BLOCKED_TIME.inc(extra.get("blocked_ns", 0))
    TASKS.note_event(thread_id)
    JOURNAL.emit(kind, thread=thread_id,
                 task=task_id if task_id is not None else UNATTRIBUTED,
                 injected=injected, device=device, **extra)


def _record_oom_span(kind: str, thread_id: int, task_id, is_cpu: bool,
                     injected: bool) -> None:
    """Memory-runtime span emission: retry/split throws become instant
    spans; a blocked->unblocked episode becomes one span covering the
    whole wait."""
    attrs = {"device": "cpu" if is_cpu else "device",
             "injected": injected}
    if task_id is not None:
        attrs["task_id"] = task_id
    if kind in ("oom_retry", "oom_split_retry"):
        TRACER.start_span(kind, kind="oom", attrs=attrs,
                          attach=False).end()
    elif kind == "thread_blocked":
        span = TRACER.start_span("oom_blocked", kind="oom", attrs=attrs,
                                 attach=False)
        with _BLOCK_SPANS_LOCK:
            _BLOCK_SPANS[thread_id] = span
    elif kind in ("thread_unblocked", "thread_removed"):
        with _BLOCK_SPANS_LOCK:
            span = _BLOCK_SPANS.pop(thread_id, None)
        if span is not None:
            span.end()


def record_retry_episode(name: str, *, attempts: int, retries: int,
                         splits: int, max_split_depth: int,
                         lost_ns: int, outcome: str,
                         errors=()) -> None:
    """Retry-driver episode hook (robustness/retry.py) — called only
    for episodes that saw at least one failure."""
    if FLIGHT.enabled:
        FLIGHT.observe_retry_episode(name, outcome)
    if not _SWITCH.enabled:
        return
    RETRY_EPISODES.inc(labels=(outcome,))
    RETRY_ATTEMPTS.inc(attempts)
    RETRY_SPLITS.inc(splits)
    RETRY_TIME_LOST.inc(lost_ns)
    JOURNAL.emit("retry_episode", name=name, attempts=attempts,
                 retries=retries, splits=splits,
                 max_split_depth=max_split_depth, lost_ns=lost_ns,
                 outcome=outcome, errors=list(errors)[:16],
                 thread=threading.get_ident())


def record_kudo_corruption(reason: str, *, skipped_bytes: int = 0,
                           detail: str = "") -> None:
    """Kudo stream integrity hook: reason 'crc' for a trailer
    mismatch at the verify site, 'resync' for a skip-to-next-magic
    recovery (skipped_bytes > 0)."""
    if not _SWITCH.enabled:
        return
    KUDO_CORRUPT.inc(labels=(reason,))
    if skipped_bytes:
        KUDO_RESYNC_BYTES.inc(skipped_bytes)
    JOURNAL.emit("kudo_corrupt", reason=reason,
                 skipped_bytes=skipped_bytes, detail=detail[:200],
                 thread=threading.get_ident())


def record_spill(*, stage: str, tier: str, nbytes: int, ns: int,
                 task=None, name: str = "", generation: int = 0) -> None:
    """Tiered-store spill hook (memory/spill.py): one registered
    batch moved DOWN a tier (device->host or host->disk), freeing
    ``nbytes`` of the source tier."""
    if not _SWITCH.enabled:
        return
    st = stage or "-"
    SPILL_BYTES.inc(nbytes, labels=(st, tier))
    SPILL_TIME.inc(ns, labels=(st, "spill"))
    JOURNAL.emit("spill", stage=st, tier=tier, bytes=nbytes, ns=ns,
                 task=task, name=name, generation=generation,
                 thread=threading.get_ident())


def record_spill_restore(*, stage: str, tier: str, nbytes: int,
                         ns: int, task=None, name: str = "") -> None:
    """A spilled batch streamed back to the device from ``tier``."""
    if not _SWITCH.enabled:
        return
    st = stage or "-"
    SPILL_RESTORES.inc(labels=(st, tier))
    SPILL_TIME.inc(ns, labels=(st, "restore"))
    JOURNAL.emit("spill_restore", stage=st, tier=tier, bytes=nbytes,
                 ns=ns, task=task, name=name,
                 thread=threading.get_ident())


def record_spill_wait(ns: int, *, stage: str = "") -> None:
    """Synchronous wall time a query thread spent waiting on spill-
    store work (ensure_headroom victims, restore round trips) — the
    ``spill_wait`` attribution bucket's journal source."""
    if not _SWITCH.enabled or ns <= 0:
        return
    JOURNAL.emit("spill_wait", stage=stage or "-", ns=ns,
                 thread=threading.get_ident())


def record_spill_corrupt(outcome: str, *, path: str = "",
                         generation: int = 0, name: str = "",
                         stage: str = "", task=None) -> None:
    """A spill payload failed CRC/parse verification on read-back:
    outcome 'recomputed' (rebuilt from source) or 'failed'."""
    if not _SWITCH.enabled:
        return
    SPILL_CORRUPT.inc(labels=(outcome,))
    JOURNAL.emit("spill_corrupt", outcome=outcome, path=path[:200],
                 generation=generation, name=name, stage=stage or "-",
                 task=task, thread=threading.get_ident())


def record_jit_cache(event: str, kernel: str, *,
                     compile_ns: int = 0) -> None:
    """Compile-cache hook (perf/jit_cache.py): event in
    {'hit', 'miss', 'eviction', 'compile_begin'}.  Misses carry the
    lower+compile wall time observed for the new executable;
    ``compile_begin`` marks the start of a compile and exists purely
    as a heartbeat edge (no counter)."""
    hook = _HEARTBEAT_HOOK
    if hook is not None:
        # both edges of a compile are signs of life (a long lower+
        # compile is the classic slow-but-alive window)
        hook(f"jit:{kernel}")
    if not _SWITCH.enabled:
        return
    if event == "hit":
        JIT_CACHE_HITS.inc(labels=(kernel,))
    elif event == "miss":
        JIT_CACHE_MISSES.inc(labels=(kernel,))
        JIT_COMPILE_TIME.observe(compile_ns, labels=(kernel,))
    elif event == "eviction":
        JIT_CACHE_EVICTIONS.inc(labels=(kernel,))


def record_result_cache(event: str, scope: str, *, tenant: str = "",
                        query: str = "", nbytes: int = 0,
                        ns: int = 0) -> None:
    """Semantic-cache hook (perf/result_cache.py): event in
    {'hit', 'miss', 'eviction', 'put', 'fold'}.  Result-scope events
    carry the tenant (per-tenant hit attribution); folds carry the
    query whose resident state absorbed an arriving batch."""
    if not _SWITCH.enabled:
        return
    tn = tenant or "-"
    if event == "hit":
        RESULT_CACHE_HITS.inc(labels=(scope, tn))
    elif event == "miss":
        RESULT_CACHE_MISSES.inc(labels=(scope, tn))
    elif event == "eviction":
        RESULT_CACHE_EVICTIONS.inc(labels=(scope,))
    elif event == "put":
        RESULT_CACHE_BYTES.inc(nbytes, labels=(scope,))
    elif event == "fold":
        RESULT_CACHE_FOLDS.inc(labels=(query or "-",))
    JOURNAL.emit("result_cache", event=event, scope=scope, tenant=tn,
                 query=query, bytes=nbytes, ns=ns,
                 thread=threading.get_ident())


def record_kernel_path(op: str, path: str, rows: int = 0) -> None:
    """One execution of ``op`` took ``path`` (calibrated kernel
    routing — joins, get_json_object, from_json, raw map).  Rows are
    journal-only color; the counter is the contract surface the
    metrics_report "kernel paths" table renders."""
    if not _SWITCH.enabled:
        return
    KERNEL_PATH.inc(labels=(op, path))
    JOURNAL.emit("kernel_path", op=op, path=path, rows=int(rows),
                 thread=threading.get_ident())


def record_stage_fusion(stage: str, outcome: str, *, digest: str = "",
                        wall_ns: int = 0, nodes: int = 0,
                        compiled: bool = False) -> None:
    """Whole-stage fusion hook (plan/compiler.py): one execution of
    ``stage`` took ``outcome`` ('fused' = one AOT executable,
    'unfused' = the op-by-op walk).  ``compiled`` marks runs that
    built a new fused executable (cache-hit runs don't); ``nodes`` is
    the dispatch count the unfused walk would pay.  The journal event
    feeds the metrics_report "stages" table."""
    if not _SWITCH.enabled:
        return
    STAGE_FUSION.inc(labels=(stage, outcome))
    if compiled:
        STAGE_FUSION.inc(labels=(stage, "compile"))
    JOURNAL.emit("stage_fusion", stage=stage, outcome=outcome,
                 digest=digest, wall_ns=int(wall_ns), nodes=int(nodes),
                 compiled=bool(compiled),
                 thread=threading.get_ident())


def record_lockdep(kind: str, *, cycle=(), op: str = "", held=(),
                   evidence: Optional[dict] = None) -> None:
    """Lockdep evidence hook (analysis/lockdep.py): ``kind`` is
    'cycle' (an acquisition-order cycle between lock classes — ABBA
    deadlock potential) or 'blocking' (a lock held across a known
    blocking call).  A cycle additionally freezes a ``lockdep_cycle``
    incident bundle when the recorder is armed, carrying the
    acquisition stacks of both directions — srt-doctor renders it as
    a ranked finding."""
    if kind == "cycle" and FLIGHT.enabled:
        trigger_incident("lockdep_cycle", severity="warn",
                         cycle=list(cycle),
                         evidence=evidence or {})
    if not _SWITCH.enabled:
        return
    if kind == "cycle":
        LOCKDEP_CYCLES.inc()
        JOURNAL.emit("lockdep", event="cycle", cycle=list(cycle),
                     thread=threading.get_ident())
    elif kind == "blocking":
        LOCKDEP_BLOCKING.inc(labels=(op,))
        JOURNAL.emit("lockdep", event="blocking", op=op,
                     held=list(held),
                     thread=threading.get_ident())


def record_exchange_doubling(from_capacity: int, to_capacity: int,
                             attempt: int) -> None:
    if not _SWITCH.enabled:
        return
    EXCHANGE_DOUBLINGS.inc()
    JOURNAL.emit("exchange_capacity_doubling", from_capacity=from_capacity,
                 to_capacity=to_capacity, attempt=attempt)


def record_device_memory(allocated_bytes: int) -> None:
    if not _SWITCH.enabled:
        return
    DEVICE_MEM_ALLOCATED.set(allocated_bytes)


def record_hbm_sample(device_index: int, bytes_in_use: int) -> None:
    if FLIGHT.enabled:
        FLIGHT.observe_hbm(device_index, bytes_in_use)
    if not _SWITCH.enabled:
        return
    HBM_BYTES_IN_USE.set(bytes_in_use, labels=(str(device_index),))


def record_task_leak(task_id: int, leaked_bytes: int,
                     holders=()) -> None:
    """Memory-ledger leak hook: ``task_done`` saw device bytes still
    attributed to the finishing task (the leak detector's feed, and a
    journal event so a later bundle still shows the history)."""
    if FLIGHT.enabled:
        FLIGHT.observe_task_leak(task_id, leaked_bytes, holders)
    if not _SWITCH.enabled:
        return
    MEMORY_LEAK_EVENTS.inc()
    MEMORY_LEAKED_BYTES.inc(leaked_bytes)
    JOURNAL.emit("memory_leak", task=task_id,
                 leaked_bytes=leaked_bytes,
                 holders=list(holders)[:8])


# ------------------------------------------------------------- ingest hooks
# (io/ calls these; per the layering rule io imports this package,
# never the reverse)


def record_io_read(source: str, nbytes: int, dur_ns: int) -> None:
    """Range-read hook (io/fileio.read_range): bytes fetched from
    storage and the fetch latency."""
    if not _SWITCH.enabled:
        return
    IO_READ_BYTES.inc(nbytes)
    IO_READ_TIME.observe(dur_ns)
    JOURNAL.emit("io_read", source=str(source)[-120:], bytes=nbytes,
                 dur_ns=dur_ns, thread=threading.get_ident())


def record_io_file(source: str, *, columns: int, pages: int, rows: int,
                   read_bytes: int, decode_ns: int) -> None:
    """Whole-file decode hook (io/parquet_reader.read_table): one
    journal record + the srt_io_* counters per materialized file."""
    if not _SWITCH.enabled:
        return
    IO_FILES.inc()
    IO_PAGES.inc(pages)
    IO_ROWS.inc(rows)
    IO_DECODE_TIME.inc(decode_ns)
    JOURNAL.emit("io_file", source=str(source)[-120:], columns=columns,
                 pages=pages, rows=rows, read_bytes=read_bytes,
                 decode_ns=decode_ns, thread=threading.get_ident())


# ------------------------------------------------------- query server hooks
# (server/ calls these; per the layering rule the server imports this
# package, never the reverse)


def record_server_admit(tenant: str, query: str, query_id: str,
                        queue_depth: int) -> None:
    if not _SWITCH.enabled:
        return
    SERVER_ADMITTED.inc(labels=(tenant,))
    JOURNAL.emit("server_admit", tenant=tenant, query=query,
                 query_id=query_id, queue_depth=queue_depth)


def record_server_reject(tenant: str, query: str, reason: str,
                         retry_after_s: float = 0.0) -> None:
    if not _SWITCH.enabled:
        return
    SERVER_REJECTED.inc(labels=(tenant, reason))
    JOURNAL.emit("server_reject", tenant=tenant, query=query,
                 reason=reason, retry_after_s=retry_after_s)


def record_server_dequeue(tenant: str, query_id: str,
                          wait_ns: int) -> None:
    if not _SWITCH.enabled:
        return
    SERVER_QUEUE_WAIT.observe(wait_ns, labels=(tenant,))
    JOURNAL.emit("server_dequeue", tenant=tenant, query_id=query_id,
                 wait_ns=wait_ns)


def record_server_requeue(tenant: str, query_id: str, reason: str,
                          demotions: int) -> None:
    if not _SWITCH.enabled:
        return
    SERVER_REQUEUED.inc(labels=(tenant, reason))
    JOURNAL.emit("server_requeue", tenant=tenant, query_id=query_id,
                 reason=reason, demotions=demotions)


def record_server_complete(tenant: str, query: str, query_id: str,
                           outcome: str, dur_ns: int,
                           wait_ns: int) -> None:
    # SLO feed first (independent switch): one SLI event per
    # completion, latency = what the caller experienced end to end
    if SLO.enabled:
        SLO.observe(tenant, outcome, int(wait_ns) + int(dur_ns))
    if not _SWITCH.enabled:
        return
    SERVER_COMPLETED.inc(labels=(tenant, outcome))
    JOURNAL.emit("server_complete", tenant=tenant, query=query,
                 query_id=query_id, outcome=outcome, dur_ns=dur_ns,
                 wait_ns=wait_ns)


def record_server_watchdog(action: str, tenant: str, query_id: str,
                           **extra) -> None:
    """Lifeguard watchdog intervention: ``deadline_cancel`` (the
    cooperative flag was fired), ``deadline_expired_queued`` (a queued
    job's deadline passed before dispatch), ``hang_release`` (a silent
    worker's task was force-released and the worker orphaned)."""
    if not _SWITCH.enabled:
        return
    SERVER_WATCHDOG.inc(labels=(action,))
    JOURNAL.emit("server_watchdog", action=action, tenant=tenant,
                 query_id=query_id, **extra)


def record_server_quarantine(event: str, tenant: str, query: str,
                             signature: str, **extra) -> None:
    """Poison-query circuit-breaker transition: event in {'opened',
    'reopened', 'probe', 'closed', 'rejected'}."""
    if not _SWITCH.enabled:
        return
    SERVER_QUARANTINE.inc(labels=(event,))
    JOURNAL.emit("server_quarantine", event=event, tenant=tenant,
                 query=query, signature=signature, **extra)


def record_server_drain(phase: str, **extra) -> None:
    """Graceful-drain lifecycle marker: phase in {'begin', 'end'}."""
    if not _SWITCH.enabled:
        return
    SERVER_DRAIN.inc(labels=(phase,))
    JOURNAL.emit("server_drain", phase=phase, **extra)


def set_server_tenant_gauges(queued: dict, running: dict,
                             deficit: dict, device_bytes: dict) -> None:
    """Per-tenant gauge refresh (the server calls this after every
    state transition with its current per-tenant snapshot)."""
    if not _SWITCH.enabled:
        return
    for tenant, v in queued.items():
        SERVER_QUEUED.set(v, labels=(tenant,))
    for tenant, v in running.items():
        SERVER_RUNNING.set(v, labels=(tenant,))
    for tenant, v in deficit.items():
        SERVER_FAIR_DEFICIT.set(round(float(v), 6), labels=(tenant,))
    for tenant, v in device_bytes.items():
        SERVER_TENANT_BYTES.set(int(v), labels=(tenant,))


# ------------------------------------------------------------------- dumping


def expose_text() -> str:
    """Prometheus text exposition of the process registry."""
    _refresh_liveness()
    return METRICS.expose_text()


def snapshot() -> dict:
    """JSON-able state: registry + per-task rollup + journal stats.
    Wall-clock anchored (``snapshot_unix_ms`` + ``uptime_s``): offline
    consumers place the per-process monotonic stamps in real time."""
    _refresh_liveness()
    return {
        "snapshot_unix_ms": int(time.time() * 1000),
        "uptime_s": round(time.monotonic() - _START_MONO, 3),
        "registry": METRICS.snapshot(),
        "tasks": {str(t): d for t, d in TASKS.rollup().items()},
        "journal": {"events": len(JOURNAL),
                    "dropped": JOURNAL.dropped,
                    "by_kind": JOURNAL.counts_by_kind()},
    }


def health() -> dict:
    """One-call process health rollup for the JVM shim's
    ``health_json``: switches, ring fill/drops, recorder stats, and a
    memory-ledger summary when the OOM runtime is installed."""
    _refresh_liveness()
    h = {
        "snapshot_unix_ms": int(time.time() * 1000),
        "start_unix_ms": int(_START_UNIX * 1000),
        "uptime_s": round(time.monotonic() - _START_MONO, 3),
        "pid": os.getpid(),
        "metrics_enabled": _SWITCH.enabled,
        "tracing_enabled": TRACER.enabled,
        "journal": {"events": len(JOURNAL), "dropped": JOURNAL.dropped},
        "spans": {"finished": len(TRACER), "dropped": TRACER.dropped},
        "flight_recorder": FLIGHT.stats(),
        "profiler": PROFILER.stats(),
        "monitor": {
            "last_sample_age_s": (
                None if _LAST_MONITOR_SAMPLE is None else
                round(max(0.0,
                          time.monotonic() - _LAST_MONITOR_SAMPLE), 3)),
            "timeseries_enabled": TIMESERIES.enabled,
            "timeseries_windows": len(TIMESERIES.windows()),
            "slo_enabled": SLO.enabled,
            "attribution_enabled": ATTRIBUTION.enabled,
        },
    }
    try:
        from spark_rapids_tpu_torch.memory import rmm_spark
        from spark_rapids_tpu_torch.memory import spark_resource_adaptor as sra
        adaptor = rmm_spark.installed_adaptor()
        if adaptor is not None:
            states = adaptor.thread_state_dump()
            h["memory"] = {
                "allocated_bytes": adaptor.gpu_memory_allocated_bytes,
                "threads": len(states),
                "blocked_threads": sum(
                    1 for s in states
                    if s["state"] in (sra.THREAD_BLOCKED,
                                      sra.THREAD_BUFN)),
            }
    except Exception:
        pass
    return h


def dump_spans_jsonl(path_or_file) -> int:
    """Finished-span ring as JSON Lines — one process's input file for
    a trace export.  Returns records written."""
    return TRACER.dump_jsonl(path_or_file)


def dump_journal_jsonl(path_or_file) -> int:
    """Journal ring + one ``task_rollup`` record per task + one
    ``registry_snapshot`` record, as JSON Lines — the input format of
    the JAX package's tools/metrics_report.py.  Path writes are atomic
    (tmp + rename via dumpio): a crash mid-dump never leaves a
    truncated JSONL.  Returns records written."""
    import json as _json

    recs = JOURNAL.records()

    def _write(f):
        n = len(recs)
        for r in recs:
            f.write(_json.dumps(r) + "\n")
        for task_id, d in TASKS.rollup().items():
            f.write(_json.dumps(
                {"kind": "task_rollup", "task": task_id, **d}) + "\n")
            n += 1
        f.write(_json.dumps({"kind": "registry_snapshot",
                             "registry": METRICS.snapshot()}) + "\n")
        n += 1
        # the telemetry plane rides the same dump: the metrics report's
        # --window mode and srt-top's dump-dir tier read these records
        if TIMESERIES.enabled:
            f.write(_json.dumps({"kind": "timeseries_snapshot",
                                 **timeseries_snapshot()}) + "\n")
            n += 1
        if SLO.enabled:
            f.write(_json.dumps({"kind": "slo_status",
                                 "slo": SLO.status()}) + "\n")
            n += 1
        return n

    return dump_via(path_or_file, _write)


if os.environ.get("SPARK_RAPIDS_TPU_METRICS", "") not in ("", "0"):
    enable()
if os.environ.get("SPARK_RAPIDS_TPU_TRACE", "") not in ("", "0"):
    enable_tracing()
if os.environ.get("SPARK_RAPIDS_TPU_PROFILE", "") not in ("", "0"):
    enable_profiling()
if os.environ.get("SPARK_RAPIDS_TPU_TIMESERIES", "") not in ("", "0"):
    enable_timeseries()
if os.environ.get("SPARK_RAPIDS_TPU_SLO", "") not in ("", "0"):
    enable_slo()
if os.environ.get("SPARK_RAPIDS_TPU_ATTRIBUTION", "") not in ("", "0"):
    enable_attribution()
if os.environ.get("SPARK_RAPIDS_TPU_STATS", "") not in ("", "0"):
    enable_stats()
