"""The resident multi-tenant query server (the port of the JAX
package's ``server/server.py``: the same states, outcomes, typed
errors, knobs and journal records).

One process, N pool threads, many competing tenants: the per-executor
shape of the reference design (many Spark task threads competing for
device memory through RmmSpark/SparkResourceAdaptor), with the port's
subsystems composed as the control plane:

  * **admission**   — ``admission.AdmissionController``: queue-depth
    backpressure + per-tenant in-flight / device-byte quotas, every
    refusal a typed :class:`ServerOverloaded`;
  * **scheduling**  — ``scheduler.FairShareScheduler`` (weighted
    virtual time) picks WHICH admitted job runs next;
    ``memory/task_priority`` orders attempts WITHIN the run: each
    admission registers a task-priority attempt id, so the OOM
    deadlock breaker's victim selection and the shuffle path see the
    same earlier-admitted-wins ordering the scheduler enforces;
  * **memory arbitration** — every job runs on a pool thread
    registered with RmmSpark as a distinct task, so competing tenants
    block/BUFN/split through the SparkResourceAdaptor state machine
    exactly like competing Spark tasks;
  * **load shedding** — a job whose attempt escapes the robustness
    retry drivers with an OOM-flavored failure (``RetryExhausted``,
    ``*RetryOOM``, ``GpuOOM``) is NOT allowed to kill neighbors: it is
    re-queued at a strictly lower task priority (release + re-register
    in ``task_priority``) up to ``max_requeues`` times, then fails
    alone with a typed error;
  * **accounting**  — ``srt_server_*`` metrics, ``server_*`` journal
    events, a query-root span per job tagged with tenant/query ids,
    and an ``admission_stall`` flight-recorder trigger when a job's
    queue wait crosses the stall threshold.

The **eviction** half is the query lifeguard (
``robustness/lifeguard.py``): per-query deadlines (cooperative
``QueryContext`` checkpoints + a watchdog that fires ``cancel_event``
and escalates), a hung-worker watchdog (heartbeat-silent workers are
orphaned, their RmmSpark task force-released so blocked neighbors
unblock, and the pool replaced), a poison-query quarantine circuit
breaker with half-open probe re-admission, and graceful
``drain()``/restart.  See docs/server.md "Lifecycle & failure
handling".

Pool threads share the card's default stream, so kernels that two
tenants launch at once run one after the other on the device; the
catalog runners' data and pipelines go to ``params["device"]``
(``"cuda"`` unless the request asks for the CPU).

Knobs (all ``SPARK_RAPIDS_TPU_SERVER_*`` env, overridable in code):
``MAX_CONCURRENCY``, ``MAX_QUEUE``, ``TENANT_MAX_INFLIGHT``,
``TENANT_MAX_BYTES``, ``MAX_REQUEUES``, ``STALL_MS``,
``DEFAULT_DEADLINE_S``, ``HANG_S``, ``WATCHDOG_MS``,
``QUARANTINE_FAILURES``, ``QUARANTINE_COOLDOWN_S``,
``DRAIN_DEADLINE_S``, ``DRAIN_DIR``, ``SOCKET_IDLE_S``.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.analysis.lockdep import make_lock
from spark_rapids_tpu_torch.memory import exceptions as exc
from spark_rapids_tpu_torch.memory import task_priority
from spark_rapids_tpu_torch.models import (QueryCancelled, QueryContext,
                                     QueryDeadlineExceeded,
                                     UnknownQueryError, has_query,
                                     run_catalog_query)
from spark_rapids_tpu_torch.perf import result_cache as _result_cache
from spark_rapids_tpu_torch.robustness import lifeguard
from spark_rapids_tpu_torch.robustness.retry import RetryExhausted
from spark_rapids_tpu_torch.server.admission import (REASON_DRAINING,
                                               REASON_QUARANTINED,
                                               REASON_SHUTDOWN,
                                               AdmissionController,
                                               ServerOverloaded,
                                               TenantQuota)
from spark_rapids_tpu_torch.server.scheduler import (STATE_CANCELLED,
                                               STATE_DONE, STATE_FAILED,
                                               STATE_QUEUED,
                                               STATE_RUNNING,
                                               FairShareScheduler, Job)

# what the load-shedding path absorbs: OOM-flavored failures that the
# in-query retry drivers could not recover (everything else is a real
# query error and fails the job immediately)
SHED_ERRORS = (RetryExhausted, exc.RetryOOMBase,
               exc.SplitAndRetryOOMBase, exc.GpuOOM)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


_DEADLINE_ERROR = {"type": "QueryDeadlineExceeded",
                   "reason": "deadline"}


def _cancel_verdict(job: Job):
    """(state, outcome, error) for a job unwinding after its cancel
    flag fired — the ONE place the deadline flavor maps to its typed
    outcome, shared by every unwind path (early-cancel, the except
    arms, and the racing-cancel recheck in finalize)."""
    if job.cancel_reason == "deadline":
        return STATE_FAILED, "deadline", _DEADLINE_ERROR.copy()
    return STATE_CANCELLED, "cancelled", None


def _result_rows(result) -> int:
    """Rows in a completed job's result — the leading dimension of
    the first output column (catalog results are column tuples); a
    scalar result counts as one row.  Best-effort: the rows/s feed
    must never fail a job that just succeeded."""
    import numpy as np
    try:
        first = (result[0] if isinstance(result, (tuple, list))
                 and result else result)
        shape = np.shape(first)
        return int(shape[0]) if shape else 1
    except Exception:
        return 0


@dataclass
class ServerConfig:
    max_concurrency: int = 4
    max_queue: int = 16
    tenant_max_inflight: int = 8
    tenant_max_bytes: int = 0          # 0 = unlimited
    max_requeues: int = 1              # load-shed demotions per job
    stall_ms: int = 5000               # admission-stall trigger; 0=off
    finished_keep: int = 1024          # finished jobs pollable before
    #                                    eviction (resident server:
    #                                    results must not accrete)
    # ---- lifeguard knobs ----
    default_deadline_s: float = 0.0    # per-query deadline; 0=off
    hang_s: float = 30.0               # silent-worker threshold; 0=off
    watchdog_interval_s: float = 0.25  # lifeguard scan cadence
    quarantine_failures: int = 3       # deaths before quarantine; 0=off
    quarantine_cooldown_s: float = 30.0  # first open; doubles, cap 8x
    drain_deadline_s: float = 30.0     # in-flight budget for drain()
    profile_keep: int = 8              # last-K query profiles retained
    #                                    per tenant (0 = no retention)

    @classmethod
    def from_env(cls) -> "ServerConfig":
        p = "SPARK_RAPIDS_TPU_SERVER_"
        return cls(
            max_concurrency=_env_int(p + "MAX_CONCURRENCY", 4),
            max_queue=_env_int(p + "MAX_QUEUE", 16),
            tenant_max_inflight=_env_int(p + "TENANT_MAX_INFLIGHT", 8),
            tenant_max_bytes=_env_int(p + "TENANT_MAX_BYTES", 0),
            max_requeues=_env_int(p + "MAX_REQUEUES", 1),
            stall_ms=_env_int(p + "STALL_MS", 5000),
            finished_keep=_env_int(p + "FINISHED_KEEP", 1024),
            default_deadline_s=_env_float(
                p + "DEFAULT_DEADLINE_S", 0.0),
            hang_s=_env_float(p + "HANG_S", 30.0),
            watchdog_interval_s=max(
                _env_int(p + "WATCHDOG_MS", 250), 10) / 1000.0,
            quarantine_failures=_env_int(
                p + "QUARANTINE_FAILURES", 3),
            quarantine_cooldown_s=_env_float(
                p + "QUARANTINE_COOLDOWN_S", 30.0),
            drain_deadline_s=_env_float(p + "DRAIN_DEADLINE_S", 30.0),
            profile_keep=_env_int(p + "PROFILE_KEEP", 8),
        )


class QueryServer:
    """Front door + pool.  ``runner`` defaults to the models catalog;
    tests inject stubs.  ``device_bytes_fn(tenant)`` overrides the
    memory-ledger fold (tests again)."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 runner: Optional[Callable] = None,
                 device_bytes_fn: Optional[Callable[[str], int]] = None):
        self.config = config or ServerConfig.from_env()
        self._runner = runner or run_catalog_query
        self._device_bytes_fn = device_bytes_fn
        self._lock = make_lock("server.query_server")
        self._work = threading.Condition(self._lock)
        self._sched = FairShareScheduler()
        self._admission = AdmissionController(
            self.config.max_queue,
            TenantQuota(self.config.tenant_max_inflight,
                        self.config.tenant_max_bytes))
        self._jobs: Dict[str, Job] = {}
        # finished jobs stay pollable for a bounded window, then
        # evict oldest-first — a resident server must not accrete
        # every result payload it ever produced
        self._finished: collections.deque = collections.deque()
        self._running: Dict[str, int] = {}
        self._task_tenant: Dict[int, str] = {}   # live task -> tenant
        self._tenant_stats: Dict[str, dict] = {}
        self._seq = itertools.count()
        # task ids live in their own high range so they never collide
        # with Spark-shaped task ids tests drive through RmmSpark
        self._task_ids = itertools.count(1_000_001)
        self._qid = itertools.count(1)
        self._workers: list = []
        self._started = False
        self._stopping = False
        self._draining = False
        self._drain_until = 0.0
        # bumped by stop(): a worker that outlives a timed-out join
        # (job longer than the stop timeout) sees a stale generation
        # and exits instead of rejoining a restarted pool as an
        # untracked extra thread
        self._generation = 0
        # ---- lifeguard ----
        # thread idents the watchdog declared hung: the pool spawned a
        # replacement, and if the orphan ever returns to the loop it
        # must exit, not serve (the per-thread twin of _generation)
        self._orphaned: set = set()
        self._repl = itertools.count(1)   # replacement worker names
        self._quarantine = lifeguard.QuarantineBreaker(
            failures=self.config.quarantine_failures,
            cooldown_s=self.config.quarantine_cooldown_s)
        # last-K query profiles per tenant: the EXPLAIN
        # ANALYZE artifacts the profiler assembles at query end stay
        # pollable by query id until their tenant's window evicts
        # them.  Tenant COUNT is bounded too (LRU by last retain):
        # a client looping fresh tenant strings must recycle whole
        # tenant windows, not grow resident profile state forever
        self._profiles: Dict[str, dict] = {}
        self._profile_order: "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        self._watchdog = lifeguard.Watchdog(
            self._lifeguard_scan, self.config.watchdog_interval_s)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "QueryServer":
        with self._lock:
            if self._started:
                return self
            self._started = True
            self._stopping = False
            self._draining = False
        for i in range(self.config.max_concurrency):
            t = threading.Thread(target=self._worker_loop,
                                 args=(self._generation,),
                                 name=f"srt-server-{i}", daemon=True)
            t.start()
            self._workers.append(t)
        # lifeguard: op-close heartbeats + the deadline/hang scanner
        # (always on — per-submit deadlines need it even when the
        # hang/default-deadline knobs are zeroed)
        lifeguard.install_heartbeat_hook()
        self._watchdog.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        """Stop accepting work, cancel everything still queued, let
        running jobs finish, join the pool."""
        self._watchdog.stop()
        with self._work:
            if not self._started:
                return
            self._stopping = True
            while True:
                job = self._sched.pick(self._running,
                                       self._admission.weight_for)
                if job is None:
                    break
                self._finalize_locked(job, STATE_CANCELLED,
                                      outcome="cancelled")
            self._work.notify_all()
        deadline = time.monotonic() + timeout_s
        for t in self._workers:
            t.join(max(deadline - time.monotonic(), 0.1))
        with self._lock:
            self._generation += 1   # orphan any join-timeout survivor
            self._orphaned.clear()
            self._workers = []
            self._started = False
            self._draining = False
        # symmetric with start(): the last stopped server removes the
        # observability heartbeat hook (ref-counted, so a second live
        # server keeps its hang detection)
        lifeguard.release_heartbeat_hook()

    # ------------------------------------------------------------ admission

    def set_tenant_quota(self, tenant: str, *, max_inflight: int = -1,
                         max_device_bytes: int = -1,
                         weight: float = -1.0) -> TenantQuota:
        return self._admission.set_quota(
            tenant, max_inflight=max_inflight,
            max_device_bytes=max_device_bytes, weight=weight)

    def submit(self, tenant: str, query: str,
               params: Optional[dict] = None,
               deadline_s: Optional[float] = None) -> str:
        """Admit a query; returns its query id or raises the typed
        :class:`ServerOverloaded` backpressure response.

        ``deadline_s`` bounds the query's whole lifetime (queue wait
        included): past it, the cooperative cancel flag fires and the
        watchdog escalates; 0/None falls back to the server-wide
        ``default_deadline_s`` (0 = no deadline)."""
        tenant = str(tenant)
        if self._runner is run_catalog_query \
                and not has_query(str(query)):
            # catalog-backed servers validate the name at the front
            # door: a typo answers typed immediately instead of
            # burning a pool slot to fail at run time
            raise UnknownQueryError(str(query))
        if deadline_s is None or deadline_s <= 0:
            deadline_s = self.config.default_deadline_s
        deadline_ns = (time.monotonic_ns() + int(deadline_s * 1e9)
                       if deadline_s and deadline_s > 0 else None)
        # poison-query circuit breaker: a quarantined signature
        # answers typed BEFORE burning admission/scheduling work; the
        # half-open probe verdict must be reported back (finalize, or
        # the abort below when a downstream check bounces the probe)
        sig = probe = None
        if self._quarantine.enabled:
            sig = lifeguard.signature(tenant, str(query), params)
            verdict = self._quarantine.admit(sig)
            if verdict["verdict"] == "refused":
                _obs.record_server_quarantine(
                    "rejected", tenant, str(query), sig,
                    strikes=verdict.get("strikes", 0),
                    retry_after_s=verdict["retry_after_s"])
                e = ServerOverloaded(
                    REASON_QUARANTINED, tenant,
                    f"signature {sig} is quarantined "
                    f"({verdict.get('strikes', 0)} recent deaths)",
                    retry_after_s=verdict["retry_after_s"])
                with self._lock:
                    self._stat(tenant, "rejected")
                _obs.record_server_reject(tenant, str(query),
                                          e.reason, e.retry_after_s)
                raise e
            probe = verdict["verdict"] == "probe"
            if probe:
                _obs.record_server_quarantine(
                    "probe", tenant, str(query), sig,
                    strikes=verdict.get("strikes", 0))
        # semantic result cache: a warm hit answers BEFORE
        # admission — no pool slot, no queue, no scheduler charge —
        # with the DISTINCT cache_hit outcome (SLO-neutral; a free
        # answer is not a latency win).  The lookup itself runs
        # outside the server lock; only job registration + finalize
        # go under it.
        if self._runner is run_catalog_query \
                and _result_cache.cache_enabled():
            cached, lookup_ns = _result_cache.CACHE.lookup_result(
                tenant, str(query), params)
            if cached is not None:
                warm = None
                with self._work:
                    if self._started and not self._stopping \
                            and not self._draining:
                        task_id = next(self._task_ids)
                        warm = Job(
                            query_id=f"q-{next(self._qid):06d}",
                            tenant=tenant, query=str(query),
                            params=dict(params or {}),
                            seq=next(self._seq), task_id=task_id,
                            priority=task_priority
                            .get_task_priority(task_id),
                            submit_ns=time.monotonic_ns(),
                            deadline_ns=deadline_ns, signature=sig,
                            probe=bool(probe))
                        warm.dur_ns = lookup_ns
                        self._jobs[warm.query_id] = warm
                        self._finalize_locked(warm, STATE_DONE,
                                              outcome="cache_hit",
                                              result=cached)
                if warm is not None:
                    # the profile artifact is assembled OUTSIDE the
                    # lock (retention takes self._lock itself)
                    prof = _obs.cache_hit_profile(
                        tenant, str(query), warm.query_id, lookup_ns)
                    if prof is not None:
                        self._retain_profile(tenant, warm.query_id,
                                             prof)
                    return warm.query_id
                # draining/stopped: fall through to the admission
                # path below, which raises the typed backpressure
        try:
            # the memory-ledger fold (adaptor lock, O(live tasks))
            # runs BEFORE the server lock is taken — _task_tenant is
            # only point-read, so a slightly stale byte count is fine
            # and the fold never serializes dispatch behind the
            # adaptor.  Inside the try: ANY failure between the probe
            # grant and the job's registration must re-arm the
            # breaker (see the BaseException arm below).
            tenant_bytes = (self._tenant_device_bytes(tenant)
                            if self._bytes_tracked(tenant) else None)
            with self._work:
                if not self._started or self._stopping \
                        or self._draining:
                    if self._draining:
                        raise ServerOverloaded(
                            REASON_DRAINING, tenant,
                            "server is draining for restart",
                            retry_after_s=round(max(
                                self._drain_until - time.monotonic(),
                                1.0), 3))
                    raise ServerOverloaded(REASON_SHUTDOWN, tenant,
                                           "server is not accepting "
                                           "work")
                queued_total = self._sched.queued_total()
                inflight = (self._sched.queued_for(tenant)
                            + self._running.get(tenant, 0))
                # cheapest-first (admission.py contract): counts
                # first, the pre-computed byte fold only for tenants
                # whose bytes anyone actually tracks
                self._admission.check(
                    tenant, queued_total=queued_total,
                    tenant_inflight=inflight,
                    tenant_device_bytes=tenant_bytes or 0)
                task_id = next(self._task_ids)
                job = Job(
                    query_id=f"q-{next(self._qid):06d}",
                    tenant=tenant, query=str(query),
                    params=dict(params or {}), seq=next(self._seq),
                    task_id=task_id,
                    priority=task_priority.get_task_priority(task_id),
                    submit_ns=time.monotonic_ns(),
                    deadline_ns=deadline_ns, signature=sig,
                    probe=bool(probe))
                self._jobs[job.query_id] = job
                self._task_tenant[task_id] = tenant
                self._sched.enqueue(job, self._running)
                self._stat(tenant, "admitted")
                _obs.record_server_admit(tenant, job.query,
                                         job.query_id,
                                         queued_total + 1)
                self._publish_gauges_locked(
                    tenant,
                    bytes_for={tenant: tenant_bytes}
                    if tenant_bytes is not None else {})
                self._work.notify()
                return job.query_id
        except ServerOverloaded as e:
            if probe and sig is not None:
                # the half-open probe bounced on a DOWNSTREAM check
                # (queue full, quota): re-open the circuit with an
                # expired cooldown so the next submit probes again —
                # a stuck in-flight marker would quarantine forever
                self._quarantine.abort_probe(sig)
            with self._lock:   # _tenant_stats writes stay serialized
                self._stat(tenant, "rejected")
            _obs.record_server_reject(tenant, str(query), e.reason,
                                      e.retry_after_s)
            raise
        except BaseException:
            # unexpected failure (a custom device_bytes_fn raising,
            # adaptor torn down mid-fold): no job exists to finalize,
            # so a granted probe would stay half-open forever — re-arm
            # it before propagating
            if probe and sig is not None:
                self._quarantine.abort_probe(sig)
            raise

    # -------------------------------------------------------------- queries

    def poll(self, query_id: str,
             timeout_s: Optional[float] = None) -> dict:
        job = self._jobs.get(query_id)
        if job is None:
            return {"query_id": query_id, "state": "unknown"}
        if timeout_s is not None:
            job.done_event.wait(timeout_s)
        with self._lock:
            st = job.status()
            # a wait that EXPIRED must be distinguishable from a job
            # that is merely pending: the caller asked "done within
            # timeout_s?" and the answer was no.  The done_event
            # check runs under the lock (finalize sets it under the
            # lock too), so a finish racing the wait's expiry reports
            # the terminal state with no timed_out marker.
            if timeout_s is not None and not job.done_event.is_set():
                st["timed_out"] = True
        return st

    def wait(self, query_id: str, timeout_s: float = 60.0) -> dict:
        """Poll that blocks until the job leaves the queue/run states
        (or the timeout passes)."""
        return self.poll(query_id, timeout_s=timeout_s)

    def cancel(self, query_id: str, reason: str = "user") -> bool:
        """Cancel a query: queued jobs unwind immediately; running
        jobs get their cooperative flag set (runners that poll it stop
        early; a non-cooperative runner's result is discarded)."""
        with self._work:
            job = self._jobs.get(query_id)
            if job is None or job.done_event.is_set():
                return False
            if job.cancel_reason is None:
                job.cancel_reason = reason
            job.cancel_event.set()
            if job.state == STATE_QUEUED and self._sched.remove(job):
                self._finalize_locked(job, STATE_CANCELLED,
                                      outcome="cancelled")
            _obs.JOURNAL.emit("server_cancel", tenant=job.tenant,
                              query_id=query_id, state=job.state)
            return True

    def stats(self) -> dict:
        # ledger fold outside the server lock (see submit)
        ledger_map = (None if self._device_bytes_fn is not None
                      else self._ledger_tenant_bytes())
        with self._lock:
            tenants = {}
            for tenant, st in sorted(self._tenant_stats.items()):
                row = dict(st)
                row["queued"] = self._sched.queued_for(tenant)
                row["running"] = self._running.get(tenant, 0)
                row["device_bytes"] = self._tenant_device_bytes(
                    tenant, ledger_map)
                q = self._admission.quota_for(tenant)
                row["quota"] = {"max_inflight": q.max_inflight,
                                "max_device_bytes": q.max_device_bytes,
                                "weight": q.weight}
                # per-tenant wall-clock split: summed
                # attribution buckets over the tenant's retained
                # profiles — only present when attribution is armed,
                # so older consumers see an unchanged shape
                if _obs.is_attribution_enabled():
                    row["attribution"] = \
                        self._tenant_attribution_locked(tenant)
                tenants[tenant] = row
            return {
                "config": {
                    "max_concurrency": self.config.max_concurrency,
                    "max_queue": self.config.max_queue,
                    "max_requeues": self.config.max_requeues,
                    "stall_ms": self.config.stall_ms,
                    "default_deadline_s":
                        self.config.default_deadline_s,
                    "hang_s": self.config.hang_s,
                    "quarantine_failures":
                        self.config.quarantine_failures,
                },
                "started": self._started,
                "draining": self._draining,
                "lifeguard": {
                    "watchdog": self._watchdog.snapshot(),
                    "quarantine": self._quarantine.snapshot(),
                    "orphaned_workers": len(self._orphaned),
                },
                "queued_total": self._sched.queued_total(),
                "running_total": sum(self._running.values()),
                "jobs_total": len(self._jobs),
                "tenants": tenants,
                "scheduler": self._sched.snapshot(),
                # fair-share evidence satellite: the priority
                # registry's live view rides the stats endpoint
                "task_priority": task_priority.stats(),
                # per-tenant SLO view: burn rates +
                # attainment when the monitor is armed, else None —
                # callers distinguish "no SLOs" from "all green"
                "slo": (_obs.SLO.status()
                        if _obs.SLO.enabled else None),
            }

    # -------------------------------------------------------------- workers

    def _worker_loop(self, generation: int) -> None:
        ident = threading.get_ident()
        while True:
            with self._work:
                if ident in self._orphaned:
                    # the watchdog declared this worker hung and the
                    # pool already replaced it: a late return must
                    # exit, never serve alongside its replacement
                    self._orphaned.discard(ident)
                    return
                job = None
                while not self._stopping \
                        and self._generation == generation:
                    job = self._sched.pick(self._running,
                                           self._admission.weight_for)
                    if job is not None:
                        break
                    self._work.wait()
                if job is None:       # stopping/orphaned, queue drained
                    return
                job.state = STATE_RUNNING
                # the attempt identity (who runs it, since when) is
                # stamped HERE, atomically with the RUNNING
                # transition: a watchdog tick between dispatch and
                # _execute must never see this attempt wearing a
                # previous attempt's worker/clock (stale evidence)
                job.worker_ident = threading.get_ident()
                job.run_start_ns = time.monotonic_ns()
                job.wait_ns = job.run_start_ns - job.submit_ns
                self._running[job.tenant] = \
                    self._running.get(job.tenant, 0) + 1
                queue_depth = self._sched.queued_total()
                self._publish_gauges_locked(job.tenant)
            self._execute(job, queue_depth)

    def _execute(self, job: Job, queue_depth: int) -> None:
        cfg = self.config
        _obs.record_server_dequeue(job.tenant, job.query_id,
                                   job.wait_ns)
        if cfg.stall_ms > 0 and job.wait_ns > cfg.stall_ms * 1_000_000 \
                and _obs.FLIGHT.enabled:
            # black box: a stalled admission is the "who is hogging the
            # device" moment — freeze the ledger with tenant
            # attribution.  The recorder-enabled check comes FIRST:
            # the per-tenant snapshot (server lock + full ledger
            # fold) must not be built for a bundle that is never
            # written
            _obs.trigger_incident(
                "admission_stall", severity="warn",
                tenant=job.tenant, query_id=job.query_id,
                queue_wait_ms=job.wait_ns // 1_000_000,
                queue_depth=queue_depth,
                tenant_device_bytes=self._tenant_bytes_snapshot())
        if job.cancel_event.is_set():
            with self._work:
                # charge=True: the worker loop already incremented
                # this tenant's running count — skipping the
                # decrement would leave a phantom in-flight job that
                # eventually wedges the tenant's admission quota
                # (dur_ns is 0, so the vruntime charge is zero)
                state, outcome, error = _cancel_verdict(job)
                self._finalize_locked(job, state, outcome=outcome,
                                      error=error, charge=True)
            return
        self._register_rmm_task(job)
        # lifeguard bookkeeping: worker_ident/run_start_ns were
        # stamped under the lock at dispatch (atomically with the
        # RUNNING transition); the hang scan measures silence from
        # max(run start, last heartbeat ≥ run start) so a beat from a
        # PREVIOUS job on this thread can never vouch for this one
        lifeguard.beat(f"job:{job.query_id}")
        ctx = QueryContext(job.query_id, job.tenant, job.cancel_event,
                           deadline_ns=job.deadline_ns)
        t0 = time.monotonic_ns()
        outcome, state, result, error = "success", STATE_DONE, None, None
        try:
            with _obs.TRACER.span(
                    f"server_query:{job.query}", kind="query",
                    attrs={"tenant": job.tenant,
                           "query_id": job.query_id,
                           "server_task_id": job.task_id,
                           "demotions": job.demotions}):
                # profile session INSIDE the query-root span (begin
                # captures the root trace context) and around the
                # runner only — queue wait is the server's story, the
                # profile's wall is the execution.  One attribute
                # read when SPARK_RAPIDS_TPU_PROFILE is off.
                # ... but the attribution ledger DOES want the whole
                # admission-to-result wall, so the measured queue wait
                # rides into the session as a stamp
                psess = _obs.PROFILER.begin(
                    job.query_id, tenant=job.tenant, query=job.query,
                    queue_wait_ns=job.wait_ns)
                try:
                    result = self._runner(job.query, job.params, ctx)
                finally:
                    prof = _obs.PROFILER.end(psess)
                    if prof is not None:
                        self._retain_profile(job.tenant,
                                             job.query_id, prof)
        except QueryCancelled as e:
            if isinstance(e, QueryDeadlineExceeded) \
                    and job.cancel_reason is None:
                # a cooperative deadline checkpoint fired before any
                # cancel flag existed: burn-the-budget verdict (an
                # explicit user/drain cancel, had there been one,
                # dominates — see QueryContext.check_cancel)
                outcome, state = "deadline", STATE_FAILED
                error = _DEADLINE_ERROR.copy()
            else:
                state, outcome, error = _cancel_verdict(job)
        except SHED_ERRORS as e:
            if job.cancel_event.is_set():
                # cancel dominates: a cancelled job whose runner then
                # tripped an OOM must report "cancelled" (or its
                # deadline), not a bogus quota-exhaustion failure
                state, outcome, error = _cancel_verdict(job)
            elif self._try_spill_rescue(job, e):
                # the tiered store freed real device bytes — retry at
                # the SAME demotion level instead of burning one: the
                # OOM was pressure the spill ladder can absorb, not a
                # quota problem
                job.dur_ns = time.monotonic_ns() - t0
                self._release_rmm_task(job)
                self._requeue_demoted(job, e, charge_demotion=False)
                return
            elif job.demotions < cfg.max_requeues:
                # the failed attempt's pool time still gets charged
                # (in _requeue_demoted) — an OOM-ing tenant must not
                # ride free vruntime while burning worker wall-clock
                job.dur_ns = time.monotonic_ns() - t0
                self._release_rmm_task(job)
                self._requeue_demoted(job, e)
                return
            else:
                outcome, state = "shed", STATE_FAILED
                error = {"type": type(e).__name__,
                         "message": str(e)[:300],
                         "reason": "oom_quota_exhausted"}
        # srt-lint: disable=SRT007 job isolation: the error is folded into the job's typed outcome; the pool thread must survive any tenant bug
        except BaseException as e:  # noqa: BLE001 — job isolation:
            # one tenant's bug must never take the pool thread down
            if job.cancel_event.is_set():
                state, outcome, error = _cancel_verdict(job)
            else:
                outcome, state = "failed", STATE_FAILED
                error = {"type": type(e).__name__,
                         "message": str(e)[:300]}
        job.dur_ns = time.monotonic_ns() - t0
        # (a cancel racing the finish is rechecked inside
        # _finalize_locked, under the lock.)  A hung job's task was
        # already force-released by the watchdog — a second task_done
        # from the late-unwinding orphan would write a spurious
        # "completed normally" journal event over the force-release
        if not job.hung:
            self._release_rmm_task(job)
        # cold-path fill: a successful catalog result goes
        # into the semantic cache BEFORE finalize sets done_event — a
        # waiter that resubmits the instant poll() returns must find
        # the entry warm.  Runners are pure functions of their
        # binding, so the entry stays valid even if the racing-cancel
        # recheck inside finalize discards THIS job's answer
        if state == STATE_DONE and result is not None \
                and not job.hung \
                and self._runner is run_catalog_query \
                and _result_cache.cache_enabled():
            try:
                _result_cache.CACHE.store_result(
                    job.tenant, job.query, job.params, result)
            except Exception:
                pass   # caching is best-effort, never a failure path
        # per-tenant rows delivered: the rows/s feed
        # behind srt-top + the stats() endpoint's per-tenant fold
        rows_done = 0
        if state == STATE_DONE and result is not None \
                and not job.hung:
            rows_done = _result_rows(result)
            if _obs.is_enabled():
                _obs.record_tenant_rows(job.tenant, rows_done)
        with self._work:
            if rows_done:
                self._stat_add(job.tenant, "rows", rows_done)
            self._finalize_locked(job, state, outcome=outcome,
                                  result=result, error=error,
                                  charge=True)
        # the byte-gauge refresh pays a full memory-ledger fold (the
        # adaptor lock) — run it AFTER the server lock is released,
        # like the stall-trigger snapshot, and only for tenants whose
        # bytes anyone tracks
        if self._bytes_tracked(job.tenant):
            _obs.set_server_tenant_gauges(
                {}, {}, {},
                {job.tenant: self._tenant_device_bytes(job.tenant)})

    # ----------------------------------------------------- query profiles

    def _tenant_attribution_locked(self, tenant: str
                                   ) -> Optional[dict]:
        """Summed attribution buckets over a tenant's retained
        profiles (caller holds ``self._lock``).  None until at least
        one ledger-carrying profile is retained — callers distinguish
        'not armed yet' from 'all zeros'."""
        buckets: Dict[str, int] = {}
        n = 0
        for qid in self._profile_order.get(tenant, ()):
            led = (self._profiles.get(qid) or {}).get("attribution")
            if not led:
                continue
            n += 1
            for b, v in (led.get("buckets") or {}).items():
                buckets[b] = buckets.get(b, 0) + int(v)
        if n == 0:
            return None
        nonzero = {b: v for b, v in buckets.items() if v > 0}
        return {"queries": n, "buckets": buckets,
                "dominant": (max(nonzero, key=nonzero.get)
                             if nonzero else None)}

    def _retain_profile(self, tenant: str, query_id: str,
                        profile: dict) -> None:
        """Retain one finished query's profile under its tenant's
        last-K window (oldest evicted; ``profile_keep=0`` disables
        retention entirely).  Dict bookkeeping only — the lock never
        covers profile assembly."""
        keep = self.config.profile_keep
        if keep <= 0:
            return
        with self._lock:
            dq = self._profile_order.get(tenant)
            if dq is None:
                dq = self._profile_order[tenant] = collections.deque()
            else:
                self._profile_order.move_to_end(tenant)
            dq.append(query_id)
            self._profiles[query_id] = profile
            while len(dq) > keep:
                self._profiles.pop(dq.popleft(), None)
            while len(self._profile_order) > self._MAX_TENANT_ROWS:
                _t, old = self._profile_order.popitem(last=False)
                for qid in old:
                    self._profiles.pop(qid, None)

    def profile(self, query_id: str) -> Optional[dict]:
        """The retained EXPLAIN ANALYZE artifact for ``query_id``, or
        None (never profiled, or evicted by its tenant's window)."""
        with self._lock:
            return self._profiles.get(str(query_id))

    def profile_ids(self, tenant: str) -> list:
        """Retained profile query-ids for one tenant, oldest first."""
        with self._lock:
            dq = self._profile_order.get(str(tenant))
            return [q for q in dq if q in self._profiles] \
                if dq else []

    # ------------------------------------------------------------ lifeguard

    def _lifeguard_scan(self) -> None:
        """One watchdog tick (robustness/lifeguard.Watchdog): expire
        queued jobs past their deadline, fire the cooperative cancel
        flag on running ones, and declare silent workers hung."""
        cfg = self.config
        now = time.monotonic_ns()
        hang_ns = int(cfg.hang_s * 1e9)
        expired, fired, running = [], [], []
        with self._work:
            for job in list(self._jobs.values()):
                if job.done_event.is_set() or job.hung:
                    continue
                if job.state == STATE_QUEUED:
                    if job.deadline_ns is not None \
                            and now > job.deadline_ns \
                            and self._sched.remove(job):
                        expired.append(job)
                    continue
                if job.state != STATE_RUNNING:
                    continue
                if job.deadline_ns is not None \
                        and now > job.deadline_ns \
                        and not job.cancel_event.is_set():
                    if job.cancel_reason is None:
                        job.cancel_reason = "deadline"
                    job.cancel_event.set()
                    fired.append(job)
                running.append(job)
            for job in expired:
                # queued past deadline: never dispatched, so no
                # running-count to release (charge stays False)
                self._finalize_locked(
                    job, STATE_FAILED, outcome="deadline",
                    error={"type": "QueryDeadlineExceeded",
                           "reason": "deadline_expired_queued"})
        for job in expired:
            _obs.record_server_watchdog("deadline_expired_queued",
                                        job.tenant, job.query_id,
                                        query=job.query)
        for job in fired:
            _obs.record_server_watchdog("deadline_cancel", job.tenant,
                                        job.query_id, query=job.query)
        if hang_ns <= 0:
            return
        # hang evaluation OUTSIDE the server lock: the adaptor state
        # probe takes the adaptor lock, which must never nest inside
        # ours (the submit-path ledger-fold rule)
        for job in running:
            why = self._hang_check(job, now, hang_ns)
            if why is not None:
                self._handle_hung(job, *why)

    def _hang_check(self, job: Job, now: int, hang_ns: int):
        """(reason, silent_ns, last_label) when the job's worker is
        presumed wedged, else None.  Silence is measured from
        max(dispatch, last heartbeat ≥ dispatch) — a beat left by a
        previous job on the same thread can never vouch for this one.
        A thread parked in the OOM state machine is waiting, not
        wedged (its stall is the deadlock-breaker's jurisdiction) —
        unless the job has also blown through its deadline by a full
        hang window (a cancel-ignoring runner must still be evicted)."""
        ident = job.worker_ident
        run_start = job.run_start_ns
        if ident is None or run_start <= 0:
            return None
        last, label = run_start, "job_start"
        b = lifeguard.last_beat(ident)
        if b is not None and b[0] >= run_start:
            last, label = b
        silent_ns = now - last
        if job.deadline_ns is not None \
                and now > job.deadline_ns + hang_ns:
            return ("deadline_escalation", silent_ns, label,
                    run_start)
        if silent_ns <= hang_ns:
            return None
        try:
            from spark_rapids_tpu_torch.memory import rmm_spark
            from spark_rapids_tpu_torch.memory import \
                spark_resource_adaptor as sra
            adaptor = rmm_spark.installed_adaptor()
            if adaptor is not None and adaptor.get_state_of(ident) \
                    in (sra.THREAD_BLOCKED, sra.THREAD_BUFN):
                return None
        except Exception:
            pass
        return ("heartbeat_silent", silent_ns, label, run_start)

    def _handle_hung(self, job: Job, why: str, silent_ns: int,
                     last_label: str, run_start_ns: int) -> None:
        """Evict a wedged worker: orphan it, replace it, report the
        death to the quarantine breaker, freeze a ``query_hang``
        bundle (stacks + pre-release ledger), force-release the
        job's RmmSpark task so blocked neighbors unblock, and
        finalize the job as hung."""
        with self._work:
            if job.done_event.is_set() or job.hung:
                return
            if job.state != STATE_RUNNING \
                    or job.run_start_ns != run_start_ns:
                # the ATTEMPT the scan judged silent is over (the job
                # OOM-requeued or was re-picked since the snapshot):
                # whatever is running now is a different attempt with
                # a fresh clock — never evict on stale evidence
                return
            job.hung = True
            if job.cancel_reason is None:
                job.cancel_reason = "hang"
            job.cancel_event.set()   # a late waker should exit fast
            ident = job.worker_ident
            if ident is not None:
                self._orphaned.add(ident)
            # replacement first: pool capacity must not shrink while
            # the orphan blocks a slot forever
            repl = threading.Thread(
                target=self._worker_loop, args=(self._generation,),
                name=f"srt-server-repl-{next(self._repl)}",
                daemon=True)
            self._workers.append(repl)
        repl.start()
        # breaker BEFORE the bundle: the bundle's detail (and the
        # journal frozen into it) must carry the post-death
        # quarantine state, so srt-doctor can name the quarantined
        # signature straight from the query_hang bundle
        qinfo = {"quarantined": False, "strikes": 0}
        if job.signature is not None and self._quarantine.enabled:
            qinfo = self._quarantine.note_death(job.signature, "hung",
                                                probe=job.probe)
            if qinfo.get("opened"):
                _obs.record_server_quarantine(
                    "reopened" if job.probe else "opened",
                    job.tenant, job.query, job.signature,
                    strikes=qinfo["strikes"], reason="hung",
                    retry_after_s=qinfo["retry_after_s"])
        silent_ms = silent_ns // 1_000_000
        _obs.record_server_watchdog(
            "hang_release", job.tenant, job.query_id, query=job.query,
            reason=why, silent_ms=silent_ms, last_op=last_label,
            task_id=job.task_id)
        # evidence freeze BEFORE the force-release: the bundle's
        # memory ledger must still show the hung task's held bytes
        _obs.trigger_incident(
            "query_hang", severity="error", tenant=job.tenant,
            query=job.query, query_id=job.query_id,
            task_id=job.task_id, worker_ident=ident, reason=why,
            silent_ms=silent_ms, last_op=last_label,
            signature=job.signature, quarantine=qinfo,
            stack=lifeguard.thread_stack(ident)[-8:])
        try:
            from spark_rapids_tpu_torch.memory import rmm_spark
            if rmm_spark.installed_adaptor() is not None:
                rmm_spark.force_release_task(job.task_id)
        except Exception:
            pass   # adaptor torn down mid-flight: nothing to release
        with self._work:
            self._finalize_locked(
                job, STATE_FAILED, outcome="hung",
                error={"type": "QueryHung", "reason": why,
                       "silent_ms": silent_ms,
                       "last_op": last_label},
                charge=True)

    # ----------------------------------------------------------- draining

    def drain(self, deadline_s: Optional[float] = None,
              flush_dir: Optional[str] = None) -> dict:
        """Graceful drain: stop admitting (typed ``draining``
        refusals), let in-flight work finish under ``deadline_s``
        (default ``drain_deadline_s``), cancel what remains, flush
        journal/spans/metrics through dumpio, stop the pool, and
        return a drain report.  A subsequent start (or a fresh
        ``server_start`` through the shim) serves again — with the
        process-wide compiled stages still warm."""
        cfg = self.config
        t0 = time.monotonic()
        if deadline_s is None or deadline_s <= 0:
            deadline_s = cfg.drain_deadline_s
        deadline = t0 + deadline_s
        with self._work:
            if not self._started:
                return {"state": "stopped", "in_flight": 0,
                        "completed": 0, "cancelled": 0,
                        "abandoned": 0, "duration_s": 0.0,
                        "flush": {}}
            self._draining = True
            self._drain_until = deadline
            pending = [j for j in self._jobs.values()
                       if not j.done_event.is_set()]
        _obs.record_server_drain("begin", in_flight=len(pending),
                                 deadline_s=deadline_s)
        finished, leftover = [], []
        for job in pending:
            job.done_event.wait(max(deadline - time.monotonic(), 0.0))
            (finished if job.done_event.is_set()
             else leftover).append(job)
        cancelled = [j for j in leftover
                     if self.cancel(j.query_id, reason="drain")]
        grace = time.monotonic() + min(2.0, deadline_s)
        for job in cancelled:
            job.done_event.wait(max(grace - time.monotonic(), 0.0))
        abandoned = [j.query_id for j in leftover
                     if not j.done_event.is_set()]
        flush = self._flush_observability(flush_dir)
        report = {
            "state": "drained",
            "in_flight": len(pending),
            "completed": len(finished),
            "cancelled": len(cancelled),
            "abandoned": len(abandoned),
            "abandoned_ids": abandoned[:32],
            "outcomes": self._outcomes_of(finished + leftover),
            "duration_s": round(time.monotonic() - t0, 3),
            "flush": flush,
        }
        _obs.record_server_drain(
            "end", in_flight=len(pending),
            completed=len(finished), cancelled=len(cancelled),
            abandoned=len(abandoned),
            duration_s=report["duration_s"])
        self.stop(timeout_s=5.0)
        return report

    def _outcomes_of(self, jobs) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for j in jobs:
                out[j.state] = out.get(j.state, 0) + 1
        return out

    def _flush_observability(self, flush_dir: Optional[str]) -> dict:
        """Drain-time flush: journal + spans + metrics snapshot
        through the atomic dumpio path.  Opt-in by directory
        (``SPARK_RAPIDS_TPU_SERVER_DRAIN_DIR`` or the ``flush_dir``
        argument) — a drain must not litter the CWD uninvited."""
        flush_dir = flush_dir or os.environ.get(
            "SPARK_RAPIDS_TPU_SERVER_DRAIN_DIR", "")
        if not flush_dir:
            return {"skipped": "no drain dir configured"}
        import json as _json

        from spark_rapids_tpu_torch.observability.dumpio import atomic_write
        d = os.path.join(flush_dir,
                         f"drain-{int(time.time() * 1000)}")
        out: Dict[str, object] = {"dir": d}
        try:
            os.makedirs(d, exist_ok=True)
            out["journal_records"] = _obs.dump_journal_jsonl(
                os.path.join(d, "journal.jsonl"))
            out["span_records"] = _obs.dump_spans_jsonl(
                os.path.join(d, "spans.jsonl"))
            snap = _json.dumps(_obs.snapshot(), sort_keys=True)
            atomic_write(os.path.join(d, "metrics.json"),
                         lambda f: f.write(snap))
            out["metrics_bytes"] = len(snap)
        except Exception as e:   # flush failure must not fail drain
            out["error"] = f"{type(e).__name__}: {e}"
        return out

    def _try_spill_rescue(self, job: Job, cause: BaseException) -> bool:
        """One spill-store rescue per job BEFORE a demotion is burned:
        ask the installed tiered store (memory/spill.py) to free
        device headroom synchronously.  True when real bytes were
        freed — the job re-queues at the same demotion level and the
        retry runs against a lighter device."""
        if job.spill_rescued:
            return False
        from spark_rapids_tpu_torch.memory import spill as spill_mod
        store = spill_mod.installed_store()
        if store is None:
            return False
        job.spill_rescued = True
        try:
            freed = store.ensure_headroom(1 << 62)
        except Exception:
            return False
        return freed > 0

    def _requeue_demoted(self, job: Job, cause: BaseException,
                         charge_demotion: bool = True) -> None:
        """Load-shed: release the attempt's priority and re-register —
        the re-registered id gets a strictly LOWER priority (newer
        value, see task_priority.py docs) — then back of the queue.
        A spill rescue re-queues WITHOUT burning a demotion (the
        pressure was absorbed by the store, not the job's quota)."""
        task_priority.task_done(job.task_id)
        if charge_demotion:
            job.demotions += 1
        job.priority = task_priority.get_task_priority(job.task_id)
        job.state = STATE_QUEUED
        job.submit_ns = time.monotonic_ns()
        # the burned attempt's identity must not survive into the
        # queue: a watchdog tick around the NEXT dispatch would
        # otherwise judge the fresh attempt by this one's worker and
        # clock (and evict a healthy worker on stale evidence)
        job.worker_ident = None
        job.run_start_ns = 0
        _obs.record_server_requeue(job.tenant, job.query_id,
                                   type(cause).__name__, job.demotions)
        with self._work:
            self._stat(job.tenant, "requeued")
            self._dec_running(job.tenant)
            # charge the burned attempt now; the job's clock restarts
            # for the next attempt (each attempt is charged once)
            self._sched.charge(job.tenant, job.dur_ns / 1e9,
                               self._admission.weight_for(job.tenant))
            job.dur_ns = 0
            if self._stopping:
                # stop() already drained the queue; a job demoted
                # mid-shutdown must not be stranded in it forever
                self._finalize_locked(job, STATE_CANCELLED,
                                      outcome="cancelled")
                return
            self._sched.enqueue(job, self._running)
            self._publish_gauges_locked(job.tenant)
            self._work.notify()

    def _dec_running(self, tenant: str) -> None:
        """Decrement, DELETING the zero entry — a resident server
        must not keep one dict row per tenant name ever seen."""
        n = self._running.get(tenant, 0) - 1
        if n > 0:
            self._running[tenant] = n
        else:
            self._running.pop(tenant, None)

    def _finalize_locked(self, job: Job, state: str, *, outcome: str,
                         result=None, error=None,
                         charge: bool = False) -> None:
        """Terminal transition; caller holds the lock.  Idempotent:
        the watchdog can finalize a hung job while its orphaned
        worker is still wedged inside the runner — whichever side
        finishes second must be a no-op."""
        if job.done_event.is_set():
            return
        if job.hung and outcome != "hung":
            # the watchdog marked this job hung; whatever unwind path
            # the (possibly force-released) worker took afterwards —
            # ThreadRemovedException, a swallowed cancel, even a late
            # success — the verdict stays "hung", whichever side
            # reaches finalize first
            state, result = STATE_FAILED, None
            outcome = "hung"
            if not (error and error.get("type") == "QueryHung"):
                error = {"type": "QueryHung",
                         "reason": job.cancel_reason or "hang"}
        if state == STATE_DONE and job.cancel_event.is_set():
            # the racing-cancel recheck must happen UNDER the lock:
            # cancel() returning True guarantees the result is
            # discarded, even when the flag landed between the
            # worker's last check and this finalize
            state, outcome, error = _cancel_verdict(job)
            result = None
        if charge:
            self._dec_running(job.tenant)
            self._sched.charge(job.tenant, job.dur_ns / 1e9,
                               self._admission.weight_for(job.tenant))
        job.state = state
        job.result = result
        job.error = error
        job.outcome = outcome
        self._task_tenant.pop(job.task_id, None)
        task_priority.task_done(job.task_id)
        self._stat(job.tenant, outcome)
        self._note_quarantine(job, outcome)
        _obs.record_server_complete(job.tenant, job.query,
                                    job.query_id, outcome, job.dur_ns,
                                    job.wait_ns)
        self._publish_gauges_locked(job.tenant)  # bytes refresh
        #                          outside the lock (_execute's tail)
        self._finished.append(job.query_id)
        while len(self._finished) > max(self.config.finished_keep, 1):
            self._jobs.pop(self._finished.popleft(), None)
        job.done_event.set()

    def _note_quarantine(self, job: Job, outcome: str) -> None:
        """Report a job's terminal outcome to the poison-query
        breaker (leaf lock — safe under the server lock).  Hung jobs
        are skipped: the hang handler reported their death BEFORE
        freezing the ``query_hang`` bundle, so the bundle's detail
        carries the post-transition quarantine state."""
        sig = job.signature
        if sig is None or not self._quarantine.enabled or job.hung:
            return
        if outcome == "deadline" and job.run_start_ns == 0:
            # the deadline expired while the job was still QUEUED:
            # that is queue congestion, not evidence the query is
            # poison — neutral for the breaker (a probe re-arms)
            self._quarantine.note_neutral(sig, probe=job.probe)
            return
        if outcome == "success":
            info = self._quarantine.note_success(sig, probe=job.probe)
            if info.get("closed"):
                _obs.record_server_quarantine(
                    "closed", job.tenant, job.query, sig)
        elif outcome in lifeguard.DEATH_OUTCOMES:
            info = self._quarantine.note_death(sig, outcome,
                                               probe=job.probe)
            if info.get("opened"):
                _obs.record_server_quarantine(
                    "reopened" if job.probe else "opened",
                    job.tenant, job.query, sig,
                    strikes=info["strikes"], reason=outcome,
                    retry_after_s=info["retry_after_s"])
        else:   # cancelled: neutral (a cancelled probe re-arms)
            self._quarantine.note_neutral(sig, probe=job.probe)

    # ------------------------------------------------------- rmm plumbing

    def _register_rmm_task(self, job: Job) -> None:
        """Register this pool thread with the OOM state machine as a
        distinct task, so tenants arbitrate device memory exactly like
        competing Spark tasks.  No-op without an installed adaptor."""
        from spark_rapids_tpu_torch.memory import rmm_spark
        if rmm_spark.installed_adaptor() is None:
            return
        try:
            rmm_spark.pool_thread_working_on_tasks(
                False, rmm_spark.current_thread_id(), [job.task_id])
        except Exception:
            pass   # adaptor torn down mid-flight: run unregistered

    def _release_rmm_task(self, job: Job) -> None:
        from spark_rapids_tpu_torch.memory import rmm_spark
        if rmm_spark.installed_adaptor() is None:
            return
        try:
            rmm_spark.pool_thread_finished_for_tasks(
                rmm_spark.current_thread_id(), [job.task_id])
            rmm_spark.task_done(job.task_id)
        except Exception:
            pass

    # ----------------------------------------------------------- accounting

    # bounded per-tenant accounting: a socket client looping fresh
    # tenant strings (every one of which reaches _stat, rejected or
    # not) must not grow resident state or per-transition gauge work
    # without limit — past the cap, new tenants fold into one
    # "__other__" row, the metrics registry's bounded-labels rule
    _MAX_TENANT_ROWS = 256
    _OTHER = "__other__"

    def _stat(self, tenant: str, key: str) -> None:
        self._stat_add(tenant, key, 1)

    def _stat_add(self, tenant: str, key: str, n: int) -> None:
        if tenant not in self._tenant_stats \
                and len(self._tenant_stats) >= self._MAX_TENANT_ROWS:
            tenant = self._OTHER
        row = self._tenant_stats.setdefault(tenant, {
            "admitted": 0, "rejected": 0, "requeued": 0, "success": 0,
            "failed": 0, "cancelled": 0, "shed": 0, "hung": 0,
            "deadline": 0, "cache_hit": 0, "rows": 0})
        row[key] = row.get(key, 0) + n

    def _bytes_tracked(self, tenant: str) -> bool:
        """Whether anyone pays attention to this tenant's device
        bytes: a byte quota is set, or a custom fold is injected.
        Untracked tenants skip the memory-ledger fold entirely."""
        return (self._device_bytes_fn is not None
                or self._admission.quota_for(tenant).max_device_bytes
                > 0)

    def _ledger_tenant_bytes(self) -> Dict[str, int]:
        """ONE memory-ledger fold → tenant -> held device bytes for
        live server tasks (the adaptor's memory ledger).  Callers that need several
        tenants reuse the map instead of re-folding per tenant."""
        from spark_rapids_tpu_torch.memory import rmm_spark
        out: Dict[str, int] = {}
        adaptor = rmm_spark.installed_adaptor()
        if adaptor is None:
            return out
        ledger = adaptor.memory_ledger(timeline=0)
        for task_str, row in (ledger.get("tasks") or {}).items():
            try:
                owner = self._task_tenant.get(int(task_str))
            except ValueError:
                continue
            if owner is not None:
                out[owner] = (out.get(owner, 0)
                              + max(int(row.get("active_bytes", 0)),
                                    0))
        return out

    def _tenant_device_bytes(self, tenant: str,
                             ledger_map: Optional[Dict[str, int]]
                             = None) -> int:
        """Device bytes currently attributed to the tenant's live
        server tasks."""
        if self._device_bytes_fn is not None:
            return int(self._device_bytes_fn(tenant))
        if ledger_map is None:
            ledger_map = self._ledger_tenant_bytes()
        return ledger_map.get(tenant, 0)

    def _tenant_bytes_snapshot(self) -> Dict[str, int]:
        # ledger fold outside the server lock (see submit)
        ledger_map = (None if self._device_bytes_fn is not None
                      else self._ledger_tenant_bytes())
        with self._lock:
            tenants = sorted(set(self._task_tenant.values())
                             | set(self._tenant_stats))
        return {t: self._tenant_device_bytes(t, ledger_map)
                for t in tenants}

    def _publish_gauges_locked(self, tenant: str,
                               bytes_for: Optional[dict] = None) -> None:
        """Refresh ONE tenant's gauges — per-transition gauge work
        must not scale with every tenant the server ever saw."""
        _obs.set_server_tenant_gauges(
            queued={tenant: self._sched.queued_for(tenant)},
            running={tenant: self._running.get(tenant, 0)},
            deficit={tenant:
                     self._sched.deficit().get(tenant, 0.0)},
            device_bytes=bytes_for or {})
