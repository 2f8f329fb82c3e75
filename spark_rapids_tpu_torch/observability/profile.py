"""Per-query profiles: EXPLAIN ANALYZE for every query.

The reference ships a dedicated profiler sidecar (``profiler/``: CUPTI
activity capture -> flatbuffers -> ``profile_converter``) because
process-wide counters never answer "where did *this query's* time
go".  The rest of the telemetry has the same gap: metrics, spans, journal
and flight recorder are all process-scoped rings.  This module closes
it by assembling, at query end, ONE typed artifact per query from
seams that already exist:

  * stage records   — plan/compiler.py reports every stage execution
                      (plan digest, fused/unfused engine, wall ns,
                      compile-vs-cache-hit, dispatch count, per-input
                      rows/bucket/pad-waste) while a session is
                      active on the executing thread;
  * metric deltas   — per-task rows from the RmmSpark-bound
                      :class:`TaskMetricsTable` plus registry family
                      deltas (``srt_shuffle_link_*`` per-peer bytes,
                      jit-cache hits/misses) between begin and end;
  * journal window  — retry/OOM episodes, kernel-path and calibration
                      events scoped to the session's thread/tasks by
                      the records' own attribution fields;
  * spans           — finished spans keyed by the query-root
                      trace_id captured at begin.

``world=N`` rank profiles merge into ONE fleet profile
(:func:`merge_profiles`): the launcher-seeded trace context proves the
ranks belong together, per-stage wall is the max over ranks (the
critical path), and the per-rank walls survive as a skew table.
:func:`diff_profiles` compares two profiles per stage and flags
regressions beyond a threshold — the per-node guardrail the
bench-trajectory BENCH_* files cannot give.

Cost discipline (the tracer's noop contract): with profiling disabled
every hook is ONE attribute read — ``begin`` returns None, ``end(None)``
returns None, ``active()`` is False before any dict is touched — so
``SPARK_RAPIDS_TPU_PROFILE=0`` adds no measurable per-query overhead.

The module is dependency-free within the package: the journal, task
table, tracer and registry are injected by ``observability/__init__``
(the ``enabled_ref`` pattern), so tests build isolated profilers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from spark_rapids_tpu_torch.analysis.lockdep import make_lock

PROFILE_VERSION = 1

# registry families whose begin->end deltas ride the artifact (kept
# small on purpose: the profile stores deltas, never whole snapshots)
_DELTA_FAMILIES = (
    "srt_shuffle_link_bytes_total",
    "srt_shuffle_link_msgs_total",
    "srt_jit_cache_hits_total",
    "srt_jit_cache_misses_total",
)

# journal kinds folded into the artifact when their ``thread`` (or
# ``task``) attribution matches the session
_THREAD_KINDS = ("retry_episode", "kernel_path", "oom_retry",
                 "oom_split_retry", "thread_unblocked",
                 "shuffle_wire", "shuffle_wait",
                 "spill", "spill_restore", "spill_wait",
                 "spill_corrupt", "result_cache")

# the TaskMetricsTable's shared fallback row (threads with no RmmSpark
# binding).  It is process-wide, so its deltas are only trustworthy
# when this session was ALONE for its whole lifetime — a concurrent
# session's ops would otherwise leak into this profile's attribution
_UNATTRIBUTED = -1


def _family_values(fam: Optional[dict]) -> Dict[tuple, float]:
    """{label tuple: value} for one counter/gauge family snapshot
    (missing family = empty)."""
    out: Dict[tuple, float] = {}
    for s in (fam or {}).get("series", []):
        out[tuple(s.get("labels") or ())] = s.get("value", 0)
    return out


def _family_of(registry, name: str) -> Optional[dict]:
    """One family's snapshot WITHOUT walking the whole registry
    (``family_snapshot`` where available; a duck-typed registry
    falls back to its full snapshot)."""
    if registry is None:
        return None
    fn = getattr(registry, "family_snapshot", None)
    if fn is not None:
        return fn(name)
    return (registry.snapshot() or {}).get(name)


def _delta(now: Dict[tuple, float],
           base: Dict[tuple, float]) -> Dict[tuple, float]:
    out = {}
    for k, v in now.items():
        d = v - base.get(k, 0)
        if d:
            out[k] = d
    return out


class ProfileSession:
    """One query being profiled on one thread.  Created by
    :meth:`QueryProfiler.begin`; everything here is a begin-time
    snapshot the assembly diffs against."""

    __slots__ = ("query_id", "tenant", "query", "rank", "world",
                 "queue_wait_ns", "thread", "t0_ns", "t0_unix_ms",
                 "seq0", "trace_id", "task_ids", "task_base",
                 "registry_base", "stage_records", "shared")

    def __init__(self, query_id: str, tenant: str, query: str,
                 rank: int, world: int, *, thread: int, seq0: int,
                 trace_id: Optional[str], task_ids: List[int],
                 task_base: Dict[int, dict], registry_base: dict,
                 queue_wait_ns: int = 0):
        self.query_id = query_id
        self.tenant = tenant
        self.query = query
        self.rank = rank
        self.world = world
        self.queue_wait_ns = queue_wait_ns
        self.thread = thread
        self.t0_ns = time.monotonic_ns()
        self.t0_unix_ms = int(time.time() * 1000)
        self.seq0 = seq0
        self.trace_id = trace_id
        self.task_ids = task_ids
        self.task_base = task_base
        self.registry_base = registry_base
        self.stage_records: List[dict] = []
        # another session overlapped this one at some point: the
        # shared UNATTRIBUTED task row is no longer this query's
        self.shared = False


class QueryProfiler:
    """Process-wide per-query profile assembler.

    ``journal``/``tasks``/``tracer``/``registry`` are the live
    observability singletons (or test doubles); ``keep`` bounds the
    finished-profile ring; ``on_profile(profile, assembly_ns)`` is the
    accounting hook ``observability/__init__`` points at the
    ``srt_profile_*`` families."""

    def __init__(self, journal=None, tasks=None, tracer=None,
                 registry=None, keep: int = 16,
                 on_profile: Optional[Callable[[dict, int], None]]
                 = None,
                 on_drop: Optional[Callable[[str], None]] = None):
        self.enabled = False
        self.journal = journal
        self.tasks = tasks
        self.tracer = tracer
        self.registry = registry
        self.on_profile = on_profile
        self.on_drop = on_drop
        self._lock = make_lock("observability.profile")
        self._sessions: Dict[int, ProfileSession] = {}
        # keep <= 0 disables retention (the server-side knob's 0=off
        # contract): profiles are still assembled and returned, but
        # last()/retained() stay empty and bundles carry no
        # profile.json
        self._keep = max(int(keep), 0)
        self._retained: deque = deque(maxlen=max(self._keep, 1))
        self._assembled = 0
        self._dropped: Dict[str, int] = {}

    # ------------------------------------------------------------ state

    def active(self) -> bool:
        """Is a session open on the calling thread?  ONE attribute
        read when profiling is off (the hot-path guard the compiler
        hook uses before building any stage record)."""
        if not self.enabled:
            return False
        return threading.get_ident() in self._sessions

    def _drop(self, reason: str) -> None:
        with self._lock:
            self._dropped[reason] = self._dropped.get(reason, 0) + 1
        hook = self.on_drop
        if hook is not None:
            try:
                hook(reason)
            except Exception:
                pass  # accounting must never break the query path

    # ------------------------------------------------------------ begin

    def begin(self, query_id: str, tenant: str = "", query: str = "",
              rank: int = 0, world: int = 1, queue_wait_ns: int = 0
              ) -> Optional[ProfileSession]:
        """Open a session bound to the CALLING thread (the thread the
        stage executions will run on).  Returns None when disabled, or
        when the thread already profiles a query (the outer session
        wins; the nested begin is counted dropped).  ``queue_wait_ns``
        is the server's admission-to-dispatch wait: the profile's own
        wall starts at begin, so the pre-dispatch story must be handed
        in for the attribution ledger to see the whole
        admission-to-result wall."""
        if not self.enabled:
            return None
        thread = threading.get_ident()
        with self._lock:
            if thread in self._sessions:
                nested = True
            else:
                nested = False
                self._sessions[thread] = None  # reserve before the
                #                                snapshots below
        if nested:
            self._drop("nested")
            return None
        # snapshots OUTSIDE the profiler lock (registry/task locks are
        # theirs to take; ours only guards the session map), and
        # inside the same never-fail-the-query umbrella end() has —
        # a snapshot failure must also release the reservation, or
        # this thread reads "nested" forever and profiling dies on it
        try:
            trace_id = None
            if self.tracer is not None:
                ctx = self.tracer.current_context()
                if ctx is not None:
                    trace_id = f"{ctx.trace_id:016x}"
            task_ids = (list(self.tasks.tasks_for(thread))
                        if self.tasks is not None else [])
            task_base = {}
            if self.tasks is not None:
                rollup = self.tasks.rollup()
                task_base = {t: rollup[t] for t in task_ids
                             if t in rollup}
            registry_base = {
                name: _family_values(_family_of(self.registry, name))
                for name in _DELTA_FAMILIES} \
                if self.registry is not None else {}
            sess = ProfileSession(
                str(query_id), str(tenant), str(query), int(rank),
                int(world), thread=thread,
                seq0=(self.journal.total_emitted
                      if self.journal is not None else 0),
                trace_id=trace_id, task_ids=task_ids,
                task_base=task_base, registry_base=registry_base,
                queue_wait_ns=max(int(queue_wait_ns), 0))
        except Exception:
            with self._lock:
                if self._sessions.get(thread) is None:
                    self._sessions.pop(thread, None)
            self._drop("begin_error")
            return None
        with self._lock:
            self._sessions[thread] = sess
            if len(self._sessions) > 1:
                # overlapping sessions share the process-wide
                # UNATTRIBUTED task row — mark EVERY live session so
                # none of them claims that row's deltas as its own
                for s in self._sessions.values():
                    if s is not None:
                        s.shared = True
        return sess

    # ----------------------------------------------------- stage feed

    def note_stage(self, record: dict) -> None:
        """One stage execution on the calling thread (plan/compiler's
        hook).  Callers gate on :meth:`active` so a disabled run never
        builds the record dict."""
        if not self.enabled:
            return
        sess = self._sessions.get(threading.get_ident())
        if sess is None:
            self._drop("no_session")
            return
        if len(sess.stage_records) < 4096:  # runaway-loop backstop
            sess.stage_records.append(record)

    # -------------------------------------------------------------- end

    def end(self, session: Optional[ProfileSession]
            ) -> Optional[dict]:
        """Close the session and assemble the profile artifact.
        ``end(None)`` (the disabled begin's return) is a no-op.  The
        artifact is retained in the last-K ring AND returned."""
        if session is None:
            return None
        t_end_ns = time.monotonic_ns()
        with self._lock:
            if self._sessions.get(session.thread) is session:
                del self._sessions[session.thread]
        t0 = time.monotonic_ns()
        try:
            profile = self._assemble(session, t_end_ns)
        except Exception:
            # a profile must never fail the query it describes
            self._drop("assembly_error")
            return None
        assembly_ns = time.monotonic_ns() - t0
        with self._lock:
            if self._keep > 0:
                self._retained.append(profile)
            self._assembled += 1
        hook = self.on_profile
        if hook is not None:
            try:
                hook(profile, assembly_ns)
            except Exception:
                pass
        return profile

    def note_external(self, profile: dict) -> Optional[dict]:
        """Retain an externally-assembled profile (a warm cache hit
        never opens a session — there is no execution to observe —
        but its artifact must still land in the last-K ring and fire
        the profile-end hook so attribution and retention see it)."""
        if not self.enabled:
            return None
        with self._lock:
            if self._keep > 0:
                self._retained.append(profile)
            self._assembled += 1
        hook = self.on_profile
        if hook is not None:
            try:
                hook(profile, 0)
            except Exception:
                pass
        return profile

    # -------------------------------------------------------- assembly

    def _assemble(self, sess: ProfileSession, t_end_ns: int) -> dict:
        stages = self._fold_stages(sess.stage_records)
        hot = max(stages, key=lambda s: s["wall_ns"], default=None)
        profile = {
            "profile_version": PROFILE_VERSION,
            "query_id": sess.query_id,
            "tenant": sess.tenant,
            "query": sess.query,
            "rank": sess.rank,
            "world": sess.world,
            "trace_id": sess.trace_id,
            "t_unix_ms": sess.t0_unix_ms,
            "wall_ns": t_end_ns - sess.t0_ns,
            "queue_wait_ns": sess.queue_wait_ns,
            "stages": stages,
            "hot_stage": hot["stage"] if hot else None,
        }
        profile.update(self._fold_journal(sess))
        profile.update(self._fold_tasks(sess))
        profile.update(self._fold_registry(sess))
        profile.update(self._fold_spans(sess))
        return profile

    @staticmethod
    def _fold_stages(records: List[dict]) -> List[dict]:
        """Aggregate raw stage executions per (stage, digest, engine)
        in first-execution order — a capacity-retry re-run folds into
        its row as another call."""
        order: List[tuple] = []
        agg: Dict[tuple, dict] = {}
        for r in records:
            key = (r.get("stage"), r.get("digest"), r.get("engine"))
            a = agg.get(key)
            if a is None:
                a = dict(r)
                a["calls"] = 0
                a["wall_ns"] = 0
                a["compiled"] = False
                a["compile_ns"] = 0
                agg[key] = a
                order.append(key)
            a["calls"] += 1
            a["wall_ns"] += int(r.get("wall_ns", 0))
            a["compiled"] = a["compiled"] or bool(r.get("compiled"))
            a["compile_ns"] += int(r.get("compile_ns", 0))
            # the dispatch window widens to cover every execution
            if "t_end_ns" in r:
                a["t_end_ns"] = max(int(a.get("t_end_ns", 0)),
                                    int(r["t_end_ns"]))
            # per-node data statistics: last execution
            # wins — counts describe one run, not a sum over retries
            if r.get("stats") is not None:
                a["stats"] = r["stats"]
        return [agg[k] for k in order]

    def _fold_journal(self, sess: ProfileSession) -> dict:
        if self.journal is None:
            return {"retries": {}, "oom": {}, "kernel_paths": {},
                    "events": {}, "shuffle": {}, "spill": {},
                    "cache": {}}
        window = [r for r in self.journal.records()
                  if r.get("seq", 0) > sess.seq0]
        tasks = set(sess.task_ids)

        def mine(r: dict) -> bool:
            if r.get("thread") == sess.thread:
                return True
            t = r.get("task")
            if isinstance(t, list):
                return bool(tasks.intersection(t))
            return t in tasks if t is not None else False

        retries = {"episodes": 0, "attempts": 0, "splits": 0,
                   "lost_ns": 0, "outcomes": {}}
        oom = {"retry": 0, "split_retry": 0, "blocked_ns": 0}
        shuffle = {"wire_ns": 0, "wait_ns": 0, "spec_wait_ns": 0}
        spill = {"bytes": 0, "spills": 0, "restores": 0, "ns": 0,
                 "wait_ns": 0, "corrupt": 0, "tiers": {}}
        cache = {"hits": 0, "misses": 0, "puts": 0, "evictions": 0,
                 "folds": 0, "lookup_ns": 0, "bytes": 0}
        kernel_paths: Dict[str, int] = {}
        events: Dict[str, int] = {}
        for r in window:
            kind = r.get("kind", "?")
            # the per-kind counts honor the same attribution filter
            # as the folds below: a record another thread/task wrote
            # during the window is that query's story, not this one's
            if not mine(r):
                continue
            events[kind] = events.get(kind, 0) + 1
            if kind not in _THREAD_KINDS:
                continue
            if kind == "retry_episode":
                retries["episodes"] += 1
                retries["attempts"] += int(r.get("attempts", 0))
                retries["splits"] += int(r.get("splits", 0))
                retries["lost_ns"] += int(r.get("lost_ns", 0))
                out = str(r.get("outcome", "?"))
                retries["outcomes"][out] = \
                    retries["outcomes"].get(out, 0) + 1
            elif kind == "oom_retry":
                oom["retry"] += 1
            elif kind == "oom_split_retry":
                oom["split_retry"] += 1
            elif kind == "thread_unblocked":
                oom["blocked_ns"] += int(r.get("blocked_ns", 0))
            elif kind == "kernel_path":
                k = f"{r.get('op', '?')}:{r.get('path', '?')}"
                kernel_paths[k] = kernel_paths.get(k, 0) + 1
            elif kind == "shuffle_wire":
                shuffle["wire_ns"] += int(r.get("wire_ns", 0))
            elif kind == "shuffle_wait":
                shuffle["wait_ns"] += int(r.get("wait_ns", 0))
                shuffle["spec_wait_ns"] += int(r.get("spec_ns", 0))
            elif kind == "spill":
                spill["spills"] += 1
                spill["bytes"] += int(r.get("bytes", 0))
                spill["ns"] += int(r.get("ns", 0))
                tier = str(r.get("tier", "?"))
                spill["tiers"][tier] = spill["tiers"].get(tier, 0) + 1
            elif kind == "spill_restore":
                spill["restores"] += 1
                spill["ns"] += int(r.get("ns", 0))
            elif kind == "spill_wait":
                spill["wait_ns"] += int(r.get("ns", 0))
            elif kind == "spill_corrupt":
                spill["corrupt"] += 1
            elif kind == "result_cache":
                ev = str(r.get("event", "?"))
                if ev == "hit":
                    cache["hits"] += 1
                    cache["lookup_ns"] += int(r.get("ns", 0))
                elif ev == "miss":
                    cache["misses"] += 1
                    cache["lookup_ns"] += int(r.get("ns", 0))
                elif ev == "put":
                    cache["puts"] += 1
                    cache["bytes"] += int(r.get("bytes", 0))
                elif ev == "eviction":
                    cache["evictions"] += 1
                elif ev == "fold":
                    cache["folds"] += 1
        return {"retries": retries, "oom": oom, "shuffle": shuffle,
                "spill": spill, "kernel_paths": kernel_paths,
                "events": events, "cache": cache}

    def _fold_tasks(self, sess: ProfileSession) -> dict:
        """Per-task metric deltas for the session's RmmSpark-bound
        tasks (ops seen by OTHER tasks between begin and end never
        leak in — this is the task-scoped attribution the issue
        demands).  The shared UNATTRIBUTED fallback row only counts
        when this session was ALONE for its whole lifetime: under
        overlapping sessions (an adaptorless server pool) that row
        mixes every thread's ops, so claiming it would attribute a
        neighbor tenant's work to this query."""
        if self.tasks is None:
            return {"ops": {}, "tasks": {}}
        rollup = self.tasks.rollup()
        # tasks bound DURING the query (the server registers the rmm
        # task before the runner starts, but a late pool binding must
        # still attribute) are unioned with the begin-time set
        ids = set(sess.task_ids) | \
            set(self.tasks.tasks_for(sess.thread))
        if sess.shared:
            ids.discard(_UNATTRIBUTED)
        ops: Dict[str, dict] = {}
        tasks_out: Dict[str, dict] = {}
        for tid in sorted(ids):
            now = rollup.get(tid)
            if now is None:
                continue
            base = sess.task_base.get(tid, {})
            base_ops = base.get("ops", {})
            row = {}
            for field in ("shuffle_write_bytes", "shuffle_merge_rows",
                          "retry_oom", "split_retry_oom",
                          "blocked_time_ns", "lost_time_ns"):
                d = now.get(field, 0) - base.get(field, 0)
                if d:
                    row[field] = d
            for op, o in now.get("ops", {}).items():
                b = base_ops.get(op, {})
                calls = o.get("calls", 0) - b.get("calls", 0)
                t_ns = o.get("time_ns", 0) - b.get("time_ns", 0)
                if calls or t_ns:
                    a = ops.setdefault(op, {"calls": 0, "time_ns": 0})
                    a["calls"] += calls
                    a["time_ns"] += t_ns
            if row:
                tasks_out[str(tid)] = row
        return {"ops": ops, "tasks": tasks_out}

    def _per_peer_delta(self, base: dict,
                        name: str) -> Dict[str, Dict[str, int]]:
        """{direction: {peer: delta}} for one (direction, peer)
        labelled link family."""
        out: Dict[str, Dict[str, int]] = {}
        for labels, d in _delta(
                _family_values(_family_of(self.registry, name)),
                base.get(name, {})).items():
            direction = labels[0] if labels else "?"
            peer = labels[1] if len(labels) > 1 else "?"
            out.setdefault(direction, {})[peer] = int(d)
        return out

    def _fold_registry(self, sess: ProfileSession) -> dict:
        if self.registry is None:
            return {"shuffle_links": {}, "jit": {}}
        links = self._per_peer_delta(
            sess.registry_base, "srt_shuffle_link_bytes_total")
        msgs = self._per_peer_delta(
            sess.registry_base, "srt_shuffle_link_msgs_total")
        jit: Dict[str, dict] = {}
        for name, field in (("srt_jit_cache_hits_total", "hits"),
                            ("srt_jit_cache_misses_total", "misses")):
            for labels, d in _delta(
                    _family_values(_family_of(self.registry, name)),
                    sess.registry_base.get(name, {})).items():
                kernel = labels[0] if labels else "?"
                jit.setdefault(kernel, {})[field] = int(d)
        out = {"shuffle_links": {"bytes": links}, "jit": jit}
        if msgs:
            out["shuffle_links"]["msgs"] = msgs
        return out

    def _fold_spans(self, sess: ProfileSession) -> dict:
        if self.tracer is None or sess.trace_id is None:
            return {"spans": {}}
        by_kind: Dict[str, int] = {}
        n = 0
        for r in self.tracer.records():
            if r.get("trace_id") != sess.trace_id:
                continue
            n += 1
            k = r.get("span_kind", "?")
            by_kind[k] = by_kind.get(k, 0) + 1
        return {"spans": {"count": n, "by_kind": by_kind}}

    # ------------------------------------------------------------- read

    def last(self) -> Optional[dict]:
        """Most recently assembled profile (what a flight-recorder
        bundle freezes as ``profile.json``)."""
        with self._lock:
            return self._retained[-1] if self._retained else None

    def retained(self) -> List[dict]:
        with self._lock:
            return list(self._retained)

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "active_sessions": len(self._sessions),
                    "assembled": self._assembled,
                    "retained": len(self._retained),
                    "dropped": dict(self._dropped)}

    def reset(self) -> None:
        with self._lock:
            self._sessions.clear()
            self._retained.clear()
            self._assembled = 0
            self._dropped.clear()


# ------------------------------------------------------------ fleet merge


def merge_profiles(profiles: List[dict]) -> dict:
    """Merge ``world=N`` rank profiles into ONE fleet profile.

    The launcher-seeded trace context is the join key: all ranks of
    one query share a trace_id, and the merge records whether that
    held (``trace_consistent``).  Per-stage wall is the MAX over ranks
    — the critical path a reader cares about — while every rank's own
    wall survives in the per-stage ``per_rank_wall_ns`` map and the
    ``skew`` table (max/min ratio per stage).  Shuffle-link bytes keep
    per-rank resolution (that is the per-link skew evidence ROADMAP
    item 3 wants)."""
    if not profiles:
        raise ValueError("merge_profiles: no profiles given")
    if len(profiles) == 1:
        return dict(profiles[0])
    ranks = []
    seen = set()
    for i, p in enumerate(profiles):
        r = int(p.get("rank", i))
        if r in seen:           # two single-process dumps: reindex
            r = max(seen) + 1
        seen.add(r)
        ranks.append(r)
    trace_ids = {p.get("trace_id") for p in profiles
                 if p.get("trace_id")}
    # "consistent" is a positive claim: EVERY profile must carry the
    # SAME trace id.  Profiles without ids (tracing off) cannot prove
    # they belong to one fleet, so the merge flags them rather than
    # silently blessing unrelated runs
    consistent = len(trace_ids) == 1 and \
        all(p.get("trace_id") for p in profiles)
    order: List[tuple] = []
    agg: Dict[tuple, dict] = {}
    for rank, p in zip(ranks, profiles):
        for s in p.get("stages", []):
            key = (s.get("stage"), s.get("digest"))
            a = agg.get(key)
            if a is None:
                a = dict(s)
                a["calls"] = 0
                a["wall_ns"] = 0
                a["compiled"] = False
                a["per_rank_wall_ns"] = {}
                agg[key] = a
                order.append(key)
            a["calls"] += int(s.get("calls", 1))
            a["compiled"] = a["compiled"] or bool(s.get("compiled"))
            w = int(s.get("wall_ns", 0))
            a["per_rank_wall_ns"][str(rank)] = \
                a["per_rank_wall_ns"].get(str(rank), 0) + w
            engines = {s.get("engine"), a.get("engine")}
            if len(engines - {None}) > 1:
                a["engine"] = "mixed"
            # per-node data statistics: rows SUM across
            # ranks (each rank saw its shard), every rank's own count
            # survives in per_rank_rows, and a misestimate flagged by
            # ANY rank stays flagged
            st = s.get("stats")
            if st is not None:
                ms = a.get("stats")
                if ms is None or "_idx" not in ms:
                    ms = {"version": st.get("version"),
                          "epochs": st.get("epochs"),
                          "rows_in": 0, "rows_out": None,
                          "nodes": [], "_idx": {}}
                    a["stats"] = ms
                ms["rows_in"] += int(st.get("rows_in") or 0)
                if st.get("rows_out") is not None:
                    ms["rows_out"] = ((ms["rows_out"] or 0)
                                      + int(st["rows_out"]))
                for n in st.get("nodes", []):
                    mn = ms["_idx"].get(n["node"])
                    if mn is None:
                        mn = dict(n)
                        mn["rows"] = 0
                        mn["per_rank_rows"] = {}
                        ms["_idx"][n["node"]] = mn
                        ms["nodes"].append(mn)
                    mn["rows"] += int(n.get("rows", 0))
                    mn["per_rank_rows"][str(rank)] = \
                        int(n.get("rows", 0))
                    if n.get("misestimate"):
                        mn["misestimate"] = True
                        mn["ratio"] = max(float(n.get("ratio", 0)),
                                          float(mn.get("ratio", 0)))
    skew = []
    for key in order:
        a = agg[key]
        walls = a["per_rank_wall_ns"]
        a["wall_ns"] = max(walls.values(), default=0)
        lo = min(walls.values(), default=0)
        row = {"stage": a["stage"], "digest": a.get("digest"),
               "per_rank_wall_ns": dict(walls),
               "max_wall_ns": a["wall_ns"], "min_wall_ns": lo}
        row["skew_ratio"] = (round(a["wall_ns"] / lo, 3)
                             if lo > 0 else None)
        skew.append(row)
    stages = [agg[k] for k in order]
    for s in stages:
        if isinstance(s.get("stats"), dict):
            s["stats"].pop("_idx", None)
    hot = max(stages, key=lambda s: s["wall_ns"], default=None)

    def _sum_field(field: str, sub: Optional[str] = None) -> dict:
        out: Dict[str, float] = {}
        for p in profiles:
            d = p.get(field) or {}
            if sub is not None:
                d = d.get(sub) or {}
            for k, v in d.items():
                if isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
        return out

    merged = {
        "profile_version": PROFILE_VERSION,
        "fleet": True,
        "world": max([int(p.get("world", 1)) for p in profiles]
                     + [len(profiles)]),
        "ranks": sorted(ranks),
        "query": profiles[0].get("query"),
        "query_id": profiles[0].get("query_id"),
        "tenant": profiles[0].get("tenant"),
        "trace_id": (next(iter(trace_ids))
                     if len(trace_ids) == 1 else None),
        "trace_consistent": consistent,
        "t_unix_ms": min(int(p.get("t_unix_ms", 0))
                         for p in profiles),
        "wall_ns": max(int(p.get("wall_ns", 0)) for p in profiles),
        "queue_wait_ns": max(int(p.get("queue_wait_ns", 0) or 0)
                             for p in profiles),
        "per_rank_wall_ns": {str(r): int(p.get("wall_ns", 0))
                             for r, p in zip(ranks, profiles)},
        "stages": stages,
        "hot_stage": hot["stage"] if hot else None,
        "skew": skew,
        "shuffle_links": {
            "per_rank": {str(r): p.get("shuffle_links") or {}
                         for r, p in zip(ranks, profiles)}},
        "retries": {k: int(v) for k, v in
                    _sum_field("retries").items()},
        "oom": {k: int(v) for k, v in _sum_field("oom").items()},
        "shuffle": {k: int(v) for k, v in
                    _sum_field("shuffle").items()},
        "spill": {k: int(v) for k, v in
                  _sum_field("spill").items()},
        "cache": {k: int(v) for k, v in
                  _sum_field("cache").items()},
        "kernel_paths": {k: int(v) for k, v in
                         _sum_field("kernel_paths").items()},
    }
    return merged


# ------------------------------------------------------------------ diff


def diff_profiles(baseline: dict, current: dict, *,
                  threshold: float = 1.5,
                  min_delta_ns: int = 1_000_000) -> List[dict]:
    """Per-stage regression check: flag every stage whose mean wall
    per call grew past ``threshold`` x the baseline AND by more than
    ``min_delta_ns`` (the floor keeps micro-stage jitter out).
    Stages are matched by NAME (a re-tuned plan changes its digest but
    remains the same logical stage).  Stages present ONLY in the
    baseline — dropped by a re-plan — are reported as ``removed`` rows
    (a vanished stage is a plan change worth seeing, not a silent
    no-op), after the regressions.  Returns findings, most-regressed
    first; regressions carry ``kind == "regression"``; an output with
    only ``removed`` rows means no wall regression."""

    def per_stage(p: dict) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for s in p.get("stages", []):
            a = out.setdefault(str(s.get("stage")),
                               {"calls": 0, "wall_ns": 0})
            a["calls"] += int(s.get("calls", 1))
            a["wall_ns"] += int(s.get("wall_ns", 0))
        for a in out.values():
            a["mean_ns"] = (a["wall_ns"] / a["calls"]
                            if a["calls"] else 0.0)
        return out

    base, cur = per_stage(baseline), per_stage(current)
    findings: List[dict] = []
    for stage, c in cur.items():
        b = base.get(stage)
        if b is None or b["mean_ns"] <= 0:
            continue        # new stages are a plan change, not a
            #                 wall regression
        ratio = c["mean_ns"] / b["mean_ns"]
        if ratio >= threshold \
                and c["mean_ns"] - b["mean_ns"] >= min_delta_ns:
            findings.append({
                "stage": stage,
                "kind": "regression",
                "base_mean_ms": round(b["mean_ns"] / 1e6, 3),
                "cur_mean_ms": round(c["mean_ns"] / 1e6, 3),
                "ratio": round(ratio, 2),
            })
    findings.sort(key=lambda f: -f["ratio"])
    for stage in sorted(set(base) - set(cur)):
        b = base[stage]
        findings.append({
            "stage": stage,
            "kind": "removed",
            "base_mean_ms": round(b["mean_ns"] / 1e6, 3),
            "base_calls": b["calls"],
        })
    return findings
