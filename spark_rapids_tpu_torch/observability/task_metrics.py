"""Per-task metrics accumulation keyed by the Spark task ids the OOM
runtime already tracks.

The reference rolls numbers up per Spark task through RmmSpark's
getAndReset* surface (task threads register via
setCurrentThreadAsTask / poolThreadWorkingOnTasks, and the native
adaptor checkpoints per-thread metrics into per-task buckets —
SparkResourceAdaptorJni.cpp).  This table is the cross-subsystem
generalization: the SAME thread→task binding (fed by
memory/rmm_spark.py registration wrappers) attributes op latencies,
shuffle bytes, and journal events to tasks, and the OOM state
machine's own per-task counters are folded in when a task finishes.

Threads with no task binding accumulate under task id -1 so driver-side
/ test-harness activity still shows up in reports instead of vanishing.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Set

UNATTRIBUTED = -1


class TaskMetrics:
    """One task's accumulated numbers (observability-wide superset of
    memory.spark_resource_adaptor.TaskMetrics, which stays the OOM state
    machine's internal type)."""

    __slots__ = ("op_calls", "op_time_ns", "shuffle_write_bytes",
                 "shuffle_write_time_ns", "shuffle_merge_rows",
                 "shuffle_merge_time_ns", "retry_oom", "split_retry_oom",
                 "blocked_time_ns", "lost_time_ns", "max_device_memory",
                 "events")

    def __init__(self):
        self.op_calls: Dict[str, int] = {}
        self.op_time_ns: Dict[str, int] = {}
        self.shuffle_write_bytes = 0
        self.shuffle_write_time_ns = 0
        self.shuffle_merge_rows = 0
        self.shuffle_merge_time_ns = 0
        self.retry_oom = 0
        self.split_retry_oom = 0
        self.blocked_time_ns = 0
        self.lost_time_ns = 0
        self.max_device_memory = 0
        self.events = 0

    def as_dict(self) -> dict:
        return {
            "ops": {op: {"calls": self.op_calls[op],
                         "time_ns": self.op_time_ns.get(op, 0)}
                    for op in sorted(self.op_calls)},
            "shuffle_write_bytes": self.shuffle_write_bytes,
            "shuffle_write_time_ns": self.shuffle_write_time_ns,
            "shuffle_merge_rows": self.shuffle_merge_rows,
            "shuffle_merge_time_ns": self.shuffle_merge_time_ns,
            "retry_oom": self.retry_oom,
            "split_retry_oom": self.split_retry_oom,
            "blocked_time_ns": self.blocked_time_ns,
            "lost_time_ns": self.lost_time_ns,
            "max_device_memory": self.max_device_memory,
            "events": self.events,
        }


class TaskMetricsTable:
    """Thread→task binding plus per-task accumulators.

    Bindings mirror the RmmSpark registration calls 1:1 (dedicated task
    threads bind to one task, pool/shuffle threads to a set); the
    adaptor's remove-thread callback unbinds, so the two maps cannot
    drift."""

    def __init__(self, enabled_ref=None):
        self._enabled_ref = enabled_ref
        self._lock = threading.Lock()
        self._thread_tasks: Dict[int, Set[int]] = {}
        self._tasks: Dict[int, TaskMetrics] = {}

    def _on(self) -> bool:
        ref = self._enabled_ref
        return ref is None or ref.enabled

    # --------------------------------------------------------- bindings

    # Bindings are NOT gated on the enabled switch: they must mirror the
    # RmmSpark registration calls even while metrics are off, or an
    # off-window unbind is lost and a reused thread ident misattributes
    # later work to a finished task.  They are rare (per task, not per
    # op), so the always-on cost is a dict op at task registration.

    def bind_thread(self, thread_id: int, task_ids: Iterable[int]):
        with self._lock:
            self._thread_tasks.setdefault(thread_id, set()).update(task_ids)

    def unbind_thread(self, thread_id: int,
                      task_ids: Optional[Iterable[int]] = None):
        with self._lock:
            cur = self._thread_tasks.get(thread_id)
            if cur is None:
                return
            if task_ids is None:
                del self._thread_tasks[thread_id]
            else:
                cur.difference_update(task_ids)
                if not cur:
                    del self._thread_tasks[thread_id]

    def tasks_for(self, thread_id: Optional[int] = None) -> List[int]:
        if thread_id is None:
            thread_id = threading.get_ident()
        with self._lock:
            ids = self._thread_tasks.get(thread_id)
            return sorted(ids) if ids else [UNATTRIBUTED]

    # ------------------------------------------------------ accumulation

    def _targets(self, thread_id: Optional[int]) -> List[TaskMetrics]:
        if thread_id is None:
            thread_id = threading.get_ident()
        ids = self._thread_tasks.get(thread_id) or (UNATTRIBUTED,)
        return [self._tasks.setdefault(t, TaskMetrics()) for t in ids]

    def note_op(self, op: str, dur_ns: int,
                thread_id: Optional[int] = None):
        if not self._on():
            return
        with self._lock:
            for tm in self._targets(thread_id):
                tm.op_calls[op] = tm.op_calls.get(op, 0) + 1
                tm.op_time_ns[op] = tm.op_time_ns.get(op, 0) + dur_ns

    def note_shuffle_write(self, num_bytes: int, dur_ns: int,
                           thread_id: Optional[int] = None):
        if not self._on():
            return
        with self._lock:
            for tm in self._targets(thread_id):
                tm.shuffle_write_bytes += num_bytes
                tm.shuffle_write_time_ns += dur_ns

    def note_shuffle_merge(self, rows: int, dur_ns: int,
                           thread_id: Optional[int] = None):
        if not self._on():
            return
        with self._lock:
            for tm in self._targets(thread_id):
                tm.shuffle_merge_rows += rows
                tm.shuffle_merge_time_ns += dur_ns

    def note_event(self, thread_id: Optional[int] = None):
        if not self._on():
            return
        with self._lock:
            for tm in self._targets(thread_id):
                tm.events += 1

    def fold_rmm_task(self, task_id: int, *, retry_oom: int = 0,
                      split_retry_oom: int = 0, blocked_time_ns: int = 0,
                      lost_time_ns: int = 0, max_device_memory: int = 0):
        """Fold the OOM state machine's per-task counters (the
        getAndResetNumRetryThrow / getTotalBlockedOrLostTime analogs)
        into this task's row — called at task_done."""
        if not self._on():
            return
        with self._lock:
            tm = self._tasks.setdefault(task_id, TaskMetrics())
            tm.retry_oom += retry_oom
            tm.split_retry_oom += split_retry_oom
            tm.blocked_time_ns += blocked_time_ns
            tm.lost_time_ns += lost_time_ns
            tm.max_device_memory = max(tm.max_device_memory,
                                       max_device_memory)

    # ------------------------------------------------------------ report

    def rollup(self) -> Dict[int, dict]:
        with self._lock:
            return {t: tm.as_dict() for t, tm in sorted(self._tasks.items())}

    def bound_threads(self) -> Dict[int, List[int]]:
        with self._lock:
            return {tid: sorted(ts)
                    for tid, ts in sorted(self._thread_tasks.items())}

    def reset(self):
        with self._lock:
            self._thread_tasks.clear()
            self._tasks.clear()
