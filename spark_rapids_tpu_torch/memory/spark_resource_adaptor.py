"""The OOM retry/split/BUFN thread state machine.

Re-implements the semantics of the reference SparkResourceAdaptorJni.cpp
(2,903 LoC; design doc docs/memory_management.md) over the reservation
resources in memory/resource.py:

  * 9 thread states (SparkResourceAdaptorJni.cpp:91-104): RUNNING, ALLOC,
    ALLOC_FREE, BLOCKED, BUFN_THROW, BUFN_WAIT, BUFN, SPLIT_THROW,
    REMOVE_THROW.
  * alloc flow (allocate() loop, :2115-2140): pre_alloc -> resource ->
    post_alloc_success / post_alloc_failed; failed+OOM blocks the thread;
    frees flip other ALLOC threads to ALLOC_FREE and wake the highest
    priority BLOCKED thread.
  * deadlock detection (is_in_deadlock :1789): a task is blocked if any
    dedicated thread is blocked and ALL pool threads working for it are
    blocked; all tasks blocked => pick the lowest-priority BLOCKED thread
    to roll back (BUFN_THROW -> GpuRetryOOM), unless it is the only blocked
    thread, in which case it retries once first (is_retry_alloc_before_bufn,
    :1962-1975); all tasks BUFN => pick the highest-priority BUFN thread to
    split (SPLIT_THROW -> GpuSplitAndRetryOOM).
  * thread priority (:349-396): task_priority = MAX_LONG - (task_id + 1),
    pool/shuffle threads (no task) highest; thread id breaks ties.
  * forced-OOM injection hooks (force_retry_oom etc. :955-991) and the
    watchdog entry check_and_break_deadlocks (:1119) — the contract the
    reference test suite (RmmSparkTest.java) drives.
  * CSV transition log with the reference's header/format (:125-200).

This runtime layer is host-side control logic: it never touches device
data and makes no torch call, so holding its lock never waits on the
device.  Reservations are accounting: callers reserve the bytes they are
about to allocate (``allocate``/``deallocate``), as the reference's
RMM adaptor sees them.

OOM events, device-memory samples and task leaks go to the
observability spine (``record_oom_event``, ``record_device_memory``,
``record_task_leak``); each is one switch read while it is off.  Every
reservation and release is also an ``alloc``/``free`` record for a
running profiler that asked for alloc capture
(``utils.profiler.record_alloc``).  ``native_adaptor.py`` binds the C++
port of this state machine (native/spark_resource_adaptor.cpp).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Set

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.memory import exceptions as exc
from spark_rapids_tpu_torch.memory.resource import (AllocationFailed,
                                                    MemoryResource)

MAX_LONG = (1 << 63) - 1

# thread states
UNKNOWN = "UNKNOWN"
THREAD_RUNNING = "THREAD_RUNNING"
THREAD_ALLOC = "THREAD_ALLOC"
THREAD_ALLOC_FREE = "THREAD_ALLOC_FREE"
THREAD_BLOCKED = "THREAD_BLOCKED"
THREAD_BUFN_THROW = "THREAD_BUFN_THROW"
THREAD_BUFN_WAIT = "THREAD_BUFN_WAIT"
THREAD_BUFN = "THREAD_BUFN"
THREAD_SPLIT_THROW = "THREAD_SPLIT_THROW"
THREAD_REMOVE_THROW = "THREAD_REMOVE_THROW"

# oom injection filters (RmmSpark.OomInjectionType)
CPU_OR_GPU = "CPU_OR_GPU"
CPU = "CPU"
GPU = "GPU"

RETRY_LIMIT = 500  # check_before_oom livelock watchdog (:1290)


class _Injection:
    __slots__ = ("hit_count", "skip_count", "filter")

    def __init__(self):
        self.hit_count = 0
        self.skip_count = 0
        self.filter = GPU

    def matches(self, is_for_cpu: bool) -> bool:
        if self.hit_count <= 0 and self.skip_count <= 0:
            return False
        if self.filter == CPU_OR_GPU:
            return True
        return (self.filter == CPU) == is_for_cpu


class TaskMetrics:
    __slots__ = ("num_times_retry_throw", "num_times_split_retry_throw",
                 "time_blocked_nanos", "time_lost_nanos",
                 "gpu_max_memory_allocated", "gpu_memory_active_footprint",
                 "gpu_memory_max_footprint")

    def __init__(self):
        self.num_times_retry_throw = 0
        self.num_times_split_retry_throw = 0
        self.time_blocked_nanos = 0
        self.time_lost_nanos = 0
        self.gpu_max_memory_allocated = 0
        self.gpu_memory_active_footprint = 0
        self.gpu_memory_max_footprint = 0

    def add(self, other: "TaskMetrics"):
        self.num_times_retry_throw += other.num_times_retry_throw
        self.num_times_split_retry_throw += other.num_times_split_retry_throw
        self.time_blocked_nanos += other.time_blocked_nanos
        self.time_lost_nanos += other.time_lost_nanos
        self.gpu_max_memory_allocated = max(self.gpu_max_memory_allocated,
                                            other.gpu_max_memory_allocated)
        # active footprint SUMS across checkpoints: bytes a removed
        # thread still held must survive into the task bucket, or the
        # task_done leak detector goes blind to exactly the leaks that
        # matter (thread died holding memory)
        self.gpu_memory_active_footprint += other.gpu_memory_active_footprint
        self.gpu_memory_max_footprint = max(self.gpu_memory_max_footprint,
                                            other.gpu_memory_max_footprint)


class _ThreadState:
    def __init__(self, thread_id: int, task_id: Optional[int], lock,
                 is_for_shuffle: bool = False):
        self.thread_id = thread_id
        self.task_id = task_id          # None => pool/shuffle thread
        self.pool_task_ids: Set[int] = set()
        self.is_for_shuffle = is_for_shuffle
        self.state = THREAD_RUNNING
        self.is_cpu_alloc = False
        self.pool_blocked = False
        self.is_retry_alloc_before_bufn = False
        self.is_in_spilling = False
        self.num_times_retried = 0
        self.retry_oom = _Injection()
        self.split_and_retry_oom = _Injection()
        self.cudf_exception_injected = 0
        self.metrics = TaskMetrics()
        # ledger counters (survive metric checkpointing: they describe
        # the THREAD, not the task)
        self.alloc_count = 0
        self.dealloc_count = 0
        self.wake = threading.Condition(lock)
        self._block_start: Optional[float] = None
        self._retry_point: float = time.monotonic()

    def priority(self):
        """Sortable priority; larger sorts as higher priority."""
        if self.task_id is None:
            tp = MAX_LONG
        else:
            tp = MAX_LONG - (self.task_id + 1)
        return (tp, self.thread_id)

    def before_block(self):
        self._block_start = time.monotonic()
        _obs.record_oom_event("thread_blocked", thread_id=self.thread_id,
                              task_id=self.task_id,
                              is_cpu=self.is_cpu_alloc)

    def after_block(self):
        if self._block_start is not None:
            blocked_ns = int((time.monotonic() - self._block_start) * 1e9)
            self.metrics.time_blocked_nanos += blocked_ns
            self._block_start = None
            _obs.record_oom_event("thread_unblocked",
                                  thread_id=self.thread_id,
                                  task_id=self.task_id,
                                  blocked_ns=blocked_ns)

    def record_failed_retry_time(self):
        now = time.monotonic()
        self.metrics.time_lost_nanos += int((now - self._retry_point) * 1e9)
        self._retry_point = now

    def record_progress(self):
        self._retry_point = time.monotonic()


class SparkResourceAdaptor:
    """State-machine resource adaptor (one per executor process)."""

    def __init__(self, resource: MemoryResource,
                 log_path: Optional[str] = None):
        self.resource = resource
        self._lock = threading.Lock()
        self._threads: Dict[int, _ThreadState] = {}
        self._checkpointed: Dict[int, TaskMetrics] = {}
        self.gpu_memory_allocated_bytes = 0
        # bounded ring when no file sink: long-lived executors must not
        # accumulate log strings forever
        self._log_rows = collections.deque(maxlen=100_000)
        self._log_file = open(log_path, "w") if log_path else None
        # ThreadStateRegistry callback: the reference's native adaptor
        # calls ThreadStateRegistry.removeThread when an association
        # ends (SparkResourceAdaptorJni.cpp:66-80); set this to the
        # registry's remove_thread to mirror that shape
        self.on_thread_removed = None
        # spill hook (memory/spill.py SpillStore): ensure_headroom(n)
        # frees device bytes synchronously; spillable_bytes() is the
        # cheap probe the deadlock breaker consults before BUFN
        self._spill_hook = None
        self._log("time,op,current thread,op thread,op task,from state,"
                  "to state,notes", raw=True)

    # ------------------------------------------------------------- logging

    def _log(self, row: str, raw: bool = False):
        line = row if raw else f"{time.monotonic():.6f},{row}"
        self._log_rows.append(line)
        if self._log_file:
            self._log_file.write(line + "\n")
            self._log_file.flush()

    def _log_transition(self, t: _ThreadState, to_state: str, notes: str = ""):
        tid = threading.get_ident()
        task = t.task_id if t.task_id is not None else -1
        self._log(f"TRANSITION,{tid},{t.thread_id},{task},{t.state},"
                  f"{to_state},{notes}")

    def _log_status(self, op: str, thread_id: int, task_id, state: str,
                    notes: str = ""):
        tid = threading.get_ident()
        task = task_id if task_id is not None else -1
        self._log(f"{op},{tid},{thread_id},{task},{state},,{notes}")

    def get_log(self) -> List[str]:
        return list(self._log_rows)

    # --------------------------------------------------------- transitions

    def _transition(self, t: _ThreadState, to_state: str, notes: str = ""):
        self._log_transition(t, to_state, notes)
        t.state = to_state

    # ------------------------------------------------------- registration

    def start_dedicated_task_thread(self, thread_id: int, task_id: int):
        with self._lock:
            t = self._threads.get(thread_id)
            if t is not None:
                if t.task_id != task_id:
                    raise ValueError(
                        f"thread {thread_id} already registered to task "
                        f"{t.task_id}")
                return
            t = _ThreadState(thread_id, task_id, self._lock)
            self._threads[thread_id] = t
            self._log_transition(t, THREAD_RUNNING, "dedicated task thread")

    def pool_thread_working_on_tasks(self, is_for_shuffle: bool,
                                     thread_id: int, task_ids):
        with self._lock:
            t = self._threads.get(thread_id)
            if t is None:
                t = _ThreadState(thread_id, None, self._lock,
                                 is_for_shuffle=is_for_shuffle)
                self._threads[thread_id] = t
                self._log_transition(
                    t, THREAD_RUNNING,
                    "shuffle thread" if is_for_shuffle else "pool thread")
            elif t.task_id is not None:
                raise ValueError(
                    f"thread {thread_id} is a dedicated task thread")
            t.pool_task_ids.update(task_ids)

    def pool_thread_finished_for_tasks(self, thread_id: int, task_ids):
        with self._lock:
            for task_id in list(task_ids):
                self._remove_thread_association(thread_id, task_id)

    def remove_thread_association(self, thread_id: int,
                                  task_id: int = -1):
        with self._lock:
            self._remove_thread_association(thread_id, task_id)

    def _remove_thread_association(self, thread_id: int, remove_task_id: int):
        t = self._threads.get(thread_id)
        if t is None:
            return False
        self._checkpoint_metrics(t)
        remove = False
        if remove_task_id < 0:
            remove = True
        elif t.task_id is not None:
            if t.task_id == remove_task_id:
                remove = True
        else:
            t.pool_task_ids.discard(remove_task_id)
            if not t.pool_task_ids:
                remove = True
        ret = False
        if remove:
            if t.state in (THREAD_BLOCKED, THREAD_BUFN):
                self._transition(t, THREAD_REMOVE_THROW)
                t.wake.notify_all()
            else:
                if t.state == THREAD_RUNNING:
                    ret = True
                self._log_transition(t, UNKNOWN)
                del self._threads[thread_id]
                if self.on_thread_removed is not None:
                    try:
                        self.on_thread_removed(thread_id)
                    except Exception:
                        pass  # registry bugs must not corrupt the SM
        return ret

    def task_done(self, task_id: int):
        leaked = 0
        holders: List[dict] = []
        with self._lock:
            # leak detection BEFORE the associations unwind: device
            # bytes still attributed to the finishing task.  The sum
            # includes NEGATIVE footprints — a checkpointed +X whose
            # frees landed on the live thread after the checkpoint
            # shows up as thread -X, and only the net is a leak.
            cp = self._checkpointed.get(task_id)
            if cp is not None and cp.gpu_memory_active_footprint != 0:
                leaked += cp.gpu_memory_active_footprint
                if cp.gpu_memory_active_footprint > 0:
                    holders.append({
                        "thread": -1, "state": "CHECKPOINTED",
                        "bytes":
                        int(cp.gpu_memory_active_footprint)})
            for t in self._threads.values():
                if (t.task_id == task_id
                        or task_id in t.pool_task_ids) \
                        and t.metrics.gpu_memory_active_footprint != 0:
                    leaked += t.metrics.gpu_memory_active_footprint
                    if t.metrics.gpu_memory_active_footprint > 0:
                        holders.append({
                            "thread": t.thread_id, "state": t.state,
                            "bytes":
                            int(t.metrics.gpu_memory_active_footprint)})
            woke_any = False
            for thread_id in list(self._threads.keys()):
                t = self._threads.get(thread_id)
                if t is None:
                    continue
                associated = (t.task_id == task_id
                              or task_id in t.pool_task_ids)
                if associated:
                    if self._remove_thread_association(thread_id, task_id):
                        woke_any = True
            self._wake_up_threads_after_task_finishes()
        if leaked > 0:
            # outside the lock: the leak hook must never run under this
            # adaptor's (non-reentrant) lock
            _obs.record_task_leak(task_id, int(leaked), holders)
        return woke_any

    def force_release_task(self, task_id: int) -> dict:
        """Watchdog entry (the query lifeguard, robustness/lifeguard.py):
        forcibly unwind a HUNG task's thread associations so its held
        accounting and blocked neighbors unblock without waiting for the wedged
        thread to cooperate.  Semantically ``task_done`` — blocked
        associated threads get ``THREAD_REMOVE_THROW`` (they raise
        ``ThreadRemovedException`` if they ever wake), running ones
        are disassociated, waiters are woken — plus a FORCE_RELEASE
        row in the OOM-state log so the transition timeline shows the
        eviction was deliberate.  Returns the affected thread ids and
        the device bytes the task still held."""
        with self._lock:
            affected = []
            held = 0
            for t in self._threads.values():
                if t.task_id == task_id or task_id in t.pool_task_ids:
                    affected.append(t.thread_id)
                    held += int(t.metrics.gpu_memory_active_footprint)
            cp = self._checkpointed.get(task_id)
            if cp is not None:
                held += int(cp.gpu_memory_active_footprint)
            self._log_status(
                "FORCE_RELEASE", affected[0] if affected else -1,
                task_id, "WATCHDOG",
                notes=f"threads={len(affected)} held={held}")
        woke = self.task_done(task_id)
        return {"task": task_id, "threads": affected,
                "held_bytes": held, "woke_any": woke}

    def _checkpoint_metrics(self, t: _ThreadState):
        """Merge a thread's metrics into its task-level checkpoints."""
        task_ids = ([t.task_id] if t.task_id is not None
                    else list(t.pool_task_ids))
        for task_id in task_ids:
            self._checkpointed.setdefault(task_id, TaskMetrics()).add(
                t.metrics)
        t.metrics = TaskMetrics()

    # ------------------------------------------------------ oom injection

    def force_retry_oom(self, thread_id: int, num_ooms: int,
                        oom_filter: str = GPU, skip_count: int = 0):
        self._force(thread_id, "retry_oom", num_ooms, oom_filter, skip_count)

    def force_split_and_retry_oom(self, thread_id: int, num_ooms: int,
                                  oom_filter: str = GPU,
                                  skip_count: int = 0):
        self._force(thread_id, "split_and_retry_oom", num_ooms, oom_filter,
                    skip_count)

    def _force(self, thread_id, which, num_ooms, oom_filter, skip_count):
        with self._lock:
            t = self._threads.get(thread_id)
            if t is None:
                raise ValueError(f"thread {thread_id} is not registered")
            inj = getattr(t, which)
            inj.hit_count = num_ooms
            inj.skip_count = skip_count
            inj.filter = oom_filter

    def force_cudf_exception(self, thread_id: int, num_times: int):
        with self._lock:
            t = self._threads.get(thread_id)
            if t is None:
                raise ValueError(f"thread {thread_id} is not registered")
            t.cudf_exception_injected = num_times

    # ------------------------------------------------------------ queries

    def get_state_of(self, thread_id: int) -> str:
        with self._lock:
            t = self._threads.get(thread_id)
            return t.state if t is not None else UNKNOWN

    # ------------------------------------------------------------ metrics

    def _collect_metric(self, task_id: int, attr: str, reset: bool):
        total = 0
        is_max = attr in ("gpu_max_memory_allocated",
                          "gpu_memory_max_footprint")
        cp = self._checkpointed.get(task_id)
        if cp is not None:
            v = getattr(cp, attr)
            total = max(total, v) if is_max else total + v
            if reset:
                setattr(cp, attr, 0)
        for t in self._threads.values():
            if t.task_id == task_id or task_id in t.pool_task_ids:
                v = getattr(t.metrics, attr)
                total = max(total, v) if is_max else total + v
                if reset:
                    setattr(t.metrics, attr, 0)
        return total

    def get_and_reset_num_retry_throw(self, task_id: int) -> int:
        with self._lock:
            return self._collect_metric(task_id, "num_times_retry_throw",
                                        True)

    def get_and_reset_num_split_retry_throw(self, task_id: int) -> int:
        with self._lock:
            return self._collect_metric(
                task_id, "num_times_split_retry_throw", True)

    def get_and_reset_block_time(self, task_id: int) -> int:
        with self._lock:
            return self._collect_metric(task_id, "time_blocked_nanos", True)

    def get_and_reset_compute_time_lost_to_retry(self, task_id: int) -> int:
        with self._lock:
            return self._collect_metric(task_id, "time_lost_nanos", True)

    def get_and_reset_gpu_max_memory_allocated(self, task_id: int) -> int:
        with self._lock:
            return self._collect_metric(task_id,
                                        "gpu_max_memory_allocated", True)

    def get_max_gpu_task_memory(self, task_id: int) -> int:
        with self._lock:
            return self._collect_metric(task_id, "gpu_memory_max_footprint",
                                        False)

    def remove_task_metrics(self, task_id: int):
        """Drop checkpointed metrics for a finished task (reference
        removeTaskMetrics / SparkResourceAdaptorJni.cpp:1057) — callers pull
        get_and_reset_* first, then release the bookkeeping."""
        with self._lock:
            self._checkpointed.pop(task_id, None)

    # ------------------------------------------------------ memory ledger

    def memory_ledger(self, timeline: int = 200) -> dict:
        """Flight-recorder export (reference: RmmSpark's thread-state
        dump): per-thread and per-task allocation totals and
        watermarks, plus the tail of the OOM-state transition log.
        Per-task rows fold live threads AND the checkpointed buckets
        of threads that already unwound, so a task's held bytes are
        visible even after its threads died."""
        with self._lock:
            threads: Dict[str, dict] = {}
            tasks: Dict[int, dict] = {}

            def task_row(task_id: int) -> dict:
                return tasks.setdefault(task_id, {
                    "active_bytes": 0, "watermark_bytes": 0,
                    "max_allocated_bytes": 0, "retry_oom": 0,
                    "split_retry_oom": 0, "blocked_ns": 0,
                    "lost_ns": 0, "threads": []})

            def fold(row: dict, m: TaskMetrics):
                row["active_bytes"] += int(m.gpu_memory_active_footprint)
                row["watermark_bytes"] = max(
                    row["watermark_bytes"],
                    int(m.gpu_memory_max_footprint))
                row["max_allocated_bytes"] = max(
                    row["max_allocated_bytes"],
                    int(m.gpu_max_memory_allocated))
                row["retry_oom"] += m.num_times_retry_throw
                row["split_retry_oom"] += m.num_times_split_retry_throw
                row["blocked_ns"] += m.time_blocked_nanos
                row["lost_ns"] += m.time_lost_nanos

            for t in self._threads.values():
                m = t.metrics
                threads[str(t.thread_id)] = {
                    "task": t.task_id,
                    "pool_tasks": sorted(t.pool_task_ids),
                    "state": t.state,
                    "shuffle": t.is_for_shuffle,
                    "active_bytes": int(m.gpu_memory_active_footprint),
                    "watermark_bytes": int(m.gpu_memory_max_footprint),
                    "max_allocated_bytes":
                        int(m.gpu_max_memory_allocated),
                    "allocs": t.alloc_count,
                    "frees": t.dealloc_count,
                    "retry_oom": m.num_times_retry_throw,
                    "split_retry_oom": m.num_times_split_retry_throw,
                    "blocked_ns": m.time_blocked_nanos,
                    "lost_ns": m.time_lost_nanos,
                }
                task_ids = ([t.task_id] if t.task_id is not None
                            else sorted(t.pool_task_ids))
                for task_id in task_ids:
                    row = task_row(task_id)
                    fold(row, m)
                    row["threads"].append(t.thread_id)
            for task_id, cp in self._checkpointed.items():
                fold(task_row(task_id), cp)
            limit = getattr(self.resource, "limit", None)
            return {
                "allocated_bytes": int(self.gpu_memory_allocated_bytes),
                "limit_bytes": int(limit) if limit is not None else None,
                "threads": threads,
                "tasks": {str(k): v for k, v in sorted(tasks.items())},
                "oom_state_timeline": (list(self._log_rows)[-timeline:]
                                       if timeline else []),
            }

    def thread_state_dump(self) -> List[dict]:
        """Flat per-thread state list (the RmmSpark state-dump shape
        the incident bundle's threads.json carries)."""
        with self._lock:
            return [{"thread": t.thread_id, "task": t.task_id,
                     "pool_tasks": sorted(t.pool_task_ids),
                     "state": t.state, "shuffle": t.is_for_shuffle,
                     "active_bytes":
                         int(t.metrics.gpu_memory_active_footprint)}
                    for t in self._threads.values()]

    # ----------------------------------------------------------- spilling

    def thread_waiting_on_pool(self, thread_id: Optional[int] = None):
        """Mark a thread as blocked waiting on a pool-thread result
        (reference waiting_on_pool_status_changed :1246).  Such a thread
        counts as BUFN-or-above for deadlock detection, so a producer/
        consumer stall can still be broken."""
        if thread_id is None:
            thread_id = threading.get_ident()
        with self._lock:
            t = self._threads.get(thread_id)
            if t is not None:
                t.pool_blocked = True
                self._check_and_update_for_bufn(None)

    def thread_done_waiting_on_pool(self, thread_id: Optional[int] = None):
        if thread_id is None:
            thread_id = threading.get_ident()
        with self._lock:
            t = self._threads.get(thread_id)
            if t is not None:
                t.pool_blocked = False

    def set_spill_hook(self, hook):
        """Install (or clear, with None) the spill store hook.  The
        hook must expose ``ensure_headroom(nbytes) -> freed_bytes``
        (synchronous, may call back into allocate/deallocate — so it
        is ALWAYS invoked outside the adaptor lock) and
        ``spillable_bytes() -> int`` (lock-cheap probe, safe under the
        adaptor lock)."""
        with self._lock:
            self._spill_hook = hook

    def _spill_for_headroom(self, num_bytes: int) -> int:
        """Run the spill hook for a failed allocation.  Called WITHOUT
        the adaptor lock: the store calls deallocate() per victim,
        which needs the lock to wake blocked threads.  The release
        side runs inside spill_range_start/done (the store brackets
        it), so the recursive-allocation path recognizes the work as
        spill-side and keeps task footprints honest."""
        hook = self._spill_hook
        if hook is None:
            return 0
        try:
            return int(hook.ensure_headroom(num_bytes))
        except Exception:
            # a broken spill hook must never turn an OOM into a crash;
            # the state machine's BUFN/split ladder still applies
            return 0

    def spill_range_start(self):
        with self._lock:
            t = self._threads.get(threading.get_ident())
            if t is not None:
                t.is_in_spilling = True

    def spill_range_done(self):
        with self._lock:
            t = self._threads.get(threading.get_ident())
            if t is not None:
                t.is_in_spilling = False

    # --------------------------------------------------- blocking machinery

    def _is_blocked(self, state: str) -> bool:
        return state in (THREAD_BLOCKED, THREAD_BUFN)

    def _throw_retry_oom(self, t: _ThreadState):
        t.metrics.num_times_retry_throw += 1
        _obs.record_oom_event("oom_retry", thread_id=t.thread_id,
                              task_id=t.task_id, is_cpu=t.is_cpu_alloc)
        self._check_before_oom(t)
        t.record_failed_retry_time()
        if t.is_cpu_alloc:
            raise exc.CpuRetryOOM()
        raise exc.GpuRetryOOM()

    def _throw_split_and_retry_oom(self, t: _ThreadState):
        t.metrics.num_times_split_retry_throw += 1
        _obs.record_oom_event("oom_split_retry", thread_id=t.thread_id,
                              task_id=t.task_id, is_cpu=t.is_cpu_alloc)
        self._check_before_oom(t)
        t.record_failed_retry_time()
        if t.is_cpu_alloc:
            raise exc.CpuSplitAndRetryOOM()
        raise exc.GpuSplitAndRetryOOM()

    def _check_before_oom(self, t: _ThreadState):
        if t.num_times_retried + 1 > RETRY_LIMIT:
            t.record_failed_retry_time()
            raise exc.GpuOOM("GPU OutOfMemory: retry limit exceeded")
        t.num_times_retried += 1

    def block_thread_until_ready(self, thread_id: Optional[int] = None):
        if thread_id is None:
            thread_id = threading.get_ident()
        with self._lock:
            self._block_thread_until_ready(thread_id)

    def _block_thread_until_ready(self, thread_id: int):
        done = False
        first_time = True
        while not done:
            t = self._threads.get(thread_id)
            if t is None:
                return
            state = t.state
            if state in (THREAD_BLOCKED, THREAD_BUFN):
                self._log_status("WAITING", thread_id, t.task_id, state)
                t.before_block()
                while True:
                    t.wake.wait()
                    t = self._threads.get(thread_id)
                    if t is None or not self._is_blocked(t.state):
                        break
                if t is not None:
                    t.after_block()
            elif state == THREAD_BUFN_THROW:
                self._transition(t, THREAD_BUFN_WAIT)
                t.record_failed_retry_time()
                self._throw_retry_oom(t)
            elif state == THREAD_BUFN_WAIT:
                self._transition(t, THREAD_BUFN)
                self._check_and_update_for_bufn(None)
                if self._is_blocked(t.state):
                    self._log_status("WAITING", thread_id, t.task_id,
                                     t.state)
                    t.before_block()
                    while True:
                        t.wake.wait()
                        t = self._threads.get(thread_id)
                        if t is None or not self._is_blocked(t.state):
                            break
                    if t is not None:
                        t.after_block()
            elif state == THREAD_SPLIT_THROW:
                self._transition(t, THREAD_RUNNING)
                t.record_failed_retry_time()
                self._throw_split_and_retry_oom(t)
            elif state == THREAD_REMOVE_THROW:
                self._log_transition(t, UNKNOWN)
                del self._threads[thread_id]
                if self.on_thread_removed is not None:
                    try:  # registry callback fires on BOTH removal
                        self.on_thread_removed(thread_id)  # paths
                    except Exception:
                        pass
                raise exc.ThreadRemovedException(
                    "thread removed while blocked")
            else:
                if not first_time:
                    self._log_status("DONE WAITING", thread_id, t.task_id,
                                     t.state)
                done = True
            first_time = False

    def _wake_up_threads_after_task_finishes(self):
        any_blocked = False
        for t in self._threads.values():
            if t.state == THREAD_BLOCKED:
                self._transition(t, THREAD_RUNNING)
                t.wake.notify_all()
                any_blocked = True
        if not any_blocked:
            for t in self._threads.values():
                if t.state in (THREAD_BUFN, THREAD_BUFN_THROW,
                               THREAD_BUFN_WAIT):
                    self._transition(t, THREAD_RUNNING)
                    t.wake.notify_all()

    def _wake_next_highest_priority_blocked(self, is_for_cpu: bool):
        best = None
        for t in self._threads.values():
            if t.state == THREAD_BLOCKED and t.is_cpu_alloc == is_for_cpu:
                if best is None or t.priority() > best.priority():
                    best = t
        if best is not None:
            self._transition(best, THREAD_RUNNING)
            best.wake.notify_all()

    # -------------------------------------------------- deadlock handling

    def _is_thread_bufn_or_above(self, t: _ThreadState) -> bool:
        if t.pool_blocked:
            return True
        if t.state == THREAD_BLOCKED:
            return False
        return t.state == THREAD_BUFN

    def _deadlock_sets(self):
        all_task_ids: Set[int] = set()
        blocked_task_ids: Set[int] = set()
        bufn_task_ids: Set[int] = set()
        pool_task_thread_count: Dict[int, int] = {}
        pool_bufn_task_thread_count: Dict[int, int] = {}
        for t in self._threads.values():
            if t.task_id is not None:
                all_task_ids.add(t.task_id)
                bufn_plus = self._is_thread_bufn_or_above(t)
                if bufn_plus:
                    bufn_task_ids.add(t.task_id)
                if bufn_plus or t.state == THREAD_BLOCKED:
                    blocked_task_ids.add(t.task_id)
        for t in self._threads.values():
            if t.task_id is None:
                for task_id in t.pool_task_ids:
                    pool_task_thread_count[task_id] = \
                        pool_task_thread_count.get(task_id, 0) + 1
                bufn_plus = self._is_thread_bufn_or_above(t)
                if bufn_plus:
                    for task_id in t.pool_task_ids:
                        pool_bufn_task_thread_count[task_id] = \
                            pool_bufn_task_thread_count.get(task_id, 0) + 1
                if not bufn_plus and t.state != THREAD_BLOCKED:
                    for task_id in t.pool_task_ids:
                        blocked_task_ids.discard(task_id)
        # blocked_task_ids is a subset of all_task_ids, so size equality
        # means every task is blocked (reference :1866)
        deadlocked = (len(all_task_ids) > 0
                      and len(blocked_task_ids) == len(all_task_ids))
        return (deadlocked, all_task_ids, bufn_task_ids,
                pool_task_thread_count, pool_bufn_task_thread_count)

    def check_and_break_deadlocks(self):
        """Watchdog entry (RmmSpark java watchdog -> :1119)."""
        with self._lock:
            self._check_and_update_for_bufn(None)

    def _check_and_update_for_bufn(self, java_blocked):
        (deadlocked, all_task_ids, bufn_task_ids, pool_task_thread_count,
         pool_bufn_task_thread_count) = self._deadlock_sets()
        if not deadlocked:
            return
        # pick lowest-priority BLOCKED thread to roll back
        to_bufn = None
        blocked_count = 0
        for t in self._threads.values():
            if t.state == THREAD_BLOCKED:
                blocked_count += 1
                if to_bufn is None or t.priority() < to_bufn.priority():
                    to_bufn = t
        if to_bufn is not None:
            spillable = 0
            if self._spill_hook is not None:
                try:
                    spillable = int(self._spill_hook.spillable_bytes())
                except Exception:
                    spillable = 0
            if blocked_count == 1 or spillable > 0:
                # last blocked thread: retry the alloc once before BUFN —
                # spillable data may have been freed already (:1962).
                # Same wake when the spill store still holds device
                # bytes: the woken thread's alloc-failure path runs
                # ensure_headroom synchronously (outside the lock)
                # BEFORE any BUFN/retry-split escalation, so registered
                # batches spill instead of the query rolling back.
                to_bufn.is_retry_alloc_before_bufn = True
                self._transition(to_bufn, THREAD_RUNNING)
            else:
                self._transition(to_bufn, THREAD_BUFN_THROW)
            to_bufn.wake.notify_all()
        # tasks whose pool threads are all BUFN count as BUFN tasks
        for task_id, bufn_count in pool_bufn_task_thread_count.items():
            total = pool_task_thread_count.get(task_id)
            if total is not None and total <= bufn_count:
                bufn_task_ids.add(task_id)
        if all_task_ids and len(bufn_task_ids) == len(all_task_ids):
            # all tasks BUFN: highest-priority BUFN thread splits its input
            to_split = None
            for t in self._threads.values():
                if t.state == THREAD_BUFN:
                    if to_split is None or t.priority() > to_split.priority():
                        to_split = t
            if to_split is not None:
                self._transition(to_split, THREAD_SPLIT_THROW)
                to_split.wake.notify_all()

    # ---------------------------------------------------------- alloc flow

    def check_injected_oom(self, thread_id: Optional[int] = None):
        """Consume pending forced-OOM / CudfException injections for a
        thread OUTSIDE the alloc path — the retry drivers
        (robustness/retry.py) poll this at every attempt start, so
        ``force_retry_oom``/``force_split_and_retry_oom`` fire even
        for compute-only sections that never allocate (reference
        RmmSpark.forceRetryOOM semantics).  Device-filtered
        injections are consumed first, then STRICTLY-CPU-filtered
        ones (a compute-only section has no alloc flavor of its own;
        at most ONE injection fires per call since consumption
        raises, and the CPU pass skips CPU_OR_GPU injections — the
        device pass already serviced them, including their
        skip_count).  No-op for unregistered threads."""
        if thread_id is None:
            thread_id = threading.get_ident()
        with self._lock:
            t = self._threads.get(thread_id)
            if t is None:
                return
            self._consume_injected_oom(t, thread_id, False)
            self._consume_injected_oom(t, thread_id, True,
                                       skip_unfiltered=True)

    def _pre_alloc_core(self, thread_id: int, is_for_cpu: bool,
                        blocking: bool) -> bool:
        t = self._threads.get(thread_id)
        if t is None:
            return False
        if t.state in (THREAD_ALLOC, THREAD_ALLOC_FREE):
            if is_for_cpu and blocking:
                raise ValueError(
                    f"thread {thread_id} is trying to do a blocking "
                    f"allocate while already in the state {t.state}")
            return True  # recursive allocation (spill path)
        self._consume_injected_oom(t, thread_id, is_for_cpu)
        if blocking:
            self._block_thread_until_ready(thread_id)
        t = self._threads.get(thread_id)
        if t is None:
            return False
        if t.state == THREAD_RUNNING:
            self._transition(t, THREAD_ALLOC)
            t.is_cpu_alloc = is_for_cpu
        else:
            raise ValueError(
                f"thread {thread_id} in unexpected state pre alloc "
                f"{t.state}")
        return False

    def _consume_injected_oom(self, t: _ThreadState, thread_id: int,
                              is_for_cpu: bool,
                              skip_unfiltered: bool = False):
        """The forced-injection consumption shared by the alloc
        bracket and the retry drivers' check hook (caller holds the
        lock).  Order matches the reference: retry OOM, then
        CudfException, then split-and-retry OOM.  ``skip_unfiltered``
        limits the pass to injections whose filter REQUIRES this
        flavor (check_injected_oom's second pass — a CPU_OR_GPU
        injection must not burn a second skip in one poll)."""
        if t.retry_oom.matches(is_for_cpu) and not (
                skip_unfiltered and t.retry_oom.filter == CPU_OR_GPU):
            if t.retry_oom.skip_count > 0:
                t.retry_oom.skip_count -= 1
            elif t.retry_oom.hit_count > 0:
                t.retry_oom.hit_count -= 1
                t.metrics.num_times_retry_throw += 1
                self._log_status(
                    "INJECTED_RETRY_OOM_" + ("CPU" if is_for_cpu else "GPU"),
                    thread_id, t.task_id, t.state)
                _obs.record_oom_event("oom_retry", thread_id=thread_id,
                                      task_id=t.task_id, is_cpu=is_for_cpu,
                                      injected=True)
                t.record_failed_retry_time()
                raise (exc.CpuRetryOOM("injected RetryOOM") if is_for_cpu
                       else exc.GpuRetryOOM("injected RetryOOM"))
        if t.cudf_exception_injected > 0 and not skip_unfiltered:
            t.cudf_exception_injected -= 1
            self._log_status("INJECTED_CUDF_EXCEPTION", thread_id,
                             t.task_id, t.state)
            t.record_failed_retry_time()
            raise exc.CudfException("injected CudfException")
        if t.split_and_retry_oom.matches(is_for_cpu) and not (
                skip_unfiltered
                and t.split_and_retry_oom.filter == CPU_OR_GPU):
            if t.split_and_retry_oom.skip_count > 0:
                t.split_and_retry_oom.skip_count -= 1
            elif t.split_and_retry_oom.hit_count > 0:
                t.split_and_retry_oom.hit_count -= 1
                t.metrics.num_times_split_retry_throw += 1
                self._log_status(
                    "INJECTED_SPLIT_AND_RETRY_OOM_"
                    + ("CPU" if is_for_cpu else "GPU"),
                    thread_id, t.task_id, t.state)
                _obs.record_oom_event("oom_split_retry",
                                      thread_id=thread_id,
                                      task_id=t.task_id, is_cpu=is_for_cpu,
                                      injected=True)
                t.record_failed_retry_time()
                raise (exc.CpuSplitAndRetryOOM("injected SplitAndRetryOOM")
                       if is_for_cpu
                       else exc.GpuSplitAndRetryOOM(
                           "injected SplitAndRetryOOM"))

    def _post_alloc_success_core(self, thread_id: int, is_for_cpu: bool,
                                 was_recursive: bool, num_bytes: int):
        t = self._threads.get(thread_id)
        if was_recursive or t is None:
            return
        t.is_retry_alloc_before_bufn = False
        if t.state in (THREAD_ALLOC, THREAD_ALLOC_FREE):
            if t.is_cpu_alloc != is_for_cpu:
                raise ValueError(
                    f"thread {thread_id} has a mismatch on CPU vs GPU post "
                    f"alloc {t.state}")
            self._transition(t, THREAD_RUNNING)
            t.is_cpu_alloc = False
            t.record_progress()
            if not is_for_cpu:
                t.alloc_count += 1
                if not t.is_in_spilling:
                    t.metrics.gpu_memory_active_footprint += num_bytes
                    t.metrics.gpu_memory_max_footprint = max(
                        t.metrics.gpu_memory_max_footprint,
                        t.metrics.gpu_memory_active_footprint)
                self.gpu_memory_allocated_bytes += num_bytes
                t.metrics.gpu_max_memory_allocated = max(
                    t.metrics.gpu_max_memory_allocated,
                    self.gpu_memory_allocated_bytes)
                _obs.record_device_memory(self.gpu_memory_allocated_bytes)
        self._wake_next_highest_priority_blocked(is_for_cpu)

    def _post_alloc_failed_core(self, thread_id: int, is_for_cpu: bool,
                                is_oom: bool, blocking: bool,
                                was_recursive: bool) -> bool:
        t = self._threads.get(thread_id)
        if was_recursive or t is None:
            self._check_and_update_for_bufn(None)
            return False
        if t.is_cpu_alloc != is_for_cpu:
            raise ValueError(
                f"thread {thread_id} has a mismatch on CPU vs GPU post "
                f"alloc {t.state}")
        if t.state == THREAD_ALLOC_FREE:
            self._transition(t, THREAD_RUNNING)
        elif t.state == THREAD_ALLOC:
            if is_oom and t.is_retry_alloc_before_bufn:
                t.is_retry_alloc_before_bufn = False
                self._transition(t, THREAD_BUFN_THROW)
                t.wake.notify_all()
            elif is_oom and blocking:
                self._transition(t, THREAD_BLOCKED)
            else:
                self._transition(t, THREAD_RUNNING)
        else:
            raise RuntimeError(
                f"Internal error: unexpected state after alloc failed "
                f"{thread_id} {t.state}")
        self._check_and_update_for_bufn(None)
        return True

    def _dealloc_core(self, is_for_cpu: bool, num_bytes: int):
        tid = threading.get_ident()
        t = self._threads.get(tid)
        if t is not None:
            self._log_status("DEALLOC", tid, t.task_id, t.state)
            if not is_for_cpu:
                t.dealloc_count += 1
                if not t.is_in_spilling:
                    t.metrics.gpu_memory_active_footprint -= num_bytes
                self.gpu_memory_allocated_bytes -= num_bytes
                _obs.record_device_memory(self.gpu_memory_allocated_bytes)
        for other in self._threads.values():
            if other.thread_id != tid and other.state == THREAD_ALLOC \
                    and other.is_cpu_alloc == is_for_cpu:
                self._transition(other, THREAD_ALLOC_FREE)
        self._wake_next_highest_priority_blocked(is_for_cpu)

    # -------------------------------------------------------- public alloc

    def allocate(self, num_bytes: int) -> int:
        """Device reservation with full retry semantics (reference
        allocate() :2115).  Returns num_bytes on success."""
        tid = threading.get_ident()
        while True:
            with self._lock:
                likely_spill = self._pre_alloc_core(tid, False, True)
            try:
                self.resource.allocate(num_bytes)
                with self._lock:
                    self._post_alloc_success_core(tid, False, likely_spill,
                                                  num_bytes)
                from spark_rapids_tpu_torch.utils.profiler import \
                    record_alloc
                record_alloc("alloc", num_bytes)
                return num_bytes
            except AllocationFailed:
                # synchronous spill BEFORE escalation: free registered
                # spillable batches and retry cleanly (no BLOCKED/BUFN
                # transition) while the store still has device bytes.
                # Runs outside the lock — the store deallocates per
                # victim, bracketed by spill_range_start/done.
                freed = self._spill_for_headroom(num_bytes)
                if freed > 0:
                    with self._lock:
                        t = self._threads.get(tid)
                        if t is not None:
                            t.is_retry_alloc_before_bufn = False
                        self._post_alloc_failed_core(
                            tid, False, True, False, likely_spill)
                    continue
                with self._lock:
                    retry = self._post_alloc_failed_core(
                        tid, False, True, True, likely_spill)
                if not retry:
                    raise exc.GpuOOM("GPU OutOfMemory")
            except (exc.RetryOOMBase, exc.SplitAndRetryOOMBase,
                    exc.CudfException):
                raise
            except Exception:
                with self._lock:
                    self._post_alloc_failed_core(tid, False, False, True,
                                                 likely_spill)
                raise

    def deallocate(self, num_bytes: int):
        self.resource.deallocate(num_bytes)
        with self._lock:
            self._dealloc_core(False, num_bytes)
        from spark_rapids_tpu_torch.utils.profiler import record_alloc
        record_alloc("free", num_bytes)

    # ------------------------------------------------------ cpu alloc hooks

    def cpu_prealloc(self, num_bytes: int, blocking: bool) -> bool:
        """Host-alloc bracket (RmmSpark.preCpuAlloc :790): returns
        was_recursive."""
        tid = threading.get_ident()
        with self._lock:
            return self._pre_alloc_core(tid, True, blocking)

    def post_cpu_alloc_success(self, num_bytes: int, blocking: bool,
                               was_recursive: bool):
        tid = threading.get_ident()
        with self._lock:
            self._post_alloc_success_core(tid, True, was_recursive,
                                          num_bytes)

    def post_cpu_alloc_failed(self, was_oom: bool, blocking: bool,
                              was_recursive: bool) -> bool:
        tid = threading.get_ident()
        with self._lock:
            return self._post_alloc_failed_core(tid, True, was_oom,
                                                blocking, was_recursive)

    def cpu_deallocate(self, num_bytes: int):
        with self._lock:
            self._dealloc_core(True, num_bytes)

    # ------------------------------------------------------------ shutdown

    def shutdown(self):
        with self._lock:
            for t in list(self._threads.values()):
                if t.state in (THREAD_BLOCKED, THREAD_BUFN):
                    self._transition(t, THREAD_REMOVE_THROW)
                    t.wake.notify_all()
            # registry teardown: still-registered (RUNNING) threads
            # must not outlive the adaptor in the ThreadStateRegistry
            # (removeThread parity holds across non-clean teardowns)
            if self.on_thread_removed is not None:
                for thread_id in list(self._threads):
                    try:
                        self.on_thread_removed(thread_id)
                    except Exception:
                        pass
            # detach the sink under the lock so woken threads can't race a
            # write against close(); close after releasing the lock
            log_file, self._log_file = self._log_file, None
        if log_file:
            log_file.close()
