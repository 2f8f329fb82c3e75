"""Runtime lock-order detector (the port of the JAX package's
`analysis/lockdep.py`; same classes, graph, evidence and env switch).

The repo holds ~40 locks across the server, scheduler, lifeguard,
metrics registry, jit cache, shim handle registry, and shuffle
transport — with an *implied* acquisition order that nothing enforced.
This module is the enforcement: an opt-in instrumented Lock/RLock
wrapper (the linux-kernel lockdep idea, scaled to this process) that

  * records the per-thread held-lock stack on every acquire,
  * folds each (held -> acquired) pair into a process-wide
    acquisition-order graph keyed by *lock class* (the name passed to
    :func:`make_lock` — every ``metrics.series`` lock is one class,
    exactly like kernel lockdep keys on the lock's init site),
  * reports cycles in that graph (ABBA deadlock *potential* — the
    deadlock does not have to fire to be caught) with the acquisition
    stacks of both directions as flight-recorder-style JSON evidence,
  * flags locks held across known blocking calls (socket sends,
    storage range reads — the :func:`note_blocking` sites), which are
    latency bombs even when they never deadlock.

Cost model: ``make_lock``/``make_rlock`` return a *plain*
``threading.Lock``/``RLock`` unless ``SPARK_RAPIDS_TPU_LOCKDEP=1`` is
set when the lock is created — the off path costs one env read at
lock creation and NOTHING per acquire.  ``note_blocking`` costs one
module-bool read when no instrumented lock exists.  Because the env
var is read at creation time, it must be set before the instrumented
modules import (the analysis smoke does exactly that).

Evidence: every detected cycle / held-across-blocking event bumps
``srt_lockdep_*`` and emits a ``lockdep`` journal event; a cycle also
freezes a ``lockdep_cycle`` incident bundle when the flight recorder
is armed.
The observability import is lazy and failure-isolated: lockdep is
adopted *by* the metrics registry, so it must never import it at
module scope.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

ENV = "SPARK_RAPIDS_TPU_LOCKDEP"

# flipped true when the first instrumented lock is created: the
# note_blocking fast path in un-instrumented processes is one read of
# this bool (never an env read)
_INSTALLED = False

_MAX_CYCLES = 64          # distinct cycle reports kept (dedup by path)
_MAX_BLOCKING = 256       # held-across-blocking events kept
_MAX_STACK = 12           # frames kept per evidence stack


def enabled() -> bool:
    """Dynamic env read — governs what make_lock returns *now*."""
    return os.environ.get(ENV, "") not in ("", "0")


class _Graph:
    """Acquisition-order graph over lock classes.  One per process;
    its own internal lock is a plain threading.Lock (never
    instrumented — lockdep must not watch itself)."""

    def __init__(self):
        self.lock = threading.Lock()
        # (held_class, acquired_class) -> evidence
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.cycles: List[dict] = []
        self._cycle_keys: set = set()
        self.blocking: List[dict] = []
        self.blocking_total = 0
        self.classes: Dict[str, int] = {}   # class -> instances created
        self.acquires = 0

    def reset(self):
        with self.lock:
            self.edges.clear()
            self.cycles.clear()
            self._cycle_keys.clear()
            self.blocking.clear()
            self.blocking_total = 0
            self.acquires = 0


_GRAPH = _Graph()

_TLS = threading.local()


def _held() -> list:
    """This thread's held-lock stack: list of [class, lock_id]."""
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _stack_tail() -> List[str]:
    return [ln.strip() for ln in
            traceback.format_stack(limit=_MAX_STACK + 2)[:-2]][-_MAX_STACK:]


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """Caller holds _GRAPH.lock.  DFS path src -> dst over edges."""
    seen = {src}
    path = [src]

    def walk(node: str) -> bool:
        for (a, b) in _GRAPH.edges:
            if a != node or b in seen:
                continue
            path.append(b)
            if b == dst:
                return True
            seen.add(b)
            if walk(b):
                return True
            path.pop()
        return False

    return path if walk(src) else None


def _emit(kind: str, detail: dict) -> None:
    """Evidence fan-out (counters + journal + incident bundle for
    cycles).  Lazy, failure-isolated: lockdep is adopted by the
    metrics registry itself, so this must survive any observability
    state including mid-import.  Per-thread re-entrancy guard: the
    fan-out acquires instrumented metric locks of its own, and an
    edge detected WHILE emitting must not recurse back in here."""
    if getattr(_TLS, "emitting", False):
        return
    _TLS.emitting = True
    try:
        from spark_rapids_tpu_torch import observability as _obs
        _obs.record_lockdep(kind, **detail)
    except Exception:
        pass
    finally:
        _TLS.emitting = False


def _note_attempt(cls: str, lock_id: int) -> None:
    """Record (held -> wanted) edges at acquisition ATTEMPT time —
    before the acquire can block.  An ABBA pair deadlocks on its
    second acquires; recording at attempt time reports the cycle even
    while both threads are still wedged (the kernel-lockdep
    discipline), instead of needing the deadlock to luckily miss."""
    held = _held()
    _GRAPH.acquires += 1        # racy but statistical — display only
    reentrant = any(i == lock_id for _c, i in held)
    if held and not reentrant:
        new_edges = []
        with _GRAPH.lock:
            for held_cls, held_id in held:
                if held_cls == cls and held_id == lock_id:
                    continue
                key = (held_cls, cls)
                ev = _GRAPH.edges.get(key)
                if ev is not None:
                    ev["count"] += 1
                    continue
                new_edges.append(key)
                _GRAPH.edges[key] = {
                    "count": 1,
                    "thread": threading.current_thread().name,
                    "stack": _stack_tail(),
                }
            cycles = []
            for (a, b) in new_edges:
                if a == b:
                    path = [a, b]      # same-class nesting across
                    #                    instances: ordered only by luck
                else:
                    back = _find_path(b, a)
                    if back is None:
                        continue
                    path = back + [b]
                ck = "->".join(path)
                if ck in _GRAPH._cycle_keys:
                    continue
                _GRAPH._cycle_keys.add(ck)
                cyc = {
                    "cycle": path,
                    "forward": {"edge": [a, b],
                                **_GRAPH.edges[(a, b)]},
                    "backward": [
                        {"edge": [x, y], **_GRAPH.edges[(x, y)]}
                        for x, y in zip(path, path[1:])
                        if (x, y) in _GRAPH.edges and (x, y) != (a, b)],
                }
                if len(_GRAPH.cycles) < _MAX_CYCLES:
                    _GRAPH.cycles.append(cyc)
                cycles.append(cyc)
        for cyc in cycles:
            _emit("cycle", {"cycle": cyc["cycle"],
                            "evidence": cyc})


def _note_released(cls: str, lock_id: int) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][1] == lock_id:
            del held[i]
            return
    # release of a lock this thread never recorded (a Condition
    # handing the lock between threads) — ignore rather than corrupt


class LockdepLock:
    """Instrumented ``threading.Lock`` drop-in; ``name`` is the lock
    class key in the acquisition-order graph."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._lock = self._make_inner()
        with _GRAPH.lock:
            _GRAPH.classes[name] = _GRAPH.classes.get(name, 0) + 1

    def _make_inner(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        _note_attempt(self.name, id(self))
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _held().append([self.name, id(self)])
        return ok

    def release(self):
        self._lock.release()
        _note_released(self.name, id(self))

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class LockdepRLock(LockdepLock):
    _reentrant = True

    def _make_inner(self):
        return threading.RLock()

    def locked(self):
        # RLock has no .locked() before 3.12; this probe reports
        # whether ANOTHER thread holds it (an owner's reentrant probe
        # succeeds, so self-held reads as unlocked — matches the
        # "would acquire block me" question callers actually ask)
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True


def make_lock(name: str) -> "threading.Lock | LockdepLock":
    """A lock participating in lockdep when ``SPARK_RAPIDS_TPU_LOCKDEP=1``
    is set at creation time; a plain ``threading.Lock`` otherwise
    (zero per-acquire cost on the off path)."""
    if not enabled():
        return threading.Lock()
    global _INSTALLED
    _INSTALLED = True
    return LockdepLock(name)


def make_rlock(name: str) -> "threading.RLock | LockdepRLock":
    if not enabled():
        return threading.RLock()
    global _INSTALLED
    _INSTALLED = True
    return LockdepRLock(name)


def note_blocking(op: str) -> None:
    """Mark a known blocking call site (socket send/recv, storage
    range read).  When the calling thread holds any instrumented lock,
    that's a lock held across I/O — recorded with the held stack and
    surfaced exactly like a cycle (minus the incident bundle: it is a
    latency bug, not a deadlock)."""
    if not _INSTALLED:
        return
    held = _held()
    if not held:
        return
    ev = {
        "op": op,
        "held": [c for c, _i in held],
        "thread": threading.current_thread().name,
        "stack": _stack_tail(),
    }
    with _GRAPH.lock:
        _GRAPH.blocking_total += 1
        if len(_GRAPH.blocking) < _MAX_BLOCKING:
            _GRAPH.blocking.append(ev)
    _emit("blocking", {"op": op, "held": ev["held"],
                       "evidence": ev})


def held_classes() -> List[str]:
    """Lock classes the calling thread currently holds (tests)."""
    return [c for c, _i in _held()]


def report() -> dict:
    """Flight-recorder-style JSON: the graph, every detected cycle
    with both directions' acquisition stacks, and the
    held-across-blocking events."""
    with _GRAPH.lock:
        return {
            "enabled": enabled(),
            "installed": _INSTALLED,
            "classes": dict(sorted(_GRAPH.classes.items())),
            "acquires": _GRAPH.acquires,
            "edges": [
                {"from": a, "to": b, "count": ev["count"]}
                for (a, b), ev in sorted(_GRAPH.edges.items())],
            "cycles": [dict(c) for c in _GRAPH.cycles],
            "blocking": [dict(b) for b in _GRAPH.blocking],
            "blocking_total": _GRAPH.blocking_total,
        }


def reset() -> None:
    """Drop the graph and all evidence (tests / smoke phases).  Lock
    classes and the installed flag survive — existing instrumented
    locks keep reporting into the fresh graph."""
    _GRAPH.reset()
