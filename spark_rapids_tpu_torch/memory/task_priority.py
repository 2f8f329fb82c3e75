"""Global task-attempt priority registry (reference TaskPriority.java:33
and TaskPriorityJni.cpp:25-60): earlier-registered attempts get higher
priority, the special attempt id -1 always gets the maximum, and
`task_done` releases an attempt's entry.  Used by the shuffle path to
order task work; the OOM deadlock breaker derives its own priority from
(task, thread) ids independently (spark_resource_adaptor.py).

Re-registration semantics (load-bearing for the query server's
load-shedding path, server/server.py): priorities are handed out from
a strictly DECREASING counter and an attempt's value is forgotten at
``task_done`` — so an attempt id that is re-registered after its
``task_done`` receives a *newer, strictly lower* priority than it held
before, and lower than every attempt that registered in between.  That
is intentional: "done then back again" means the attempt lost its
place in line (the server demotes an OOM-shed query exactly this way).
Callers that need a stable priority across retries must simply NOT
call ``task_done`` between attempts — the first ``get_task_priority``
pins the value until release.

``stats()`` exposes the registry's live view (entry count, next value
to be issued, cumulative register/release counts) — the query server's
``stats`` endpoint carries it as fair-share evidence.
"""

from __future__ import annotations

import threading

_MAX_LONG = (1 << 63) - 1


class TaskPriorityRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = _MAX_LONG - 1
        self._priorities: dict = {}
        self._registered_total = 0
        self._released_total = 0

    def get_task_priority(self, attempt_id: int) -> int:
        if attempt_id == -1:
            return _MAX_LONG  # special case: always highest
        with self._lock:
            if attempt_id in self._priorities:
                return self._priorities[attempt_id]
            priority = self._next
            self._next -= 1
            self._registered_total += 1
            self._priorities[attempt_id] = priority
            return priority

    def task_done(self, attempt_id: int) -> None:
        if attempt_id == -1:
            return
        with self._lock:
            if self._priorities.pop(attempt_id, None) is not None:
                self._released_total += 1

    def stats(self) -> dict:
        """Snapshot for the server ``stats`` endpoint: live entries
        (with their priorities, lowest first = most recently
        registered first), the next value to be issued, and the
        cumulative churn counters."""
        with self._lock:
            live = dict(self._priorities)
            return {
                "live_entries": len(live),
                "next_value": self._next,
                "registered_total": self._registered_total,
                "released_total": self._released_total,
                # bounded: the newest 64 attempts (lowest priorities)
                # — enough for fair-share evidence without letting a
                # leaky caller bloat every stats pull
                "live": {str(a): p for a, p in
                         sorted(live.items(),
                                key=lambda kv: kv[1])[:64]},
            }


_global = TaskPriorityRegistry()


def get_task_priority(attempt_id: int) -> int:
    return _global.get_task_priority(attempt_id)


def task_done(attempt_id: int) -> None:
    _global.task_done(attempt_id)


def stats() -> dict:
    return _global.stats()
