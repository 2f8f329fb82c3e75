"""Java handle model: the cudf-java surface works on `long` native
pointers; here a process-global registry maps opaque int64 handles to
device Column/Table objects so the JNI layer (or any FFI) can round-trip
them without marshalling data.

Mirrors the reference ownership rules: every handle returned to the
caller must be released exactly once (ColumnVector.close); leaks are
observable via live_count for tests and sanitizers.

Concurrency contract: every operation holds the registry lock, ids are
issued by a monotonically increasing counter and never reused, and
releasing a handle twice (or releasing a handle that never existed)
raises ``ValueError`` cleanly without touching any other entry, so
concurrent callers can race register/get/release freely and the worst
outcome is that error on the loser."""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict

_MISSING = object()   # registered objects may legitimately be falsy


class HandleRegistry:
    def __init__(self):
        self._objects: Dict[int, Any] = {}
        self._next = itertools.count(1)
        self._lock = threading.Lock()

    def register(self, obj: Any) -> int:
        with self._lock:
            h = next(self._next)
            self._objects[h] = obj
            return h

    def get(self, handle: int) -> Any:
        with self._lock:
            try:
                return self._objects[handle]
            except KeyError:
                raise ValueError(f"invalid or released handle {handle}")

    def release(self, handle: int) -> Any:
        """Release exactly once; returns the released object so callers
        can run post-release cleanup on it.  A second release of the same
        handle raises; it never corrupts the table."""
        with self._lock:
            obj = self._objects.pop(handle, _MISSING)
            if obj is _MISSING:
                raise ValueError(
                    f"double release or invalid handle {handle}")
            return obj

    def is_live(self, handle: int) -> bool:
        with self._lock:
            return handle in self._objects

    def live_count(self) -> int:
        with self._lock:
            return len(self._objects)

    def clear(self) -> None:
        with self._lock:
            self._objects.clear()


REGISTRY = HandleRegistry()
