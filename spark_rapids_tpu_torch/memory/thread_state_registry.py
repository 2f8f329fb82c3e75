"""ThreadStateRegistry: the JVM-side thread map the native OOM machine
calls back into (reference ThreadStateRegistry.java:44-53 +
SparkResourceAdaptorJni.cpp:55-80 — native looks up/removes JVM threads
by native id when associations end).

Here the adaptor (memory/spark_resource_adaptor.py) plays "native" and
this registry plays the JVM side: RmmSpark registration adds threads,
and the adaptor's remove-association path invokes the registered
callback so the registry drops its entry — the same
native-calls-back-into-managed shape, exercised end-to-end through the
JNI binding's RmmSpark surface."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class ThreadStateRegistry:
    def __init__(self):
        self._threads: Dict[int, Optional[object]] = {}
        self._lock = threading.Lock()

    def add_thread(self, native_id: int,
                   thread: Optional[object] = None) -> None:
        """ThreadStateRegistry.addThread:44."""
        with self._lock:
            self._threads[native_id] = thread

    def remove_thread(self, native_id: int) -> None:
        """Called by the adaptor when a thread's task association ends
        (SparkResourceAdaptorJni.cpp:66-80 removeThread callback)."""
        with self._lock:
            self._threads.pop(native_id, None)

    def known_threads(self) -> List[int]:
        with self._lock:
            return sorted(self._threads)

    def blocked_thread_ids(self, adaptor) -> List[int]:
        """ThreadStateRegistry.blockedThreadIds:53 — registered threads
        currently blocked in the state machine."""
        out = []
        with self._lock:
            ids = list(self._threads)
        for tid in ids:
            try:
                state = adaptor.get_state_of(tid)
            except Exception:
                continue
            if "BLOCKED" in state or "BUFN" in state:
                out.append(tid)
        return sorted(out)


REGISTRY = ThreadStateRegistry()
