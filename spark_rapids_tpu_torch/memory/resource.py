"""Memory resources: reservation-tracking allocators for HBM budget control.

PyTorch's CUDA caching allocator owns physical device memory; what the
Spark runtime needs from "RMM" here is *reservation accounting* — a strict
budget that allocations check against so the OOM state machine can
block/retry/split tasks before the allocator ever hits a real OOM
(SURVEY.md §7.2: explicit reservation at the shim boundary).  It is not a
hook into torch's allocator: callers reserve what they are about to
allocate.  The resource stack mirrors RMM's composable adaptors: a base
resource with a byte limit, wrapped by the SparkResourceAdaptor state
machine.
"""

from __future__ import annotations

import threading


class AllocationFailed(MemoryError):
    """Internal signal that a reservation does not fit (rmm::out_of_memory
    equivalent) — callers above the adaptor never see this."""

    def __init__(self, nbytes: int):
        super().__init__(f"allocation of {nbytes} bytes failed")
        self.nbytes = nbytes


class MemoryResource:
    """Abstract reservation resource."""

    def allocate(self, nbytes: int) -> int:
        raise NotImplementedError

    def deallocate(self, nbytes: int) -> None:
        raise NotImplementedError


class LimitingMemoryResource(MemoryResource):
    """Strict byte-budget resource (rmm limiting_resource_adaptor analog)."""

    def __init__(self, limit_bytes: int):
        self.limit = int(limit_bytes)
        self._used = 0
        self._lock = threading.Lock()

    @property
    def used(self) -> int:
        return self._used

    def allocate(self, nbytes: int) -> int:
        if nbytes < 0:
            raise ValueError("negative allocation")
        with self._lock:
            if self._used + nbytes > self.limit:
                raise AllocationFailed(nbytes)
            self._used += nbytes
        return nbytes

    def deallocate(self, nbytes: int) -> None:
        with self._lock:
            self._used -= nbytes
