"""OOM exception taxonomy (reference: 7 Java classes thrown from native via
class lookup, SparkResourceAdaptorJni.cpp:49-54).  The retry framework above
this library catches these by type."""


class RetryOOMBase(Exception):
    """A rollback-to-spillable-and-retry is requested."""


class SplitAndRetryOOMBase(Exception):
    """A split-input-and-retry is requested."""


class GpuRetryOOM(RetryOOMBase):
    def __init__(self, msg="GPU OutOfMemory"):
        super().__init__(msg)


class GpuSplitAndRetryOOM(SplitAndRetryOOMBase):
    def __init__(self, msg="GPU OutOfMemory"):
        super().__init__(msg)


class CpuRetryOOM(RetryOOMBase):
    def __init__(self, msg="CPU OutOfMemory"):
        super().__init__(msg)


class CpuSplitAndRetryOOM(SplitAndRetryOOMBase):
    def __init__(self, msg="CPU OutOfMemory"):
        super().__init__(msg)


class GpuOOM(Exception):
    """Unrecoverable device OOM (e.g. retry limit exceeded)."""


class OffHeapOOM(Exception):
    """Unrecoverable host (off-heap) OOM."""


class CudfException(Exception):
    """Generic engine exception (reference CudfException) — used by fault
    injection to simulate kernel errors."""


class ThreadRemovedException(RuntimeError):
    """Thread was unregistered while blocked (THREAD_REMOVE_THROW)."""
