"""ctypes binding for the native C++ SparkResourceAdaptor
(native/spark_resource_adaptor.cpp), the same public surface as the
Python SparkResourceAdaptor, so the RmmSpark scenarios run against both.
Host only: the state machine counts bytes; it allocates nothing.  The
library is built at first use into build/native/ (utils/native.py)."""

from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import List, Optional

from spark_rapids_tpu_torch.memory import exceptions as exc
from spark_rapids_tpu_torch.memory.spark_resource_adaptor import (
    CPU, CPU_OR_GPU, GPU, THREAD_ALLOC, THREAD_ALLOC_FREE, THREAD_BLOCKED,
    THREAD_BUFN, THREAD_BUFN_THROW, THREAD_BUFN_WAIT, THREAD_REMOVE_THROW,
    THREAD_RUNNING, THREAD_SPLIT_THROW, UNKNOWN)
from spark_rapids_tpu_torch.utils import native as _native

_STATE_NAMES = {
    -1: UNKNOWN, 0: THREAD_RUNNING, 1: THREAD_ALLOC, 2: THREAD_ALLOC_FREE,
    3: THREAD_BLOCKED, 4: THREAD_BUFN_THROW, 5: THREAD_BUFN_WAIT,
    6: THREAD_BUFN, 7: THREAD_SPLIT_THROW, 8: THREAD_REMOVE_THROW,
}
_FILTERS = {CPU_OR_GPU: 0, CPU: 1, GPU: 2}

_SIGNATURES = [
    ("sra_create", ctypes.c_long, [ctypes.c_long]),
    ("sra_destroy", None, [ctypes.c_long]),
    ("sra_start_dedicated_task_thread", ctypes.c_int,
     [ctypes.c_long] * 3),
    ("sra_pool_thread_working_on_tasks", ctypes.c_int,
     [ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
      ctypes.c_long]),
    ("sra_remove_thread_association", ctypes.c_int, [ctypes.c_long] * 3),
    ("sra_task_done", ctypes.c_int, [ctypes.c_long] * 2),
    ("sra_alloc", ctypes.c_int, [ctypes.c_long] * 3),
    ("sra_dealloc", ctypes.c_int, [ctypes.c_long] * 3),
    ("sra_cpu_prealloc", ctypes.c_int,
     [ctypes.c_long, ctypes.c_long, ctypes.c_int]),
    ("sra_post_cpu_alloc_success", ctypes.c_int,
     [ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int]),
    ("sra_post_cpu_alloc_failed", ctypes.c_int,
     [ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int,
      ctypes.c_int]),
    ("sra_cpu_dealloc", ctypes.c_int, [ctypes.c_long] * 3),
    ("sra_block_thread_until_ready", ctypes.c_int, [ctypes.c_long] * 2),
    ("sra_force_retry_oom", ctypes.c_int,
     [ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int,
      ctypes.c_long]),
    ("sra_force_split_and_retry_oom", ctypes.c_int,
     [ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int,
      ctypes.c_long]),
    ("sra_force_cudf_exception", ctypes.c_int, [ctypes.c_long] * 3),
    ("sra_get_state", ctypes.c_int, [ctypes.c_long] * 2),
    ("sra_used", ctypes.c_long, [ctypes.c_long]),
    ("sra_gpu_allocated", ctypes.c_long, [ctypes.c_long]),
    ("sra_thread_waiting_on_pool", ctypes.c_int,
     [ctypes.c_long, ctypes.c_long, ctypes.c_int]),
    ("sra_check_and_break_deadlocks", ctypes.c_int, [ctypes.c_long]),
    ("sra_get_and_reset_metric", ctypes.c_long,
     [ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int]),
    ("sra_remove_task_metrics", None, [ctypes.c_long] * 2),
    ("sra_log_count", ctypes.c_long, [ctypes.c_long]),
    ("sra_log_line", ctypes.c_long,
     [ctypes.c_long, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]),
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _native.disabled():
        return None
    with _lock:
        if _tried:
            return _lib
    # build and bind outside the lock (utils/native.py)
    lib: Optional[ctypes.CDLL] = None
    try:
        lib = ctypes.CDLL(str(_native.build_library(
            "sra_native", "spark_resource_adaptor.cpp",
            flags=("-pthread",))))
        for name, res, args in _SIGNATURES:
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
    except (OSError, subprocess.SubprocessError):
        lib = None
    with _lock:
        if not _tried:
            _lib, _tried = lib, True
        return _lib


def available() -> bool:
    return _load() is not None


def _raise_for(status: int, ctx: str = ""):
    if status == 0:
        return
    if status == -1:
        raise exc.GpuRetryOOM()
    if status == -2:
        raise exc.GpuSplitAndRetryOOM()
    if status == -3:
        raise exc.CudfException("injected CudfException")
    if status == -4:
        raise exc.GpuOOM("GPU OutOfMemory")
    if status == -5:
        raise exc.ThreadRemovedException("thread removed while blocked")
    if status == -7:
        raise exc.CpuRetryOOM()   # injected OR real CPU backpressure
    if status == -8:
        raise exc.CpuSplitAndRetryOOM()
    if status == -6:
        # same exception type as the Python adaptor's invalid-state path
        raise RuntimeError(f"Internal error: invalid adaptor state {ctx}")
    raise ValueError(f"native adaptor error {status} {ctx}")


class _ResourceView:
    def __init__(self, adaptor: "NativeSparkResourceAdaptor"):
        self._a = adaptor

    @property
    def used(self) -> int:
        return self._a._lib.sra_used(self._a._h)


class NativeSparkResourceAdaptor:
    """Drop-in for SparkResourceAdaptor backed by the C++ library."""

    def __init__(self, limit_bytes: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native adaptor library unavailable")
        self._lib = lib
        self._h = lib.sra_create(limit_bytes)
        self.resource = _ResourceView(self)

    # lifecycle -----------------------------------------------------

    def shutdown(self):
        if self._h:
            self._lib.sra_destroy(self._h)
            self._h = 0

    # registration --------------------------------------------------

    def start_dedicated_task_thread(self, thread_id: int, task_id: int):
        _raise_for(self._lib.sra_start_dedicated_task_thread(
            self._h, thread_id, task_id))

    def pool_thread_working_on_tasks(self, is_for_shuffle: bool,
                                     thread_id: int, task_ids):
        ids = list(task_ids)
        arr = (ctypes.c_long * len(ids))(*ids)
        _raise_for(self._lib.sra_pool_thread_working_on_tasks(
            self._h, thread_id, 1 if is_for_shuffle else 0,
            ctypes.cast(arr, ctypes.c_void_p), len(ids)))

    def remove_thread_association(self, thread_id: int, task_id: int = -1):
        _raise_for(self._lib.sra_remove_thread_association(
            self._h, thread_id, task_id))

    def task_done(self, task_id: int):
        _raise_for(self._lib.sra_task_done(self._h, task_id))

    # injection -----------------------------------------------------

    def force_retry_oom(self, thread_id: int, num_ooms: int,
                        oom_filter: str = GPU, skip_count: int = 0):
        _raise_for(self._lib.sra_force_retry_oom(
            self._h, thread_id, num_ooms, _FILTERS[oom_filter],
            skip_count), "force_retry_oom")

    def force_split_and_retry_oom(self, thread_id: int, num_ooms: int,
                                  oom_filter: str = GPU,
                                  skip_count: int = 0):
        _raise_for(self._lib.sra_force_split_and_retry_oom(
            self._h, thread_id, num_ooms, _FILTERS[oom_filter],
            skip_count), "force_split_and_retry_oom")

    def force_cudf_exception(self, thread_id: int, num_times: int):
        _raise_for(self._lib.sra_force_cudf_exception(
            self._h, thread_id, num_times), "force_cudf_exception")

    # queries -------------------------------------------------------

    def get_state_of(self, thread_id: int) -> str:
        return _STATE_NAMES.get(
            self._lib.sra_get_state(self._h, thread_id), UNKNOWN)

    @property
    def gpu_memory_allocated_bytes(self) -> int:
        return self._lib.sra_gpu_allocated(self._h)

    # alloc ---------------------------------------------------------

    def allocate(self, num_bytes: int) -> int:
        tid = threading.get_ident()
        _raise_for(self._lib.sra_alloc(self._h, tid, num_bytes))
        return num_bytes

    def deallocate(self, num_bytes: int):
        tid = threading.get_ident()
        _raise_for(self._lib.sra_dealloc(self._h, tid, num_bytes))

    def cpu_prealloc(self, num_bytes: int, blocking: bool) -> bool:
        """Host-alloc bracket (RmmSpark.preCpuAlloc :790): returns
        was_recursive."""
        tid = threading.get_ident()
        rc = self._lib.sra_cpu_prealloc(self._h, tid, int(blocking))
        _raise_for(rc if rc < 0 else 0)
        return rc == 1

    def post_cpu_alloc_success(self, num_bytes: int, blocking: bool,
                               was_recursive: bool):
        tid = threading.get_ident()
        _raise_for(self._lib.sra_post_cpu_alloc_success(
            self._h, tid, num_bytes, int(was_recursive)))

    def post_cpu_alloc_failed(self, was_oom: bool, blocking: bool,
                              was_recursive: bool) -> bool:
        tid = threading.get_ident()
        rc = self._lib.sra_post_cpu_alloc_failed(
            self._h, tid, int(was_oom), int(blocking),
            int(was_recursive))
        _raise_for(rc if rc < 0 else 0)
        return rc == 1

    def cpu_deallocate(self, num_bytes: int):
        tid = threading.get_ident()
        _raise_for(self._lib.sra_cpu_dealloc(self._h, tid, num_bytes))

    def block_thread_until_ready(self, thread_id: Optional[int] = None):
        if thread_id is None:
            thread_id = threading.get_ident()
        _raise_for(self._lib.sra_block_thread_until_ready(
            self._h, thread_id))

    def thread_waiting_on_pool(self, thread_id: Optional[int] = None):
        if thread_id is None:
            thread_id = threading.get_ident()
        _raise_for(self._lib.sra_thread_waiting_on_pool(
            self._h, thread_id, 1))

    def thread_done_waiting_on_pool(self,
                                    thread_id: Optional[int] = None):
        if thread_id is None:
            thread_id = threading.get_ident()
        _raise_for(self._lib.sra_thread_waiting_on_pool(
            self._h, thread_id, 0))

    def check_and_break_deadlocks(self):
        _raise_for(self._lib.sra_check_and_break_deadlocks(self._h))

    # metrics -------------------------------------------------------

    def _metric(self, task_id: int, kind: int, reset: bool = True) -> int:
        return self._lib.sra_get_and_reset_metric(
            self._h, task_id, kind, 1 if reset else 0)

    def get_and_reset_num_retry_throw(self, task_id: int) -> int:
        return self._metric(task_id, 0)

    def get_and_reset_num_split_retry_throw(self, task_id: int) -> int:
        return self._metric(task_id, 1)

    def get_and_reset_block_time(self, task_id: int) -> int:
        return self._metric(task_id, 2)

    def get_and_reset_compute_time_lost_to_retry(self,
                                                 task_id: int) -> int:
        return self._metric(task_id, 3)

    def get_and_reset_gpu_max_memory_allocated(self, task_id: int) -> int:
        return self._metric(task_id, 4)

    def get_max_gpu_task_memory(self, task_id: int) -> int:
        return self._metric(task_id, 5, reset=False)

    def remove_task_metrics(self, task_id: int):
        self._lib.sra_remove_task_metrics(self._h, task_id)

    # log -----------------------------------------------------------

    def get_log(self) -> List[str]:
        n = self._lib.sra_log_count(self._h)
        buf = ctypes.create_string_buffer(256)
        out = ["time,op,current thread,op thread,op task,from state,"
               "to state,notes"]
        for i in range(n):
            self._lib.sra_log_line(self._h, i, buf, 256)
            parts = buf.value.decode().split(",")
            if parts and parts[0] == "TRANSITION" and len(parts) >= 5:
                frm = _STATE_NAMES.get(int(parts[3]), UNKNOWN)
                to = _STATE_NAMES.get(int(parts[4]), UNKNOWN)
                rest = parts[5] if len(parts) > 5 else ""
                out.append(f"0,TRANSITION,{parts[1]},{parts[1]},"
                           f"{parts[2]},{frm},{to},{rest}")
            else:
                out.append(buf.value.decode())
        return out
