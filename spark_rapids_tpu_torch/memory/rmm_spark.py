"""RmmSpark facade — process-global installation of the SparkResourceAdaptor
(reference RmmSpark.java:85-111 setEventHandler / setCurrentThreadAsTask
surface, adapted to Python naming).  All module functions operate on the
installed adaptor; `current_thread_id()` mirrors RmmSpark.getCurrentThreadId.
Each registration also binds (or unbinds) the thread in the
observability task table, and with observability on a finished task's
retry, block and memory counters are folded into its rollup.
"""

from __future__ import annotations

import threading
from typing import Optional

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.memory.resource import LimitingMemoryResource
from spark_rapids_tpu_torch.memory.spark_resource_adaptor import (
    GPU, CPU, CPU_OR_GPU, SparkResourceAdaptor)  # noqa: F401
from spark_rapids_tpu_torch.memory.thread_state_registry import REGISTRY

_adaptor: Optional[SparkResourceAdaptor] = None
_install_lock = threading.Lock()


def set_event_handler(limit_bytes: int,
                      log_path: Optional[str] = None) -> SparkResourceAdaptor:
    """Install the adaptor over a fresh limiting resource (RmmSpark
    setEventHandler equivalent)."""
    global _adaptor
    with _install_lock:
        if _adaptor is not None:
            raise RuntimeError("event handler already installed")
        _adaptor = SparkResourceAdaptor(LimitingMemoryResource(limit_bytes),
                                        log_path=log_path)
        # native-side adaptor -> managed-side thread registry callback
        # (reference SparkResourceAdaptorJni.cpp:66-80 removeThread);
        # the observability task table unbinds on the same signal so the
        # two thread->task maps cannot drift

        def _on_removed(thread_id: int):
            REGISTRY.remove_thread(thread_id)
            _obs.TASKS.unbind_thread(thread_id)

        _adaptor.on_thread_removed = _on_removed
        return _adaptor


def clear_event_handler():
    global _adaptor
    with _install_lock:
        if _adaptor is not None:
            _adaptor.shutdown()
        _adaptor = None


def get_adaptor() -> SparkResourceAdaptor:
    if _adaptor is None:
        raise RuntimeError("RmmSpark event handler is not installed")
    return _adaptor


def installed_adaptor() -> Optional[SparkResourceAdaptor]:
    """The installed adaptor or None — the retry drivers
    (robustness/retry.py) poll this on every attempt and must stay
    cheap and exception-free when no memory runtime exists."""
    return _adaptor


def current_thread_id() -> int:
    return threading.get_ident()


# thin delegating wrappers (RmmSpark.java public surface)

def start_dedicated_task_thread(thread_id: int, task_id: int):
    # register BEFORE the adaptor start so a concurrent task_done's
    # remove_thread callback can never race a not-yet-added id into a
    # permanently stale entry; roll back on a failed start so it does
    # not leave one either
    adaptor = get_adaptor()
    REGISTRY.add_thread(thread_id)
    try:
        adaptor.start_dedicated_task_thread(thread_id, task_id)
    except BaseException:
        REGISTRY.remove_thread(thread_id)
        raise
    _obs.TASKS.bind_thread(thread_id, (task_id,))


def current_thread_is_dedicated_to_task(task_id: int):
    # same validate-then-register contract as start_dedicated_task_thread
    start_dedicated_task_thread(current_thread_id(), task_id)


def shuffle_thread_working_on_tasks(task_ids):
    pool_thread_working_on_tasks(True, current_thread_id(), task_ids)


def pool_thread_working_on_tasks(is_for_shuffle: bool, thread_id: int,
                                 task_ids):
    get_adaptor().pool_thread_working_on_tasks(is_for_shuffle, thread_id,
                                               task_ids)
    _obs.TASKS.bind_thread(thread_id, task_ids)


def pool_thread_finished_for_tasks(thread_id: int, task_ids):
    get_adaptor().pool_thread_finished_for_tasks(thread_id, task_ids)
    _obs.TASKS.unbind_thread(thread_id, task_ids)


def remove_current_thread_association():
    get_adaptor().remove_thread_association(current_thread_id(), -1)
    _obs.TASKS.unbind_thread(current_thread_id())


def _fold_task(adaptor: SparkResourceAdaptor, task_id: int) -> None:
    """Pull the state machine's per-task counters (the
    getAndResetNumRetryThrow / getTotalBlockedOrLostTime analogs) into
    the observability rollup, then release the bookkeeping."""
    _obs.TASKS.fold_rmm_task(
        task_id,
        retry_oom=adaptor.get_and_reset_num_retry_throw(task_id),
        split_retry_oom=adaptor.get_and_reset_num_split_retry_throw(
            task_id),
        blocked_time_ns=adaptor.get_and_reset_block_time(task_id),
        lost_time_ns=adaptor.get_and_reset_compute_time_lost_to_retry(
            task_id),
        max_device_memory=adaptor.get_and_reset_gpu_max_memory_allocated(
            task_id))
    adaptor.remove_task_metrics(task_id)


def task_done(task_id: int):
    adaptor = get_adaptor()
    ret = adaptor.task_done(task_id)
    if _obs.is_enabled():
        _fold_task(adaptor, task_id)
        _obs.JOURNAL.emit("task_done", task=task_id)
    return ret


def force_release_task(task_id: int) -> dict:
    """Lifeguard entry: forcibly unwind a hung task's associations
    (``SparkResourceAdaptor.force_release_task``) and fold its
    counters into the observability rollup like a normal
    ``task_done`` would."""
    adaptor = get_adaptor()
    info = adaptor.force_release_task(task_id)
    if _obs.is_enabled():
        _fold_task(adaptor, task_id)
        _obs.JOURNAL.emit("task_force_released", task=task_id,
                          threads=info.get("threads", []),
                          held_bytes=info.get("held_bytes", 0))
    return info


def force_retry_oom(thread_id: int, num_ooms: int = 1,
                    oom_filter: str = GPU, skip_count: int = 0):
    get_adaptor().force_retry_oom(thread_id, num_ooms, oom_filter,
                                  skip_count)


def force_split_and_retry_oom(thread_id: int, num_ooms: int = 1,
                              oom_filter: str = GPU, skip_count: int = 0):
    get_adaptor().force_split_and_retry_oom(thread_id, num_ooms, oom_filter,
                                            skip_count)


def force_cudf_exception(thread_id: int, num_times: int = 1):
    get_adaptor().force_cudf_exception(thread_id, num_times)


def block_thread_until_ready():
    get_adaptor().block_thread_until_ready(current_thread_id())


def get_state_of(thread_id: int) -> str:
    return get_adaptor().get_state_of(thread_id)
