"""RmmSpark facade — process-global installation of the SparkResourceAdaptor
(reference RmmSpark.java:85-111 setEventHandler / setCurrentThreadAsTask
surface, adapted to Python naming).  All module functions operate on the
installed adaptor; `current_thread_id()` mirrors RmmSpark.getCurrentThreadId.

ROADMAP A14: the JAX package also binds and unbinds threads in its
observability task table here, and folds each finished task's retry,
block and memory counters into it; those calls are marked below.
"""

from __future__ import annotations

import threading
from typing import Optional

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
        # ROADMAP A14: the observability task table unbinds here too
        _adaptor.on_thread_removed = REGISTRY.remove_thread
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


# thin delegating wrappers (RmmSpark.java public surface); ROADMAP A14:
# the JAX package binds/unbinds each thread in its observability task
# table beside each of these calls


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


def current_thread_is_dedicated_to_task(task_id: int):
    # same validate-then-register contract as start_dedicated_task_thread
    start_dedicated_task_thread(current_thread_id(), task_id)


def shuffle_thread_working_on_tasks(task_ids):
    pool_thread_working_on_tasks(True, current_thread_id(), task_ids)


def pool_thread_working_on_tasks(is_for_shuffle: bool, thread_id: int,
                                 task_ids):
    get_adaptor().pool_thread_working_on_tasks(is_for_shuffle, thread_id,
                                               task_ids)


def pool_thread_finished_for_tasks(thread_id: int, task_ids):
    get_adaptor().pool_thread_finished_for_tasks(thread_id, task_ids)


def remove_current_thread_association():
    get_adaptor().remove_thread_association(current_thread_id(), -1)


def task_done(task_id: int):
    # ROADMAP A14: with observability on, the JAX package folds the
    # task's get_and_reset_* counters into its task rollup here and then
    # drops them (remove_task_metrics); here they stay for the caller
    return get_adaptor().task_done(task_id)


def force_release_task(task_id: int) -> dict:
    """Lifeguard entry: forcibly unwind a hung task's associations
    (``SparkResourceAdaptor.force_release_task``)."""
    return get_adaptor().force_release_task(task_id)


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
