"""PyTorch port: the task-level retry drivers (robustness/retry.py) held
against the JAX package's.  Each scenario runs the same steps through
both packages' ``with_retry``, ``with_retry_no_split`` and
``split_and_retry`` (with the forced-OOM hooks of each package's own
RmmSpark facade where it needs them) and compares what they return:
the results, the parts processed and their order, the attempt history
(index, kind, error, message, split depth, batch size),
``RetryExhausted``/``SplitFloorReached`` with their reason, name and
evidence, the restores and the ``RetryPolicy`` pauses under the same
seeded ``random``."""

import random
import threading
import types

import pytest

from spark_rapids_tpu.memory import exceptions as jexc
from spark_rapids_tpu.memory import rmm_spark as jrmm
from spark_rapids_tpu.memory import spark_resource_adaptor as jsra
from spark_rapids_tpu.robustness import retry as JR
from spark_rapids_tpu_torch.memory import exceptions as pexc
from spark_rapids_tpu_torch.memory import rmm_spark as prmm
from spark_rapids_tpu_torch.memory import spark_resource_adaptor as psra
from spark_rapids_tpu_torch.robustness import retry as PR

JAX = types.SimpleNamespace(R=JR, exc=jexc, rmm=jrmm, sra=jsra)
PORT = types.SimpleNamespace(R=PR, exc=pexc, rmm=prmm, sra=psra)


def quick(M, **kw):
    kw.setdefault("base_backoff_s", 0.0)
    return M.R.RetryPolicy(**kw)


def history(e):
    """A RetryExhausted as comparable values (elapsed time left out)."""
    return (type(e).__name__, e.name, e.reason, str(e),
            type(e.last).__name__ if e.last is not None else None,
            type(e.__cause__).__name__,
            [(a.index, a.kind, a.error, a.message, a.split_depth,
              a.batch_size) for a in e.attempts])


def attempts_backoff_restore(M):
    calls, sleeps, restores = [], [], []
    state = {"v": 0}

    def fn():
        state["v"] += 1
        calls.append(state["v"])
        if len(calls) < 4:
            raise M.exc.GpuRetryOOM(f"fail {len(calls)}")
        return state["v"]

    pol = M.R.RetryPolicy(base_backoff_s=0.01, backoff_multiplier=2.0,
                          max_backoff_s=0.025, jitter=False,
                          sleep=sleeps.append)
    out = M.R.with_retry(fn, checkpoint=lambda: dict(state),
                         restore=lambda s: (restores.append(1),
                                            state.update(s)),
                         policy=pol)
    return out, calls, len(restores), sleeps


def jittered_pauses(M):
    """Decorrelated jitter under one seeded random: the pauses with
    and without the previous pause threaded through, and each driver's
    actual sleeps."""
    rng = random.Random(2024)
    pol = M.R.RetryPolicy(base_backoff_s=0.01, max_backoff_s=0.3,
                          rng=rng.random)
    pauses, prev = [], None
    for n in range(1, 9):
        prev = pol.backoff_for(n, prev)
        pauses.append(prev)
    stateless = [pol.backoff_for(n) for n in range(1, 5)]
    sleeps = []
    seq = iter(range(6))

    def fn():
        if next(seq) < 5:
            raise M.exc.GpuRetryOOM("again")
        return "done"

    out = M.R.with_retry(fn, policy=M.R.RetryPolicy(
        base_backoff_s=0.002, rng=random.Random(7).random,
        sleep=sleeps.append))
    return pauses, stateless, out, sleeps


def exhausted_carries_history(M):
    def fn():
        raise M.exc.CudfException("kernel went sideways")

    with pytest.raises(M.R.RetryExhausted) as ei:
        M.R.with_retry(fn, name="doomed", policy=quick(M, max_attempts=3))
    return history(ei.value)


def deadline(M):
    clock = {"t": 0.0}

    def fake_sleep(s):
        clock["t"] += s

    def fn():
        clock["t"] += 1.0
        raise M.exc.GpuRetryOOM("slow fail")

    pol = M.R.RetryPolicy(max_attempts=100, base_backoff_s=0.1,
                          deadline_s=2.5, jitter=False, sleep=fake_sleep,
                          clock=lambda: clock["t"])
    with pytest.raises(M.R.RetryExhausted) as ei:
        M.R.with_retry(fn, policy=pol)
    return history(ei.value), clock["t"]


def split_degrades_to_recompute(M):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise M.exc.GpuSplitAndRetryOOM("split me")
        return "ok"

    return M.R.with_retry(fn, policy=quick(M)), len(calls)


def no_split_escalates(M):
    def fn():
        raise M.exc.GpuSplitAndRetryOOM("needs a splitter")

    with pytest.raises(M.exc.GpuSplitAndRetryOOM) as ei:
        M.R.with_retry_no_split(fn, policy=quick(M))
    return str(ei.value)


def terminal_errors_pass_through(M):
    out = []
    for err in (M.exc.GpuOOM("really out"), KeyError("not retried")):
        def fn(err=err):
            raise err
        with pytest.raises(type(err)):
            M.R.with_retry(fn, policy=quick(M))
        out.append(type(err).__name__)
    return out


def non_retryable_registered(M):
    class Corrupt(M.exc.CudfException):
        pass

    saved = M.R.NON_RETRYABLE
    M.R.register_non_retryable(Corrupt)
    calls = []
    try:
        def fn():
            calls.append(1)
            raise Corrupt("same bytes forever")
        with pytest.raises(Corrupt):
            M.R.with_retry(fn, policy=quick(M))
    finally:
        M.R.NON_RETRYABLE = saved
    return len(calls)


def split_halves_in_order(M):
    seen = []

    def fn(part):
        if len(part) > 2:
            raise M.exc.GpuSplitAndRetryOOM("too big")
        seen.append(list(part))
        return sum(part)

    out = M.R.split_and_retry(fn, [1, 2, 3, 4, 5, 6, 7],
                              policy=quick(M))
    return out, seen


def split_custom_splitter_combine(M):
    seen = []

    def fn(part):
        seen.append(tuple(part))
        if len(part) > 3:
            raise M.exc.GpuSplitAndRetryOOM("too big")
        return list(part)

    def thirds(part):
        k = max(1, len(part) // 3)
        return part[:k], part[k:]

    return M.R.split_and_retry(
        fn, list("abcdefghij"), batch_splitter=thirds, min_size=2,
        combine=lambda chunks: "".join(x for c in chunks for x in c),
        policy=quick(M)), seen


def split_combine_and_retryable(M):
    calls = []

    def fn(part):
        calls.append(list(part))
        if len(calls) == 1:
            raise M.exc.GpuRetryOOM("transient")
        return list(part)

    out = M.R.split_and_retry(
        fn, ["a", "b"], policy=quick(M),
        combine=lambda parts: [x for p in parts for x in p])
    return out, calls


def split_one_element_floor(M):
    def fn(part):
        raise M.exc.GpuSplitAndRetryOOM("always")

    with pytest.raises(M.R.SplitFloorReached) as ei:
        M.R.split_and_retry(fn, [10, 20, 30], name="floor",
                            policy=quick(M))
    return history(ei.value), ei.value.resident_bytes


def split_attempt_budget_per_part(M):
    def fn(part):
        raise M.exc.GpuRetryOOM("never works")

    with pytest.raises(M.R.RetryExhausted) as ei:
        M.R.split_and_retry(fn, [1], policy=quick(M, max_attempts=4))
    return history(ei.value)


def on_task_thread(M, task_id, steps):
    """Run steps(adaptor) on a fresh thread registered to task_id under
    the package's RmmSpark facade; returns what it returned."""
    M.rmm.set_event_handler(64 << 20)
    out = {}

    def body():
        try:
            M.rmm.current_thread_is_dedicated_to_task(task_id)
            out["v"] = steps(M.rmm.get_adaptor())
        except BaseException as e:  # noqa: BLE001
            out["e"] = e

    try:
        t = threading.Thread(target=body, daemon=True)
        t.start()
        t.join(10)
        assert not t.is_alive(), "task thread did not finish"
    finally:
        M.rmm.clear_event_handler()
    if "e" in out:
        raise out["e"]
    return out["v"]


def forced_oom_in_compute_only_section(M):
    def steps(ad):
        M.rmm.force_retry_oom(threading.get_ident(), 2)
        calls = []
        out = M.R.with_retry(lambda: calls.append(1) or "done",
                             policy=quick(M))
        return out, len(calls), ad.get_and_reset_num_retry_throw(11)
    return on_task_thread(M, 11, steps)


def forced_split_drives_splitter(M):
    def steps(ad):
        M.rmm.force_split_and_retry_oom(threading.get_ident(), 1)
        out = M.R.split_and_retry(lambda p: list(p), [1, 2, 3, 4],
                                  policy=quick(M))
        return out, ad.get_and_reset_num_split_retry_throw(12)
    return on_task_thread(M, 12, steps)


def forced_cpu_filtered_oom(M):
    def steps(ad):
        M.rmm.force_retry_oom(threading.get_ident(), 1,
                              oom_filter=M.sra.CPU)
        calls = []
        out = M.R.with_retry(lambda: calls.append(1) or "done",
                             policy=quick(M))
        return out, len(calls), ad.get_and_reset_num_retry_throw(13)
    return on_task_thread(M, 13, steps)


def forced_skip_count_single_consume(M):
    def steps(ad):
        M.rmm.force_retry_oom(threading.get_ident(), 1,
                              oom_filter=M.sra.CPU_OR_GPU, skip_count=1)
        calls = []
        a = M.R.with_retry(lambda: calls.append(1) or "a",
                           policy=quick(M))
        n1 = ad.get_and_reset_num_retry_throw(14)
        b = M.R.with_retry(lambda: calls.append(1) or "b",
                           policy=quick(M))
        return a, b, len(calls), n1, ad.get_and_reset_num_retry_throw(14)
    return on_task_thread(M, 14, steps)


def forced_cudf_exception_retried(M):
    def steps(ad):
        M.rmm.force_cudf_exception(threading.get_ident(), 2)
        out = M.R.with_retry(lambda: "done", name="cudf",
                             policy=quick(M))
        M.rmm.force_cudf_exception(threading.get_ident(), 5)
        with pytest.raises(M.R.RetryExhausted) as ei:
            M.R.with_retry(lambda: "never", name="cudf",
                           policy=quick(M, max_attempts=3))
        return out, history(ei.value)
    return on_task_thread(M, 15, steps)


def check_hook_noop_unregistered(M):
    M.rmm.set_event_handler(64 << 20)
    try:
        M.rmm.get_adaptor().check_injected_oom()
        M.R.check_injected_oom("anything")
        return M.R.with_retry(lambda: "x", policy=quick(M))
    finally:
        M.rmm.clear_event_handler()


SCENARIOS = [attempts_backoff_restore, jittered_pauses,
             exhausted_carries_history, deadline,
             split_degrades_to_recompute, no_split_escalates,
             terminal_errors_pass_through, non_retryable_registered,
             split_halves_in_order, split_custom_splitter_combine,
             split_combine_and_retryable, split_one_element_floor,
             split_attempt_budget_per_part,
             forced_oom_in_compute_only_section,
             forced_split_drives_splitter, forced_cpu_filtered_oom,
             forced_skip_count_single_consume,
             forced_cudf_exception_retried, check_hook_noop_unregistered]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_driver_matches_reference(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_reference_expectations_hold_in_the_port():
    """A few of tests/test_retry_runtime.py's own expectations, on the
    port's results."""
    out, calls, restores, sleeps = attempts_backoff_restore(PORT)
    assert (out, calls, restores) == (1, [1, 1, 1, 1], 3)
    assert sleeps == [0.01, 0.02, 0.025]
    out, seen = split_halves_in_order(PORT)
    assert [x for p in seen for x in p] == [1, 2, 3, 4, 5, 6, 7]
    assert sum(out) == 28
    hist, resident = split_one_element_floor(PORT)
    assert hist[0] == "SplitFloorReached" and hist[2] == "split_floor"
    assert resident == {}
    assert forced_split_drives_splitter(PORT) == ([[1, 2], [3, 4]], 1)
    hist, t = deadline(PORT)
    assert hist[2] == "deadline" and hist[4] == "GpuRetryOOM" and t < 10
