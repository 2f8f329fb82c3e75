"""PyTorch port: the OOM state machine (memory/spark_resource_adaptor.py)
and the RmmSpark facade held against the JAX package's.  Every scenario
of tests/test_rmm_spark.py is replayed as the same scripted steps on
task threads against both adaptors: the same observations (exception
types, states, metrics, reserved bytes), the same final states and
metrics, and — where the steps fix the order of events — the same CSV
transition log line for line, with the time column dropped and thread
ids mapped to first-seen ordinals.  Then the seeded Monte Carlo of
tests/test_rmm_monte_carlo.py against the port: no deadlock, no leak,
and the retry path reached.  Every thread join has a time limit."""

import queue
import random
import threading
import time
import types
from concurrent.futures import Future

import pytest

from spark_rapids_tpu.memory import exceptions as jexc
from spark_rapids_tpu.memory import resource as jres
from spark_rapids_tpu.memory import rmm_spark as jrmm
from spark_rapids_tpu.memory import spark_resource_adaptor as jsra
from spark_rapids_tpu_torch.memory import exceptions as pexc
from spark_rapids_tpu_torch.memory import resource as pres
from spark_rapids_tpu_torch.memory import rmm_spark as prmm
from spark_rapids_tpu_torch.memory import spark_resource_adaptor as psra
from spark_rapids_tpu_torch.memory import task_priority as ptp

TIMEOUT = 10
JAX = types.SimpleNamespace(exc=jexc, sra=jsra, res=jres, rmm=jrmm)
PORT = types.SimpleNamespace(exc=pexc, sra=psra, res=pres, rmm=prmm)


@pytest.fixture(autouse=True)
def _observability_off():
    """Both packages' observability switches off for the replay, and
    restored afterwards.  With a package's switch on, its facade's
    ``task_done`` folds the finished task's counters into the
    observability rollup and drops them from the adaptor, so a switch
    left on by an earlier test in the same worker process made the two
    packages read different ``get_and_reset_*`` counters."""
    from spark_rapids_tpu import observability as jobs
    from spark_rapids_tpu_torch import observability as pobs
    prior = [(m, m.is_enabled()) for m in (jobs, pobs)]
    for m, _ in prior:
        m.disable()
    yield
    for m, on in prior:
        if on:
            m.enable()


class TaskThread:
    """A worker executing queued ops (RmmSparkTest TaskThread analog)."""

    def __init__(self, adaptor, task_id=None):
        self.adaptor = adaptor
        self.task_id = task_id
        self._q = queue.Queue()
        self.ident = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        assert self._started.wait(TIMEOUT)

    def _run(self):
        self.ident = threading.get_ident()
        if self.task_id is not None:
            self.adaptor.start_dedicated_task_thread(self.ident,
                                                     self.task_id)
        self._started.set()
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

    def do(self, fn) -> Future:
        fut = Future()
        self._q.put((fn, fut))
        return fut

    def done(self):
        self._q.put(None)
        self._thread.join(TIMEOUT)
        assert not self._thread.is_alive(), "task thread did not finish"


def outcome(fut) -> str:
    """'ok' or the raised exception's class name."""
    try:
        fut.result(TIMEOUT)
        return "ok"
    except BaseException as e:  # noqa: BLE001
        return type(e).__name__


def wait_for(cond, what):
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


def wait_parked(a, ident, n=1):
    """Until the thread has logged its n-th WAITING row (it is parked in
    the adaptor's condition wait): fixes the order of the next step."""
    def parked():
        rows = [r.split(",") for r in a.get_log()[1:]]
        return sum(1 for r in rows
                   if r[1] == "WAITING" and r[3] == str(ident)) >= n
    wait_for(parked, f"thread {ident} to park")


# ---------------------------------------------------------------- scenarios
# each drives an adaptor `a` of package `M` and returns its observations


def sc_basic_alloc_free(a, M):
    t = TaskThread(a, task_id=1)
    obs = [a.get_state_of(t.ident)]
    t.do(lambda: a.allocate(500)).result(TIMEOUT)
    obs.append(a.resource.used)
    t.do(lambda: a.deallocate(500)).result(TIMEOUT)
    obs.append(a.resource.used)
    a.task_done(1)
    t.done()
    return obs


def sc_forced_retry_oom(a, M):
    t = TaskThread(a, task_id=1)
    a.force_retry_oom(t.ident, 1)
    obs = [outcome(t.do(lambda: a.allocate(10)))]
    obs.append(outcome(t.do(lambda: a.allocate(10))))
    obs += [a.get_and_reset_num_retry_throw(1),
            a.get_and_reset_num_retry_throw(1)]
    a.task_done(1)
    t.done()
    return obs


def sc_forced_split_and_retry_oom(a, M):
    t = TaskThread(a, task_id=1)
    a.force_split_and_retry_oom(t.ident, 1)
    obs = [outcome(t.do(lambda: a.allocate(10))),
           a.get_and_reset_num_split_retry_throw(1)]
    a.task_done(1)
    t.done()
    return obs


def sc_forced_cudf_exception(a, M):
    t = TaskThread(a, task_id=1)
    a.force_cudf_exception(t.ident, 1)
    obs = [outcome(t.do(lambda: a.allocate(10)))]
    a.task_done(1)
    t.done()
    return obs


def sc_skip_count_injection(a, M):
    t = TaskThread(a, task_id=1)
    a.force_retry_oom(t.ident, 1, M.sra.GPU, skip_count=2)
    obs = [outcome(t.do(lambda: a.allocate(1))) for _ in range(3)]
    a.task_done(1)
    t.done()
    return obs


def sc_block_until_free(a, M):
    t1 = TaskThread(a, task_id=1)
    t2 = TaskThread(a, task_id=2)
    t1.do(lambda: a.allocate(800)).result(TIMEOUT)
    fut = t2.do(lambda: a.allocate(800))
    wait_parked(a, t2.ident)
    obs = [a.get_state_of(t2.ident), fut.done()]
    t1.do(lambda: a.deallocate(800)).result(TIMEOUT)
    obs += [outcome(fut), a.resource.used]
    a.task_done(1)
    a.task_done(2)
    t1.done()
    t2.done()
    return obs


def sc_bufn_and_split_full_cycle(a, M):
    t1 = TaskThread(a, task_id=1)
    t2 = TaskThread(a, task_id=2)
    t1.do(lambda: a.allocate(600)).result(TIMEOUT)
    fut2 = t2.do(lambda: a.allocate(600))
    wait_parked(a, t2.ident)
    fut1 = t1.do(lambda: a.allocate(600))
    obs = [outcome(fut2)]
    fut2b = t2.do(lambda: a.block_thread_until_ready(t2.ident))
    wait_for(lambda: a.get_state_of(t2.ident) == M.sra.THREAD_BUFN,
             "task 2 to park BUFN")
    obs.append(outcome(fut1))
    t1.do(lambda: a.deallocate(600)).result(TIMEOUT)
    obs.append(outcome(t1.do(lambda: a.block_thread_until_ready(t1.ident))))
    for n in (300, 300):
        t1.do(lambda n=n: a.allocate(n)).result(TIMEOUT)
    t1.do(lambda: a.deallocate(600)).result(TIMEOUT)
    a.task_done(1)
    obs.append(outcome(fut2b))
    obs.append(outcome(t2.do(lambda: a.allocate(600))))
    obs += [a.get_and_reset_num_split_retry_throw(1),
            a.get_and_reset_num_retry_throw(2)]
    a.task_done(2)
    t1.done()
    t2.done()
    return obs


def sc_shuffle_thread_wakes_first(a, M):
    t1 = TaskThread(a, task_id=5)
    shuf = TaskThread(a)
    a.pool_thread_working_on_tasks(True, shuf.ident, [5])
    idle = TaskThread(a, task_id=6)
    idle.do(lambda: a.allocate(900)).result(TIMEOUT)
    fut_task = t1.do(lambda: a.allocate(900))
    wait_parked(a, t1.ident)
    fut_shuf = shuf.do(lambda: a.allocate(500))
    wait_parked(a, shuf.ident)
    idle.do(lambda: a.deallocate(900)).result(TIMEOUT)
    obs = [outcome(fut_shuf)]
    # the shuffle thread's success woke the task thread, which cannot
    # fit yet and parks again
    wait_parked(a, t1.ident, 2)
    obs.append(fut_task.done())
    shuf.do(lambda: a.deallocate(500)).result(TIMEOUT)
    obs.append(outcome(fut_task))
    a.task_done(5)
    a.task_done(6)
    for t in (t1, shuf, idle):
        t.done()
    return obs


def sc_remove_blocked_thread_throws(a, M):
    t1 = TaskThread(a, task_id=1)
    t2 = TaskThread(a, task_id=2)
    t1.do(lambda: a.allocate(900)).result(TIMEOUT)
    fut = t2.do(lambda: a.allocate(900))
    wait_parked(a, t2.ident)
    a.remove_thread_association(t2.ident, -1)
    obs = [outcome(fut)]
    a.task_done(1)
    t1.done()
    t2.done()
    return obs


def sc_csv_log(a, M):
    t = TaskThread(a, task_id=1)
    t.do(lambda: a.allocate(10)).result(TIMEOUT)
    log = a.get_log()
    obs = [log[0], any("TRANSITION" in r and "THREAD_ALLOC" in r
                       for r in log)]
    a.task_done(1)
    t.done()
    return obs


def sc_metrics_block_time(a, M):
    t1 = TaskThread(a, task_id=1)
    t2 = TaskThread(a, task_id=2)
    t1.do(lambda: a.allocate(900)).result(TIMEOUT)
    fut = t2.do(lambda: a.allocate(900))
    wait_parked(a, t2.ident)
    time.sleep(0.02)
    t1.do(lambda: a.deallocate(900)).result(TIMEOUT)
    obs = [outcome(fut), a.get_and_reset_block_time(2) > 0]
    a.task_done(1)
    a.task_done(2)
    t1.done()
    t2.done()
    return obs


def sc_remove_task_metrics(a, M):
    t = TaskThread(a, task_id=9)
    a.force_retry_oom(t.ident, 1)
    obs = [outcome(t.do(lambda: a.allocate(10)))]
    a.task_done(9)
    obs.append(a.get_and_reset_num_retry_throw(9))
    a.remove_task_metrics(9)
    obs.append(9 in a._checkpointed)
    t.done()
    return obs


def sc_pool_blocked_deadlock(a, M):
    t1 = TaskThread(a, task_id=1)
    pool = TaskThread(a)
    a.pool_thread_working_on_tasks(False, pool.ident, [1])
    pool.do(lambda: a.allocate(800)).result(TIMEOUT)
    fut = pool.do(lambda: a.allocate(800))
    wait_parked(a, pool.ident)
    t1.do(lambda: a.thread_waiting_on_pool(t1.ident)).result(TIMEOUT)
    obs = [outcome(fut)]
    t1.do(lambda: a.thread_done_waiting_on_pool(t1.ident)).result(TIMEOUT)
    pool.do(lambda: a.deallocate(800)).result(TIMEOUT)
    a.task_done(1)
    t1.done()
    pool.done()
    return obs


def sc_cpu_alloc_bracket(a, M):
    def steps():
        tid = threading.get_ident()
        a.start_dedicated_task_thread(tid, 1)
        out = []
        try:
            r = a.cpu_prealloc(100, blocking=False)
            out.append(r)
            a.post_cpu_alloc_success(100, False, r)
            a.cpu_deallocate(100)
            r = a.cpu_prealloc(50, blocking=False)
            inner = a.cpu_prealloc(10, blocking=False)
            out += [r, inner, a.post_cpu_alloc_failed(False, False, inner),
                    a.post_cpu_alloc_failed(False, False, r)]
            a.force_retry_oom(tid, 1, M.sra.CPU, 0)
            try:
                a.cpu_prealloc(10, blocking=False)
                out.append("ok")
            except M.exc.CpuRetryOOM as e:
                out.append(type(e).__name__)
        finally:
            a.remove_thread_association(tid, 1)
            a.task_done(1)
        return out

    t = TaskThread(a)
    obs = t.do(steps).result(TIMEOUT)
    t.done()
    return obs


def sc_cpu_split_injection(a, M):
    def steps():
        tid = threading.get_ident()
        a.start_dedicated_task_thread(tid, 1)
        out = []
        try:
            a.force_split_and_retry_oom(tid, 1, M.sra.CPU, 0)
            try:
                a.cpu_prealloc(10, blocking=False)
                out.append("ok")
            except M.exc.CpuSplitAndRetryOOM as e:
                out.append(type(e).__name__)
            a.force_retry_oom(tid, 1, M.sra.GPU, 0)
            r = a.cpu_prealloc(5, blocking=False)
            a.post_cpu_alloc_success(5, False, r)
            a.cpu_deallocate(5)
            out.append(r)
        finally:
            a.remove_thread_association(tid, 1)
            a.task_done(1)
        return out

    t = TaskThread(a)
    obs = t.do(steps).result(TIMEOUT)
    t.done()
    return obs


def sc_cpu_bufn_throw(a, M):
    barrier = threading.Barrier(2, timeout=TIMEOUT)
    errs = {}

    def worker(task_id):
        tid = threading.get_ident()
        a.start_dedicated_task_thread(tid, task_id)
        try:
            r = a.cpu_prealloc(100, blocking=True)
            barrier.wait()
            a.post_cpu_alloc_failed(True, True, r)
            a.block_thread_until_ready(tid)
        except (M.exc.CpuRetryOOM, M.exc.GpuRetryOOM) as e:
            errs[task_id] = type(e).__name__
        finally:
            a.remove_thread_association(tid, task_id)
            a.task_done(task_id)

    ts = [threading.Thread(target=worker, args=(i,)) for i in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in ts)
    return [sorted(errs.values())]


def sc_rmm_spark_facade(a, M):
    M.rmm.set_event_handler(1000)
    try:
        M.rmm.current_thread_is_dedicated_to_task(42)
        g = M.rmm.get_adaptor()
        obs = [g.get_state_of(M.rmm.current_thread_id())]
        g.allocate(100)
        g.deallocate(100)
        obs.append(M.rmm.task_done(42))
        try:
            M.rmm.set_event_handler(10)
            obs.append("ok")
        except RuntimeError as e:
            obs.append(str(e))
        obs.append(g.get_state_of(M.rmm.current_thread_id()))
    finally:
        M.rmm.clear_event_handler()
    return obs


# scenario -> whether its steps fix the order of every logged event
SCENARIOS = {
    "basic_alloc_free": (sc_basic_alloc_free, True),
    "forced_retry_oom": (sc_forced_retry_oom, True),
    "forced_split_and_retry_oom": (sc_forced_split_and_retry_oom, True),
    "forced_cudf_exception": (sc_forced_cudf_exception, True),
    "skip_count_injection": (sc_skip_count_injection, True),
    "block_until_free": (sc_block_until_free, True),
    "bufn_and_split_full_cycle": (sc_bufn_and_split_full_cycle, False),
    "shuffle_thread_wakes_first": (sc_shuffle_thread_wakes_first, True),
    "remove_blocked_thread_throws": (sc_remove_blocked_thread_throws,
                                     True),
    "csv_log": (sc_csv_log, True),
    "metrics_block_time": (sc_metrics_block_time, True),
    "remove_task_metrics": (sc_remove_task_metrics, True),
    "pool_blocked_deadlock": (sc_pool_blocked_deadlock, True),
    "cpu_alloc_bracket": (sc_cpu_alloc_bracket, True),
    "cpu_split_injection": (sc_cpu_split_injection, True),
    "cpu_bufn_throw": (sc_cpu_bufn_throw, False),
    "rmm_spark_facade": (sc_rmm_spark_facade, True),
}
TASKS = (1, 2, 5, 6, 9, 42)


def normalized_log(rows):
    """The CSV rows without the time column, thread ids as first-seen
    ordinals."""
    ids = {}

    def ordinal(tid):
        return ids.setdefault(tid, f"T{len(ids)}")

    out = [rows[0]]
    for row in rows[1:]:
        f = row.split(",")
        out.append(",".join([f[1], ordinal(f[2]), ordinal(f[3])] + f[4:]))
    return out


def final_metrics(a):
    out = {}
    for task in TASKS:
        out[task] = (a.get_and_reset_num_retry_throw(task),
                     a.get_and_reset_num_split_retry_throw(task),
                     a.get_and_reset_block_time(task) > 0,
                     a.get_and_reset_compute_time_lost_to_retry(task) > 0,
                     a.get_and_reset_gpu_max_memory_allocated(task),
                     a.get_max_gpu_task_memory(task))
    return out


def run_scenario(name, M):
    fn, _ = SCENARIOS[name]
    if name == "rmm_spark_facade":
        captured = {}
        real = M.rmm.SparkResourceAdaptor

        def capture(*args, **kw):
            captured["a"] = real(*args, **kw)
            return captured["a"]

        M.rmm.SparkResourceAdaptor = capture
        try:
            obs = fn(None, M)
        finally:
            M.rmm.SparkResourceAdaptor = real
        a = captured["a"]
    else:
        a = M.sra.SparkResourceAdaptor(M.res.LimitingMemoryResource(1000))
        obs = fn(a, M)
    result = {"obs": obs, "log": a.get_log(), "used": a.resource.used,
              "allocated": a.gpu_memory_allocated_bytes,
              "states": [(d["task"], d["state"])
                         for d in a.thread_state_dump()],
              "metrics": final_metrics(a)}
    a.shutdown()
    return result


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_adaptor_scenario_matches_reference(name):
    want = run_scenario(name, JAX)
    got = run_scenario(name, PORT)
    assert got["obs"] == want["obs"]
    for key in ("used", "allocated", "states", "metrics"):
        assert got[key] == want[key], key
    assert got["states"] == []
    if SCENARIOS[name][1]:
        assert normalized_log(got["log"]) == normalized_log(want["log"])
    else:
        assert got["log"][0] == want["log"][0]


def test_scenario_observations_are_the_reference_tests():
    """The replay drives what tests/test_rmm_spark.py asserts."""
    obs = {n: run_scenario(n, PORT)["obs"]
           for n in ("forced_retry_oom", "block_until_free",
                     "bufn_and_split_full_cycle", "cpu_bufn_throw")}
    assert obs["forced_retry_oom"] == ["GpuRetryOOM", "ok", 1, 0]
    assert obs["block_until_free"] == [psra.THREAD_BLOCKED, False, "ok",
                                       800]
    assert obs["bufn_and_split_full_cycle"] == [
        "GpuRetryOOM", "GpuRetryOOM", "GpuSplitAndRetryOOM", "ok", "ok",
        1, 1]
    assert obs["cpu_bufn_throw"] == [["CpuRetryOOM"]]


def test_task_priority_and_thread_registry():
    reg = ptp.TaskPriorityRegistry()
    a, b = reg.get_task_priority(10), reg.get_task_priority(11)
    assert a > b and reg.get_task_priority(10) == a
    assert reg.get_task_priority(-1) == (1 << 63) - 1
    reg.task_done(10)
    assert reg.get_task_priority(10) < b
    assert reg.stats()["live_entries"] == 2
    from spark_rapids_tpu_torch.memory.thread_state_registry import \
        ThreadStateRegistry
    tsr = ThreadStateRegistry()
    ad = psra.SparkResourceAdaptor(pres.LimitingMemoryResource(100))
    ad.on_thread_removed = tsr.remove_thread
    t = TaskThread(ad, task_id=3)
    tsr.add_thread(t.ident)
    assert tsr.known_threads() == [t.ident]
    ad.task_done(3)
    assert tsr.known_threads() == []
    t.done()


# ------------------------------------------------------------ Monte Carlo


def run_task(adaptor, task_id, seed, skewed, stats, stats_lock):
    """One Spark task's life under the retry framework (the reference
    Monte Carlo's run_task): allocate a working set in chunks; on
    GpuRetryOOM free everything, park (BUFN), retry; on
    GpuSplitAndRetryOOM halve the chunk size and retry."""
    rng = random.Random(seed)
    tid = threading.get_ident()
    adaptor.start_dedicated_task_thread(tid, task_id)
    retries = splits = 0
    try:
        for _ in range(rng.randint(1, 4)):
            if skewed == "pressure":
                target = rng.randint(400, 900)
                chunk = max(1, target // 4)
            else:
                target = rng.randint(50, 600 if skewed and task_id % 5 == 0
                                     else 250)
                chunk = target
            held = []
            done = parked = False
            while not done:
                try:
                    if parked:
                        adaptor.block_thread_until_ready(tid)
                        parked = False
                    while sum(held) < target:
                        adaptor.allocate(chunk)
                        held.append(chunk)
                        if rng.random() < 0.3:
                            time.sleep(0.001)
                    done = True
                except pexc.GpuRetryOOM:
                    retries += 1
                    for h in held:
                        adaptor.deallocate(h)
                    held = []
                    parked = True
                except pexc.GpuSplitAndRetryOOM:
                    splits += 1
                    for h in held:
                        adaptor.deallocate(h)
                    held = []
                    if chunk <= 1:
                        raise
                    chunk = max(1, chunk // 2)
            for h in held:
                adaptor.deallocate(h)
            if rng.random() < 0.5:
                time.sleep(0.001)
    finally:
        adaptor.task_done(task_id)
    with stats_lock:
        stats["retries"] += retries
        stats["splits"] += splits
        stats["completed"] += 1


def monte_carlo(n_tasks, seed0, skewed):
    adaptor = psra.SparkResourceAdaptor(pres.LimitingMemoryResource(1000))
    stats = {"retries": 0, "splits": 0, "completed": 0}
    lock = threading.Lock()
    threads = [threading.Thread(
        target=run_task, args=(adaptor, i, seed0 + i, skewed, stats, lock),
        daemon=True) for i in range(n_tasks)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 60
    for th in threads:
        th.join(max(0.1, deadline - time.monotonic()))
        assert not th.is_alive(), "stress run deadlocked"
    assert stats["completed"] == n_tasks
    assert adaptor.resource.used == 0, "leaked reservations"
    assert adaptor.gpu_memory_allocated_bytes == 0
    adaptor.shutdown()
    return stats


@pytest.mark.parametrize("skewed", [False, True])
def test_monte_carlo_no_deadlock_no_leak(skewed):
    monte_carlo(24, 1234, skewed)


def test_monte_carlo_high_pressure_hits_retry_path():
    stats = monte_carlo(8, 99, "pressure")
    assert stats["retries"] + stats["splits"] > 0, \
        "high-pressure run never hit the retry machinery"
