"""PyTorch port: the three ctypes wrappers (memory/native_adaptor.py,
shuffle/kudo_native.py, utils/native.py), built with g++ from native/
into build/native/, and utils/arms.py and utils/platform.py.

The OOM state-machine scenarios are tests/test_rmm_spark.py's, run over
the port's Python adaptor and its native adaptor; the native kudo
engine's bytes are held to the port's spec engine, to the JAX package's
spec engine and to the JAX package's binding of the same library
(tests/test_kudo_native.py's cases); the native string rank is held to
the JAX package's.  Where g++ is missing only the native cases skip."""

import io
import queue
import shutil
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import torch_port_data as D
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.memory import exceptions as exc
from spark_rapids_tpu_torch.memory import native_adaptor
from spark_rapids_tpu_torch.memory import rmm_spark
from spark_rapids_tpu_torch.memory import spark_resource_adaptor as sra
from spark_rapids_tpu_torch.memory.resource import LimitingMemoryResource
from spark_rapids_tpu_torch.memory.spark_resource_adaptor import (
    THREAD_BLOCKED, THREAD_BUFN, THREAD_RUNNING)
from spark_rapids_tpu_torch.shuffle import kudo, kudo_native
from spark_rapids_tpu_torch.shuffle.schema import schema_of_table
from spark_rapids_tpu_torch.utils import native

TIMEOUT = 10
HAVE_GPP = shutil.which("g++") is not None
needs_gpp = pytest.mark.skipif(not HAVE_GPP, reason="no g++ to build "
                               "the native libraries")


# ------------------------------------------- the OOM state machine


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
        self._started.wait(TIMEOUT)

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


def wait_state(adaptor, ident, state, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if adaptor.get_state_of(ident) == state:
            return True
        time.sleep(0.005)
    return False


@pytest.fixture(params=["python", "native"])
def adaptor(request):
    """Every state-machine scenario runs against the port's Python
    adaptor and its C++ one (native/spark_resource_adaptor.cpp)."""
    if request.param == "python":
        a = sra.SparkResourceAdaptor(LimitingMemoryResource(1000))
    else:
        if not HAVE_GPP:
            pytest.skip("no g++ to build the native adaptor")
        assert native_adaptor.available()
        a = native_adaptor.NativeSparkResourceAdaptor(1000)
    yield a
    a.shutdown()


def test_basic_alloc_free(adaptor):
    t = TaskThread(adaptor, task_id=1)
    assert adaptor.get_state_of(t.ident) == THREAD_RUNNING
    t.do(lambda: adaptor.allocate(500)).result(TIMEOUT)
    assert adaptor.resource.used == 500
    t.do(lambda: adaptor.deallocate(500)).result(TIMEOUT)
    assert adaptor.resource.used == 0
    adaptor.task_done(1)
    t.done()


def test_forced_retry_oom(adaptor):
    t = TaskThread(adaptor, task_id=1)
    adaptor.force_retry_oom(t.ident, 1)
    with pytest.raises(exc.GpuRetryOOM):
        t.do(lambda: adaptor.allocate(10)).result(TIMEOUT)
    # next alloc works
    t.do(lambda: adaptor.allocate(10)).result(TIMEOUT)
    assert adaptor.get_and_reset_num_retry_throw(1) == 1
    assert adaptor.get_and_reset_num_retry_throw(1) == 0
    adaptor.task_done(1)
    t.done()


def test_forced_split_and_retry_oom(adaptor):
    t = TaskThread(adaptor, task_id=1)
    adaptor.force_split_and_retry_oom(t.ident, 1)
    with pytest.raises(exc.GpuSplitAndRetryOOM):
        t.do(lambda: adaptor.allocate(10)).result(TIMEOUT)
    assert adaptor.get_and_reset_num_split_retry_throw(1) == 1
    adaptor.task_done(1)
    t.done()


def test_forced_cudf_exception(adaptor):
    t = TaskThread(adaptor, task_id=1)
    adaptor.force_cudf_exception(t.ident, 1)
    with pytest.raises(exc.CudfException):
        t.do(lambda: adaptor.allocate(10)).result(TIMEOUT)
    adaptor.task_done(1)
    t.done()


def test_skip_count_injection(adaptor):
    t = TaskThread(adaptor, task_id=1)
    adaptor.force_retry_oom(t.ident, 1, sra.GPU, skip_count=2)
    t.do(lambda: adaptor.allocate(1)).result(TIMEOUT)
    t.do(lambda: adaptor.allocate(1)).result(TIMEOUT)
    with pytest.raises(exc.GpuRetryOOM):
        t.do(lambda: adaptor.allocate(1)).result(TIMEOUT)
    adaptor.task_done(1)
    t.done()


def test_block_until_free(adaptor):
    """An OOM alloc blocks; a free from another task wakes and retries it
    (reference testShuffleBlocking shape)."""
    t1 = TaskThread(adaptor, task_id=1)
    t2 = TaskThread(adaptor, task_id=2)
    t1.do(lambda: adaptor.allocate(800)).result(TIMEOUT)
    fut = t2.do(lambda: adaptor.allocate(800))  # cannot fit -> blocks
    assert wait_state(adaptor, t2.ident, THREAD_BLOCKED)
    assert not fut.done()
    t1.do(lambda: adaptor.deallocate(800)).result(TIMEOUT)
    fut.result(TIMEOUT)  # woken and retried successfully
    assert adaptor.resource.used == 800
    adaptor.task_done(1)
    adaptor.task_done(2)
    t1.done()
    t2.done()


def test_bufn_and_split_full_cycle(adaptor):
    """Both tasks block -> lower-priority task rolls back (GpuRetryOOM) and
    parks BUFN -> remaining task retries once, then rolls back -> all BUFN
    -> highest-priority task splits (GpuSplitAndRetryOOM) and completes
    with smaller allocations (docs/memory_management.md deadlock flow)."""
    t1 = TaskThread(adaptor, task_id=1)
    t2 = TaskThread(adaptor, task_id=2)
    t1.do(lambda: adaptor.allocate(600)).result(TIMEOUT)

    fut2 = t2.do(lambda: adaptor.allocate(600))  # blocks
    assert wait_state(adaptor, t2.ident, THREAD_BLOCKED)

    fut1 = t1.do(lambda: adaptor.allocate(600))  # blocks -> deadlock
    # task2 (lowest priority) must be told to roll back
    with pytest.raises(exc.GpuRetryOOM):
        fut2.result(TIMEOUT)
    # retry framework: task2 made everything spillable (nothing held) and
    # parks BUFN
    fut2b = t2.do(lambda: adaptor.block_thread_until_ready(t2.ident))
    assert wait_state(adaptor, t2.ident, THREAD_BUFN)

    # task1 was the last blocked thread: it retried once
    # (is_retry_alloc_before_bufn), failed again, and must roll back too
    with pytest.raises(exc.GpuRetryOOM):
        fut1.result(TIMEOUT)
    # task1 rolls back: frees its 600 and parks; all tasks now BUFN ->
    # task1 (highest priority) is selected to split
    t1.do(lambda: adaptor.deallocate(600)).result(TIMEOUT)
    with pytest.raises(exc.GpuSplitAndRetryOOM):
        t1.do(lambda: adaptor.block_thread_until_ready(t1.ident)).result(
            TIMEOUT)
    # split: task1 allocates half at a time
    t1.do(lambda: adaptor.allocate(300)).result(TIMEOUT)
    t1.do(lambda: adaptor.allocate(300)).result(TIMEOUT)
    t1.do(lambda: adaptor.deallocate(600)).result(TIMEOUT)
    adaptor.task_done(1)
    # task2 wakes after task1 finishes and completes its allocation
    fut2b.result(TIMEOUT)
    t2.do(lambda: adaptor.allocate(600)).result(TIMEOUT)
    assert adaptor.get_and_reset_num_split_retry_throw(1) == 1
    assert adaptor.get_and_reset_num_retry_throw(2) == 1
    adaptor.task_done(2)
    t1.done()
    t2.done()


def test_shuffle_thread_wakes_first(adaptor):
    """Shuffle (pool) threads have the highest priority: woken before task
    threads when memory frees up (docs/memory_management.md:38-42)."""
    t1 = TaskThread(adaptor, task_id=5)
    shuf = TaskThread(adaptor)  # no dedicated task
    adaptor.pool_thread_working_on_tasks(True, shuf.ident, [5])
    idle = TaskThread(adaptor, task_id=6)  # stays runnable: no deadlock
    idle.do(lambda: adaptor.allocate(900)).result(TIMEOUT)

    fut_task = t1.do(lambda: adaptor.allocate(900))
    assert wait_state(adaptor, t1.ident, THREAD_BLOCKED)
    fut_shuf = shuf.do(lambda: adaptor.allocate(500))
    assert wait_state(adaptor, shuf.ident, THREAD_BLOCKED)

    # free: the shuffle thread must be woken first (highest priority)
    idle.do(lambda: adaptor.deallocate(900)).result(TIMEOUT)
    fut_shuf.result(TIMEOUT)  # shuffle thread won the freed memory first
    assert not fut_task.done()
    shuf.do(lambda: adaptor.deallocate(500)).result(TIMEOUT)
    fut_task.result(TIMEOUT)  # then the task thread gets the rest
    adaptor.task_done(5)
    adaptor.task_done(6)
    t1.done()
    shuf.done()
    idle.done()


def test_remove_blocked_thread_throws(adaptor):
    t1 = TaskThread(adaptor, task_id=1)
    t2 = TaskThread(adaptor, task_id=2)
    t1.do(lambda: adaptor.allocate(900)).result(TIMEOUT)
    fut = t2.do(lambda: adaptor.allocate(900))
    assert wait_state(adaptor, t2.ident, THREAD_BLOCKED)
    adaptor.remove_thread_association(t2.ident, -1)
    with pytest.raises(exc.ThreadRemovedException):
        fut.result(TIMEOUT)
    adaptor.task_done(1)
    t1.done()
    t2.done()


def test_csv_log(adaptor):
    t = TaskThread(adaptor, task_id=1)
    t.do(lambda: adaptor.allocate(10)).result(TIMEOUT)
    log = adaptor.get_log()
    assert log[0].startswith("time,op,current thread")
    assert any("TRANSITION" in r and "THREAD_ALLOC" in r for r in log)
    adaptor.task_done(1)
    t.done()


def test_metrics_block_time(adaptor):
    t1 = TaskThread(adaptor, task_id=1)
    t2 = TaskThread(adaptor, task_id=2)
    t1.do(lambda: adaptor.allocate(900)).result(TIMEOUT)
    fut = t2.do(lambda: adaptor.allocate(900))
    assert wait_state(adaptor, t2.ident, THREAD_BLOCKED)
    time.sleep(0.05)
    t1.do(lambda: adaptor.deallocate(900)).result(TIMEOUT)
    fut.result(TIMEOUT)
    assert adaptor.get_and_reset_block_time(2) > 0
    adaptor.task_done(1)
    adaptor.task_done(2)
    t1.done()
    t2.done()


def test_rmm_spark_facade():
    rmm_spark.set_event_handler(1000)
    try:
        rmm_spark.current_thread_is_dedicated_to_task(42)
        a = rmm_spark.get_adaptor()
        assert a.get_state_of(rmm_spark.current_thread_id()) == \
            THREAD_RUNNING
        a.allocate(100)
        a.deallocate(100)
        rmm_spark.task_done(42)
        with pytest.raises(RuntimeError):
            rmm_spark.set_event_handler(10)
    finally:
        rmm_spark.clear_event_handler()


def test_remove_task_metrics_prunes(adaptor):
    t = TaskThread(adaptor, task_id=9)
    adaptor.force_retry_oom(t.ident, 1)
    with pytest.raises(exc.GpuRetryOOM):
        t.do(lambda: adaptor.allocate(10)).result(TIMEOUT)
    adaptor.task_done(9)
    assert adaptor.get_and_reset_num_retry_throw(9) == 1
    adaptor.remove_task_metrics(9)
    if isinstance(adaptor, sra.SparkResourceAdaptor):
        assert 9 not in adaptor._checkpointed
    t.done()


def test_pool_blocked_breaks_producer_consumer_deadlock(adaptor):
    """A dedicated thread waiting on a pool thread (pool_blocked) plus its
    pool thread blocked on alloc must count as a deadlocked task."""
    t1 = TaskThread(adaptor, task_id=1)
    pool = TaskThread(adaptor)
    adaptor.pool_thread_working_on_tasks(False, pool.ident, [1])
    # pool thread holds most memory, then wants more -> blocks
    pool.do(lambda: adaptor.allocate(800)).result(TIMEOUT)
    fut = pool.do(lambda: adaptor.allocate(800))
    assert wait_state(adaptor, pool.ident, THREAD_BLOCKED)
    # dedicated thread reports it is waiting on the pool -> deadlock check
    # fires and rolls back the pool thread (the only BLOCKED thread retries
    # once via is_retry_alloc_before_bufn, then BUFNs)
    t1.do(lambda: adaptor.thread_waiting_on_pool(t1.ident)).result(TIMEOUT)
    with pytest.raises(exc.GpuRetryOOM):
        fut.result(TIMEOUT)
    t1.do(lambda: adaptor.thread_done_waiting_on_pool(t1.ident)).result(
        TIMEOUT)
    pool.do(lambda: adaptor.deallocate(800)).result(TIMEOUT)
    adaptor.task_done(1)
    t1.done()
    pool.done()


def test_cpu_alloc_bracket(adaptor):
    """Host-alloc hooks (RmmSpark.preCpuAlloc/postCpuAlloc* :790-854):
    success path, failure path returning retry, and dealloc — same
    surface on the python and native adaptors."""
    tid = threading.get_ident()
    adaptor.start_dedicated_task_thread(tid, 1)
    try:
        was_recursive = adaptor.cpu_prealloc(100, blocking=False)
        assert was_recursive is False
        adaptor.post_cpu_alloc_success(100, False, was_recursive)
        adaptor.cpu_deallocate(100)
        # failed non-recursive alloc: thread returns to RUNNING and may
        # retry (post_alloc_failed returns True); a RECURSIVE bracket
        # (alloc within alloc) must not retry
        r = adaptor.cpu_prealloc(50, blocking=False)
        assert r is False
        inner = adaptor.cpu_prealloc(10, blocking=False)
        assert inner is True                       # recursive
        assert adaptor.post_cpu_alloc_failed(False, False, inner) is False
        assert adaptor.post_cpu_alloc_failed(False, False, r) is True
        # forced retry-OOM injection applies to the CPU filter too
        adaptor.force_retry_oom(tid, 1, sra.CPU, 0)
        with pytest.raises(exc.CpuRetryOOM):
            adaptor.cpu_prealloc(10, blocking=False)
    finally:
        adaptor.remove_thread_association(tid, 1)
        adaptor.task_done(1)


def test_cpu_split_injection(adaptor):
    """CPU-filtered split injection surfaces as CpuSplitAndRetryOOM on
    both implementations (ERR_CPU_SPLIT_OOM in the C ABI)."""
    tid = threading.get_ident()
    adaptor.start_dedicated_task_thread(tid, 1)
    try:
        adaptor.force_split_and_retry_oom(tid, 1, sra.CPU, 0)
        with pytest.raises(exc.CpuSplitAndRetryOOM):
            adaptor.cpu_prealloc(10, blocking=False)
        # GPU-filtered injection must NOT hit a cpu alloc
        adaptor.force_retry_oom(tid, 1, sra.GPU, 0)
        r = adaptor.cpu_prealloc(5, blocking=False)
        adaptor.post_cpu_alloc_success(5, False, r)
        adaptor.cpu_deallocate(5)
    finally:
        adaptor.remove_thread_association(tid, 1)
        adaptor.task_done(1)


def test_cpu_bufn_throw_raises_cpu_typed(adaptor):
    """A CPU-blocked thread chosen by the deadlock breaker must raise
    the CPU-typed RetryOOM (block_until_ready BUFN_THROW path), not the
    GPU one — the parity this C ABI change exists to establish."""
    barrier = threading.Barrier(2, timeout=TIMEOUT)
    errs = {}

    def worker(task_id):
        tid = threading.get_ident()
        adaptor.start_dedicated_task_thread(tid, task_id)
        try:
            r = adaptor.cpu_prealloc(100, blocking=True)
            barrier.wait()   # both tasks fail their cpu alloc together
            adaptor.post_cpu_alloc_failed(True, True, r)  # -> BLOCKED
            adaptor.block_thread_until_ready(tid)
        except (exc.CpuRetryOOM, exc.GpuRetryOOM) as e:
            errs[task_id] = type(e).__name__
        finally:
            adaptor.remove_thread_association(tid, task_id)
            adaptor.task_done(task_id)

    ts = [threading.Thread(target=worker, args=(i,)) for i in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in ts)
    # with every task blocked on a CPU alloc, the breaker rolls back the
    # lowest-priority thread with a CPU-typed OOM
    assert list(errs.values()) == ["CpuRetryOOM"], errs


# ------------------------------------------------------- native kudo


def mk_flat_specs():
    return [D.values_spec("int64", [1, None, 3, 4, 5, None, 7]),
            D.strings_spec(["a", "bb", None, "", "ccc", "dd", "e"]),
            D.values_spec("float64", [1.0, 2.0, None, 4.0, 5.0, 6.0,
                                      7.0])]


def mk_nested_table():
    child = Column.from_pylist([1, 2, 3, 4, 5, 6], dtypes.INT32, "cpu")
    lst = Column.make_list(np.array([0, 2, 2, 5, 6]), child,
                           validity=np.array([1, 0, 1, 1]))
    st = Column.make_struct(4, [
        Column.from_pylist([10, None, 30, 40], dtypes.INT64, "cpu"),
        Column.from_strings(["x", "y", None, "zz"], "cpu"),
    ], validity=np.array([1, 1, 0, 1]))
    dec = Column.from_pylist([10**30, None, -5, 7],
                             dtypes.decimal128(-2), "cpu")
    return Table([lst, st, dec])


def spec_write(columns, off, n) -> bytes:
    buf = io.BytesIO()
    kudo.write_to_stream(columns, buf, off, n)
    return buf.getvalue()


def jax_spec_write(columns, off, n) -> bytes:
    from spark_rapids_tpu.shuffle import kudo as jkudo
    buf = io.BytesIO()
    jkudo.write_to_stream(columns, buf, off, n)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jax_kudo_native():
    """The JAX package's binding over the same library (its own
    wrapper loads native/libkudo_native.so, which only a manual
    native/build.sh makes): pointed at the port's build."""
    from spark_rapids_tpu.shuffle import kudo_native as jkn
    if not HAVE_GPP:
        pytest.skip("no g++ to build the native kudo engine")
    saved = (jkn._LIB_PATH, jkn._lib)
    jkn._LIB_PATH, jkn._lib = str(kudo_native.library_path()), None
    yield jkn
    jkn._LIB_PATH, jkn._lib = saved


SLICES = [(0, 7), (0, 3), (3, 2), (5, 2), (1, 5), (2, 0), (6, 1)]


@needs_gpp
@pytest.mark.parametrize("off,n", SLICES)
def test_kudo_write_bytes_identical_flat(off, n, jax_kudo_native):
    specs = mk_flat_specs()
    cols = D.port_table(specs).columns
    jcols = D.jax_table(specs).columns
    got = kudo_native.table_from_columns(cols).write(off, n)
    assert got == spec_write(cols, off, n) == jax_spec_write(jcols, off, n)
    assert got == jax_kudo_native.table_from_columns(jcols).write(off, n)


@needs_gpp
@pytest.mark.parametrize("off,n", [(0, 4), (0, 2), (2, 2), (1, 3),
                                   (3, 1), (0, 0)])
def test_kudo_write_bytes_identical_nested(off, n):
    t = mk_nested_table()
    nt = kudo_native.table_from_columns(t.columns)
    assert nt.write(off, n) == spec_write(t.columns, off, n)


@needs_gpp
@pytest.mark.parametrize("seed", range(3))
def test_kudo_write_bytes_identical_seeded(seed, jax_kudo_native):
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(1, 200))
    specs = (D.host_table(rng, rows, ["int64", "string", "int8",
                                      "decimal128", "float32", "bool8"],
                          null_every=2)
             + D.nested_specs(rng, rows))
    cols, jcols = D.port_table(specs).columns, D.jax_table(specs).columns
    nt = kudo_native.table_from_columns(cols)
    jnt = jax_kudo_native.table_from_columns(jcols)
    for _ in range(4):
        off = int(rng.integers(0, rows))
        cnt = int(rng.integers(0, rows - off + 1))
        want = spec_write(cols, off, cnt)
        assert nt.write(off, cnt) == want == jnt.write(off, cnt)
        assert want == jax_spec_write(jcols, off, cnt)


@needs_gpp
def test_kudo_row_count_only_golden():
    import ctypes
    lib = kudo_native._load()
    ln = ctypes.c_int64()
    buf = lib.kudo_write_row_count_only(42, ctypes.byref(ln))
    raw = ctypes.string_at(buf, ln.value)
    lib.kudo_buf_free(buf)
    pybuf = io.BytesIO()
    kudo.write_row_count_only(pybuf, 42)
    assert raw == pybuf.getvalue()


def merge_both(t, slices):
    """native merge vs the spec engine's over the same blocks."""
    nt = kudo_native.table_from_columns(t.columns)
    blob = b"".join(nt.write(o, c) for o, c in slices)
    fields = schema_of_table(t)
    got = kudo_native.merge_to_table(blob, fields, "cpu")
    spec = kudo.merge_to_table(kudo.read_tables(io.BytesIO(blob)), fields,
                               "cpu")
    return got, spec


@needs_gpp
@pytest.mark.parametrize("slices", [
    [(0, 7)], [(0, 3), (3, 2), (5, 2)], [(1, 5)], [(2, 0), (0, 7)],
])
def test_kudo_merge_matches_spec_flat(slices):
    got, spec = merge_both(D.port_table(mk_flat_specs()), slices)
    assert [c.to_pylist() for c in got.columns] == \
        [c.to_pylist() for c in spec.columns]
    assert all(c.device.type == "cpu" for c in got.columns)


@needs_gpp
@pytest.mark.parametrize("slices", [
    [(0, 4)], [(0, 2), (2, 2)], [(1, 3)], [(0, 1), (1, 1), (2, 2)],
])
def test_kudo_merge_matches_spec_nested(slices):
    got, spec = merge_both(mk_nested_table(), slices)
    assert [c.to_pylist() for c in got.columns] == \
        [c.to_pylist() for c in spec.columns]


@needs_gpp
def test_kudo_merge_rewrite_round_trips_bytes():
    t = mk_nested_table()
    nt = kudo_native.table_from_columns(t.columns)
    blob = nt.write(0, 2) + nt.write(2, 2)
    merged = kudo_native.merge_blob(blob, schema_of_table(t))
    assert merged.write(0, 4) == nt.write(0, 4)


@needs_gpp
def test_kudo_merge_bad_blob():
    t = D.port_table(mk_flat_specs())
    with pytest.raises(ValueError, match="magic"):
        kudo_native.merge_blob(b"XXXX" + b"\0" * 40, schema_of_table(t))


@needs_gpp
def test_kudo_concurrent_writes_correct():
    t = D.port_table(mk_flat_specs())
    nt = kudo_native.table_from_columns(t.columns)
    expected = {(o, c): nt.write(o, c) for o, c in SLICES}
    errors = []

    def worker():
        for _ in range(50):
            for (o, c), want in expected.items():
                if nt.write(o, c) != want:
                    errors.append((o, c))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors


def test_kudo_native_disabled_is_unavailable(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_DISABLE_NATIVE", "1")
    assert not kudo_native.available()
    assert not native.available()
    assert not native_adaptor.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        kudo_native.table_from_columns([])


@needs_gpp
def test_libraries_build_under_build_native():
    assert (kudo_native.available() and native.available()
            and native_adaptor.available())
    for path in (kudo_native.library_path(),
                 native.library_path("columnar_native",
                                     ("columnar_native.cpp",)),
                 native.library_path("sra_native",
                                     ("spark_resource_adaptor.cpp",),
                                     ("-pthread",))):
        assert path.parent == native.BUILD_DIR and path.exists(), path
        assert path.parent.parts[-2:] == ("build", "native")


# ------------------------------------------------ native string rank


@needs_gpp
@pytest.mark.parametrize("seed", range(3))
def test_rank_strings_matches_reference(seed):
    from spark_rapids_tpu.utils import native as jnative
    import torch
    rng = np.random.default_rng(seed)
    words = [rng.bytes(int(rng.integers(0, 12))) for _ in range(500)]
    chars = np.frombuffer(b"".join(words), np.uint8)
    offsets = np.zeros(501, np.int32)
    np.cumsum([len(w) for w in words], out=offsets[1:])
    got = native.rank_strings(chars, offsets)
    _, expected = np.unique(np.array(words, object), return_inverse=True)
    np.testing.assert_array_equal(got, expected)
    if jnative.available():
        np.testing.assert_array_equal(
            got, jnative.rank_strings(chars, offsets))
    np.testing.assert_array_equal(
        got, native.rank_strings(torch.from_numpy(chars.copy()),
                                 torch.from_numpy(offsets)))


# ------------------------------------------------ arms and platform


def test_arms_match_reference():
    from spark_rapids_tpu.utils import arms as jarms
    from spark_rapids_tpu_torch.utils import arms

    class Res:
        def __init__(self, log, fail=False):
            self.log, self.fail = log, fail

        def close(self):
            self.log.append(id(self))
            if self.fail:
                raise OSError("close failed")

    for mod in (arms, jarms):
        log = []
        r = Res(log)
        assert mod.close_if_exception(r, lambda x: 5) == 5 and log == []
        with pytest.raises(KeyError):
            mod.close_if_exception(r, lambda x: {}["k"])
        assert log == [id(r)]
        log.clear()
        rs = [Res(log, fail=True), None, Res(log)]
        with pytest.raises(OSError, match="close failed"):
            mod.close_all(rs)
        assert len(log) == 2
        log.clear()
        assert mod.with_resources([Res(log)], lambda rs: 3) == 3
        assert len(log) == 1
        with pytest.raises(ValueError, match="lazy"):
            mod.ensure(False, lambda: "lazy")
        mod.ensure(True, "unused")
        assert mod.ensure_non_negative(0, "n") == 0
        with pytest.raises(ValueError, match="n must be non-negative"):
            mod.ensure_non_negative(-1, "n")
        assert mod.Pair.of(1, "a") == (1, "a")
        assert mod.Pair(1, 2).right == 2


@pytest.mark.parametrize("system", [(0, 3, 2, 1), (0, 3, 5, 0),
                                    (1, 14, 3), (1, 13, 9), (2, 3, 2)])
def test_spark_system_matches_reference(system):
    from spark_rapids_tpu.utils import platform as jplat
    from spark_rapids_tpu_torch.utils import platform
    a, b = platform.SparkSystem(*system), jplat.SparkSystem(*system)
    for pred in ("is_vanilla_320", "is_databricks_14_3_or_later",
                 "is_vanilla"):
        assert getattr(a, pred)() == getattr(b, pred)()


def test_platform_entry_device_and_integrated(monkeypatch, tmp_path):
    from spark_rapids_tpu_torch.utils import platform
    assert platform.entry_device() == "cuda"
    monkeypatch.setattr(platform, "_ENTRY_DEVICE", ["cuda"])
    with pytest.raises(ValueError, match="entry device"):
        platform.set_entry_device("tpu")
    platform.set_entry_device("cpu")
    assert platform.is_integrated_gpu() is True
    path = tmp_path / "f.bin"
    path.write_bytes(b"0123456789")
    f = platform.RapidsFileIO().open_input_file(str(path))
    assert f.get_length() == 10
    with f.open() as s:
        s.seek(4)
        assert s.read(3) == b"456" and s.tell() == 7
