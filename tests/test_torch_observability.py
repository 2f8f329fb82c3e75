"""PyTorch port: the observability core (analysis/lockdep.py,
observability/dumpio.py, journal.py, registry.py, task_metrics.py,
tracing.py, the spine in observability/__init__.py, utils/telemetry.py
and the JNI door's metrics_*, tracing_* and telemetry_* entries), held
against the JAX package on the same calls.

The cases follow tests/test_metrics_registry.py,
tests/test_tracing_spans.py, tests/test_registry_telemetry.py and the
lockdep cases of tests/test_srt_check.py.  Where a case's output does
not depend on time or thread ids, the port's output equals the JAX
package's exactly (Prometheus text, JSON snapshots, journal records
without ``t_ns``/``thread``); span ids are random in both packages, so
span trees are compared by name, kind, parent name and attributes.
Telemetry runs with ``device="cpu"``: these tests run without a card.

Each package keeps its own METRICS, JOURNAL, TASKS and TRACER, and both
read the same env switches: the fixtures enable, reset and restore both
explicitly.
"""

import io
import json
import os
import stat
import subprocess
import sys
import threading
import time

import pytest

from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu.analysis import lockdep as jlockdep
from spark_rapids_tpu.memory import rmm_spark as jrmm
from spark_rapids_tpu.observability.journal import EventJournal as JJournal
from spark_rapids_tpu.observability.registry import \
    MetricsRegistry as JRegistry
from spark_rapids_tpu.observability.task_metrics import \
    TaskMetricsTable as JTasks
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch.analysis import lockdep
from spark_rapids_tpu_torch.memory import exceptions as exc
from spark_rapids_tpu_torch.memory import rmm_spark
from spark_rapids_tpu_torch.memory.thread_state_registry import REGISTRY
from spark_rapids_tpu_torch.observability import dumpio
from spark_rapids_tpu_torch.observability.journal import EventJournal
from spark_rapids_tpu_torch.observability.registry import MetricsRegistry
from spark_rapids_tpu_torch.observability.task_metrics import \
    TaskMetricsTable
from spark_rapids_tpu_torch.observability.tracing import (
    NOOP_SPAN, SpanContext, Tracer)
from spark_rapids_tpu_torch.utils import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _switches(mod):
    return mod.is_enabled(), mod.is_tracing_enabled()


def _restore(mod, prior):
    mod.reset()
    (mod.enable if prior[0] else mod.disable)()
    (mod.enable_tracing if prior[1] else mod.disable_tracing)()


@pytest.fixture
def obs_on():
    """Both packages' metrics and tracing on and clean, restored
    afterwards."""
    priors = [(m, _switches(m)) for m in (obs, jobs)]
    for m, _ in priors:
        m.enable()
        m.enable_tracing()
        m.reset()
    yield
    for m, p in priors:
        _restore(m, p)


@pytest.fixture
def obs_off():
    """Both packages' switches off and clean, restored afterwards."""
    priors = [(m, _switches(m)) for m in (obs, jobs)]
    for m, _ in priors:
        m.disable()
        m.disable_tracing()
        m.reset()
    yield
    for m, p in priors:
        _restore(m, p)


def strip_record(r):
    """A journal record without its time and thread stamps."""
    return {k: v for k, v in r.items()
            if k not in ("t_ns", "thread", "dur_ns")}


# ------------------------------------------------------------- registry


@pytest.mark.parametrize("Registry", [MetricsRegistry, JRegistry],
                         ids=["port", "jax"])
def test_counter_concurrent_threads_exact(Registry):
    reg = Registry(enabled=True)
    c = reg.counter("hits_total", "hits", labels=("kind",))
    n_threads, n_incs = 8, 5_000

    def worker(kind):
        for _ in range(n_incs):
            c.inc(labels=(kind,))

    threads = [threading.Thread(target=worker,
                                args=("even" if i % 2 else "odd",))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = reg.snapshot()["hits_total"]
    total = {tuple(s["labels"]): s["value"] for s in snap["series"]}
    assert total == {("even",): 4 * n_incs, ("odd",): 4 * n_incs}


def test_histogram_concurrent_threads_exact():
    reg = MetricsRegistry(enabled=True)
    h = reg.histogram("lat", "latency", buckets=(10, 100, 1000))
    per_thread = list(range(1, 1001))

    def worker():
        for v in per_thread:
            h.observe(v)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    s = reg.snapshot()["lat"]["series"][0]
    assert s["count"] == 8 * len(per_thread)
    assert s["sum"] == 8 * sum(per_thread)
    assert sum(s["bucket_counts"]) == s["count"]
    assert s["bucket_counts"][0] == 8 * 10


def _cardinality(Registry):
    reg = Registry(enabled=True)
    c = reg.counter("cap_total", "", labels=("op",), max_series=4)
    for i in range(10):
        c.inc(labels=(f"op{i}",))
    return reg, c


def test_label_cardinality_is_bounded():
    reg, c = _cardinality(MetricsRegistry)
    snap = reg.snapshot()["cap_total"]
    keys = {tuple(s["labels"]) for s in snap["series"]}
    assert len(keys) == 5 and ("__other__",) in keys
    other = next(s["value"] for s in snap["series"]
                 if s["labels"] == ["__other__"])
    assert other == 6 and c.dropped_series == 6
    assert reg.snapshot() == _cardinality(JRegistry)[0].snapshot()


def test_family_registration_idempotent_and_kind_checked():
    reg = MetricsRegistry(enabled=True)
    a = reg.counter("x_total", "")
    assert reg.counter("x_total", "") is a
    with pytest.raises(ValueError):
        reg.gauge("x_total", "")
    with pytest.raises(ValueError, match="label values"):
        reg.counter("y_total", "", labels=("a", "b")).inc(labels=("a",))


def test_disabled_registry_materializes_nothing():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("c_total", "", labels=("k",))
    h = reg.histogram("h", "")
    c.inc(labels=("a",))
    h.observe(5)
    assert reg.snapshot()["c_total"]["series"] == []
    assert reg.snapshot()["h"]["series"] == []


def _golden(Registry):
    reg = Registry(enabled=True)
    c = reg.counter("req_total", "requests", labels=("op",))
    c.inc(3, labels=("scan",))
    c.inc(labels=("join",))
    reg.gauge("mem_bytes", "bytes").set(1024)
    reg.gauge("ratio", "a float").set(0.25)
    h = reg.histogram("lat_ns", "latency", buckets=(10, 100))
    for v in (5, 50, 500):
        h.observe(v)
    return reg


def test_expose_text_golden():
    text = _golden(MetricsRegistry).expose_text()
    assert text == (
        "# HELP lat_ns latency\n"
        "# TYPE lat_ns histogram\n"
        'lat_ns_bucket{le="10"} 1\n'
        'lat_ns_bucket{le="100"} 2\n'
        'lat_ns_bucket{le="+Inf"} 3\n'
        "lat_ns_sum 555\n"
        "lat_ns_count 3\n"
        "# HELP mem_bytes bytes\n"
        "# TYPE mem_bytes gauge\n"
        "mem_bytes 1024\n"
        "# HELP ratio a float\n"
        "# TYPE ratio gauge\n"
        "ratio 0.25\n"
        "# HELP req_total requests\n"
        "# TYPE req_total counter\n"
        'req_total{op="join"} 1\n'
        'req_total{op="scan"} 3\n')
    assert text == _golden(JRegistry).expose_text()


def test_expose_text_escapes_label_values():
    texts = []
    for Registry in (MetricsRegistry, JRegistry):
        reg = Registry(enabled=True)
        reg.counter("esc_total", "", labels=("name",)).inc(
            labels=('a"b\\c\nd',))
        texts.append(reg.expose_text())
    assert 'esc_total{name="a\\"b\\\\c\\nd"} 1' in texts[0]
    assert texts[0] == texts[1]


def test_snapshot_json_golden():
    out = []
    for Registry in (MetricsRegistry, JRegistry):
        reg = Registry(enabled=True)
        reg.counter("n_total", "things", labels=("k",)).inc(
            2, labels=("v",))
        reg.histogram("h", "", buckets=(1, 2)).observe(2)
        out.append(reg.snapshot_json())
    assert json.loads(out[0])["n_total"] == {
        "kind": "counter", "help": "things", "labels": ["k"],
        "series": [{"labels": ["v"], "value": 2}]}
    assert out[0] == out[1]
    reg = MetricsRegistry(enabled=True)
    assert reg.family_snapshot("absent") is None


def test_registry_reset_keeps_families():
    reg = _golden(MetricsRegistry)
    c = reg.counter("req_total", "requests", labels=("op",))
    reg.reset()
    assert all(f["series"] == [] for f in reg.snapshot().values())
    c.inc(labels=("again",))
    assert 'req_total{op="again"} 1' in reg.expose_text()


# -------------------------------------------------------------- journal


def test_journal_ring_overflow_keeps_most_recent():
    recs = []
    for Journal in (EventJournal, JJournal):
        j = Journal(capacity=4)
        for i in range(10):
            j.emit("e", i=i)
        assert len(j) == 4 and j.total_emitted == 10 and j.dropped == 6
        recs.append([strip_record(r) for r in j.records()])
    assert [r["i"] for r in recs[0]] == [6, 7, 8, 9]
    assert [r["seq"] for r in recs[0]] == [7, 8, 9, 10]
    assert recs[0] == recs[1]


def test_journal_kind_filter_and_dump(tmp_path):
    j = EventJournal(capacity=16)
    j.emit("a", x=1)
    j.emit("b", x=2)
    j.emit("a", x=3)
    assert [r["x"] for r in j.records("a")] == [1, 3]
    assert j.counts_by_kind() == {"a": 2, "b": 1}
    buf = io.StringIO()
    assert j.dump_jsonl(buf) == 3
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [r["kind"] for r in lines] == ["a", "b", "a"]
    path = tmp_path / "j.jsonl"
    assert j.dump_jsonl(str(path)) == 3
    assert [json.loads(x)["x"] for x in path.read_text().splitlines()] \
        == [1, 2, 3]
    j.clear()
    assert len(j) == 0 and j.total_emitted == 0


def test_journal_respects_shared_switch():
    class Ref:
        enabled = False

    j = EventJournal(capacity=4, enabled_ref=Ref())
    j.emit("e")
    assert len(j) == 0 and j.total_emitted == 0


def test_journal_on_drop_hook_unit():
    drops = []
    j = EventJournal(capacity=4, on_drop=lambda n: drops.append(n))
    for i in range(10):
        j.emit("e", i=i)
    assert sum(drops) == 6 == j.dropped


def test_journal_overflow_counts_dropped_total(obs_on):
    overflow = 25
    for i in range(obs.JOURNAL.capacity + overflow):
        obs.JOURNAL.emit("filler", i=i)
    assert obs.JOURNAL.dropped == overflow
    assert f"srt_journal_dropped_total {overflow}" in obs.expose_text()


# --------------------------------------------------------- task metrics


def _task_table(Tasks):
    t = Tasks()
    t.bind_thread(100, (1,))          # dedicated task thread
    t.bind_thread(200, (1, 2))        # pool thread shared by two tasks
    t.note_op("scan", 1000, thread_id=100)
    t.note_op("shuffle", 500, thread_id=200)
    t.note_shuffle_write(4096, 50, thread_id=200)
    t.note_shuffle_merge(10, 7, thread_id=100)
    t.note_event(thread_id=100)
    t.note_op("orphan", 7, thread_id=999)   # unbound -> task -1
    t.fold_rmm_task(1, retry_oom=2, split_retry_oom=1,
                    blocked_time_ns=5, lost_time_ns=6,
                    max_device_memory=64)
    return t


def test_task_table_rollup_dedicated_and_pool_bindings():
    t = _task_table(TaskMetricsTable)
    roll = t.rollup()
    assert roll[1]["ops"]["scan"]["calls"] == 1
    assert roll[1]["ops"]["shuffle"]["time_ns"] == 500
    assert roll[2]["ops"]["shuffle"]["calls"] == 1
    assert roll[1]["shuffle_write_bytes"] == 4096
    assert roll[2]["shuffle_write_bytes"] == 4096
    assert roll[-1]["ops"]["orphan"]["calls"] == 1
    assert roll == _task_table(JTasks).rollup()
    assert t.bound_threads() == {100: [1], 200: [1, 2]}
    assert t.tasks_for(200) == [1, 2] and t.tasks_for(5) == [-1]
    t.unbind_thread(200, (2,))
    t.note_op("late", 1, thread_id=200)
    roll = t.rollup()
    assert "late" in roll[1]["ops"] and "late" not in roll[2]["ops"]
    t.unbind_thread(100)
    assert t.bound_threads() == {200: [1]}


def _rmm_rollup(o, rmm, ex):
    """Dedicated + pool threads bound through the RmmSpark facade roll
    up into one per-task row, the OOM machine's counters folded in at
    task_done."""
    adaptor = rmm.set_event_handler(1 << 20)
    try:
        def dedicated():
            tid = threading.get_ident()
            rmm.start_dedicated_task_thread(tid, 7)
            o.record_op("scan", 1_000_000)
            rmm.force_retry_oom(tid, 1)
            try:
                adaptor.allocate(64)
            except ex.GpuRetryOOM:
                pass
            adaptor.allocate(64)
            adaptor.deallocate(64)
            rmm.task_done(7)

        def pool():
            tid = threading.get_ident()
            rmm.pool_thread_working_on_tasks(False, tid, [7, 8])
            o.record_op("shuffle_read", 500_000)
            rmm.pool_thread_finished_for_tasks(tid, [7, 8])

        for target in (dedicated, pool):
            th = threading.Thread(target=target)
            th.start()
            th.join(10)
            assert not th.is_alive()
    finally:
        rmm.clear_event_handler()
    tasks = o.snapshot()["tasks"]
    for row in tasks.values():
        for op in row["ops"].values():
            op.pop("time_ns")
        row.pop("lost_time_ns")
        row.pop("blocked_time_ns")
    return tasks, o.JOURNAL.counts_by_kind()


def test_rmm_spark_rollup_across_threads(obs_on):
    from spark_rapids_tpu.memory import exceptions as jexc
    tasks, kinds = _rmm_rollup(obs, rmm_spark, exc)
    assert tasks["7"]["retry_oom"] == 1
    assert tasks["7"]["max_device_memory"] == 64
    assert tasks["7"]["ops"]["scan"]["calls"] == 1
    assert tasks["7"]["ops"]["shuffle_read"]["calls"] == 1
    assert tasks["8"]["ops"]["shuffle_read"]["calls"] == 1
    assert "scan" not in tasks["8"]["ops"]
    assert kinds.get("oom_retry", 0) == 1
    assert kinds.get("task_done", 0) == 1
    assert 'srt_oom_retry_total{device="device"} 1' in obs.expose_text()
    assert (tasks, kinds) == _rmm_rollup(jobs, jrmm, jexc)


def test_task_done_keeps_counters_while_off(obs_off):
    """With observability off the per-task counters stay in the adaptor
    for the caller (nothing folds them), in both packages."""
    from spark_rapids_tpu.memory import exceptions as jexc
    got = []
    for rmm, ex in ((rmm_spark, exc), (jrmm, jexc)):
        adaptor = rmm.set_event_handler(1 << 20)
        try:
            def body():
                tid = threading.get_ident()
                rmm.start_dedicated_task_thread(tid, 3)
                rmm.force_retry_oom(tid, 1)
                try:
                    adaptor.allocate(8)
                except ex.GpuRetryOOM:
                    pass
                rmm.task_done(3)

            th = threading.Thread(target=body)
            th.start()
            th.join(10)
            got.append(adaptor.get_and_reset_num_retry_throw(3))
        finally:
            rmm.clear_event_handler()
    assert got == [1, 1]
    assert obs.TASKS.rollup() == {}


def test_registry_remove_thread_callback_unbinds_task_table():
    rmm_spark.set_event_handler(1 << 20)
    try:
        rmm_spark.start_dedicated_task_thread(4242, 7)
        assert 4242 in REGISTRY.known_threads()
        assert obs.TASKS.tasks_for(4242) == [7]
        # ending the task triggers the adaptor's remove-association
        # path, which calls back into the registry AND the task table
        rmm_spark.task_done(7)
        assert 4242 not in REGISTRY.known_threads()
        assert obs.TASKS.tasks_for(4242) == [-1]
        rmm_spark.start_dedicated_task_thread(777, 1)
        assert REGISTRY.blocked_thread_ids(rmm_spark.get_adaptor()) == []
        rmm_spark.task_done(1)
    finally:
        rmm_spark.clear_event_handler()


# ---------------------------------------------------- disabled fast path


def test_disabled_fast_path_no_growth(obs_off):
    """With observability off the record helpers leave no trace: no
    journal records, no registry series, no task rows, no spans."""
    before = obs.METRICS.snapshot()
    obs.record_op("x", 10)
    obs.record_shuffle_write(100, 5, 2)
    obs.record_shuffle_merge(10, 1, 2, 3)
    obs.record_oom_event("oom_retry", thread_id=1, task_id=2)
    obs.record_oom_event("thread_blocked", thread_id=1, task_id=2)
    obs.record_oom_event("thread_unblocked", thread_id=1, task_id=2)
    obs.record_exchange_doubling(1, 2, 0)
    obs.record_device_memory(123)
    obs.record_hbm_sample(0, 456)
    obs.record_spill(stage="s", tier="host", nbytes=1, ns=1)
    obs.record_kernel_path("join.inner", "host_rank", 3)
    with obs.TRACER.span("nothing") as s:
        assert s is NOOP_SPAN
    assert len(obs.JOURNAL) == 0 and obs.JOURNAL.total_emitted == 0
    assert obs.TASKS.rollup() == {}
    assert obs.METRICS.snapshot() == before
    assert len(obs.TRACER) == 0


def test_env_switches_enable_at_import():
    """SPARK_RAPIDS_TPU_METRICS / _TRACE, read at import, under the JAX
    package's names; the port imports no JAX."""
    code = ("import sys, spark_rapids_tpu_torch.observability as o; "
            "assert 'jax' not in sys.modules; "
            "print(o.is_enabled(), o.is_tracing_enabled())")
    out = []
    for metrics, trace in (("1", "1"), ("0", ""), ("", "1")):
        env = dict(os.environ, SPARK_RAPIDS_TPU_METRICS=metrics,
                   SPARK_RAPIDS_TPU_TRACE=trace, PYTHONPATH=REPO)
        out.append(subprocess.run(
            [sys.executable, "-c", code], env=env, cwd=REPO,
            capture_output=True, text=True, check=True).stdout.split())
    assert out == [["True", "True"], ["False", "False"],
                   ["False", "True"]]


# ----------------------------------------------------- spine parity


def drive_every_record(o):
    """One call of every record_* helper the port carries, with fixed
    arguments: the same sequence goes through both packages."""
    o.record_op("scan", 2_000_000)
    o.record_shuffle_write(8192, 100, 16)
    o.record_shuffle_merge(16, 10, 20, 2)
    o.record_shuffle_link("send", 1, 300, 101)
    o.record_shuffle_link("recv", "0", 200, 101)
    o.record_shuffle_link_retry(1, "nak")
    o.record_shuffle_wire(101, 7000)
    o.record_shuffle_wait(101, 900, 50)
    o.set_fleet_epoch(2)
    o.record_fleet_membership("death", dead=[2], epoch=3, live=[0, 1],
                              moved={2: 0})
    o.record_fleet_membership("join", dead=[], epoch=4, live=[0, 1, 2],
                              joined=2)
    o.record_fleet_speculation(5, 1, 2, 0, "won", {"reason": "x"})
    o.record_fleet_resplit(5, 1, 3, 4096, {"ratio": 5.0})
    o.record_fleet_stale_nak(2, 1, 3)
    o.record_shuffle_dup_dropped(1, 5, 1, True)
    o.record_shuffle_dup_dropped(1, 5, 2, None)
    o.record_oom_event("oom_retry", thread_id=11, task_id=1)
    o.record_oom_event("oom_split_retry", thread_id=11, task_id=1,
                       is_cpu=True, injected=True)
    o.record_oom_event("thread_blocked", thread_id=11, task_id=1)
    o.record_oom_event("thread_unblocked", thread_id=11, task_id=1,
                       blocked_ns=1234)
    o.record_retry_episode("section", attempts=3, retries=1, splits=1,
                           max_split_depth=1, lost_ns=55,
                           outcome="success",
                           errors=["GpuRetryOOM", "GpuSplitAndRetryOOM"])
    o.record_kudo_corruption("crc", detail="want 1 got 2")
    o.record_kudo_corruption("resync", skipped_bytes=40, detail="magic")
    o.record_spill(stage="q5", tier="host", nbytes=1000, ns=10, task=1,
                   name="b", generation=1)
    o.record_spill(stage="", tier="disk", nbytes=900, ns=20)
    o.record_spill_restore(stage="q5", tier="disk", nbytes=1000, ns=30)
    o.record_spill_wait(40, stage="ensure_headroom")
    o.record_spill_wait(0)
    o.record_spill_corrupt("recomputed", path="/x", generation=2)
    o.record_jit_cache("hit", "k")
    o.record_jit_cache("miss", "k", compile_ns=5_000_000)
    o.record_jit_cache("eviction", "k")
    o.record_result_cache("hit", "result", tenant="t")
    o.record_result_cache("put", "stage", nbytes=77)
    o.record_result_cache("fold", "result", query="q5")
    o.record_kernel_path("join.inner", "host_hash", 100)
    o.record_stage_fusion("q5_partials", "fused", digest="d", wall_ns=9,
                          nodes=4, compiled=True)
    o.record_lockdep("cycle", cycle=["a", "b", "a"])
    o.record_lockdep("blocking", op="transport.send", held=["a"])
    o.record_exchange_doubling(64, 128, 0)
    o.record_device_memory(4096)
    o.record_hbm_sample(0, 1 << 30)
    o.record_task_leak(1, 512, [{"thread": 1}])
    o.record_io_read("/data/f.parquet", 1024, 5000)
    o.record_io_file("/data/f.parquet", columns=2, pages=3, rows=100,
                     read_bytes=1024, decode_ns=777)
    o.TASKS.fold_rmm_task(3, retry_oom=2, blocked_time_ns=5_000)


# the exposition lines whose values are times measured at run time in
# either package, by metric name: drive_every_record passes fixed
# values only and tracing is off, so no line is excepted
TIME_VALUED_LINES = ()


def untimed(text):
    return [ln for ln in text.splitlines()
            if ln.split("{")[0].split(" ")[0] not in TIME_VALUED_LINES]


def test_same_records_give_identical_exposition(obs_on):
    for o in (obs, jobs):
        o.disable_tracing()
        drive_every_record(o)
    assert untimed(obs.expose_text()) == untimed(jobs.expose_text())
    # every family of the reference is registered in the port, with
    # the same help string, labels and buckets
    assert obs.METRICS.snapshot() == jobs.METRICS.snapshot()
    assert [strip_record(r) for r in obs.JOURNAL.records()] == \
        [strip_record(r) for r in jobs.JOURNAL.records()]
    assert obs.TASKS.rollup() == jobs.TASKS.rollup()


def test_snapshot_and_dumps_match_reference(obs_on, tmp_path):
    for o in (obs, jobs):
        o.disable_tracing()
        drive_every_record(o)
    snaps = [o.snapshot() for o in (obs, jobs)]
    for s in snaps:
        assert s.pop("snapshot_unix_ms") > 0 and s.pop("uptime_s") >= 0
    assert snaps[0] == snaps[1]
    dumps = []
    for name, o in (("port", obs), ("jax", jobs)):
        path = tmp_path / f"{name}.jsonl"
        n = o.dump_journal_jsonl(str(path))
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        assert n == len(recs) == len(o.JOURNAL) + len(o.TASKS.rollup()) + 1
        dumps.append([strip_record(r) for r in recs])
    assert dumps[0] == dumps[1]
    assert dumps[0][-1]["kind"] == "registry_snapshot"
    assert not list(tmp_path.glob("*.tmp"))


def test_monitor_age_gauge_is_time_valued(obs_on):
    """srt_monitor_last_sample_age_s is computed at exposition from the
    last Monitor sample: present and non-negative, never compared."""
    assert not [ln for ln in obs.expose_text().splitlines()
                if ln.startswith("srt_monitor_last_sample_age_s ")]
    obs.record_monitor_sample(time.monotonic() - 2.0)
    line = [ln for ln in obs.expose_text().splitlines()
            if ln.startswith("srt_monitor_last_sample_age_s ")]
    assert len(line) == 1 and float(line[0].split()[1]) >= 2.0


def test_hbm_sample_feeds_gauge(obs_on):
    obs.record_hbm_sample(0, 1 << 30)
    obs.record_hbm_sample(1, 2 << 30)
    text = obs.expose_text()
    assert 'srt_hbm_bytes_in_use{device="0"} 1073741824' in text
    assert 'srt_hbm_bytes_in_use{device="1"} 2147483648' in text


def test_shim_metrics_entries(obs_on, tmp_path):
    from spark_rapids_tpu_torch.shim import jni_entry
    obs.record_op("shim_op", 42)
    assert jni_entry.metrics_enabled()
    assert 'op="shim_op"' in jni_entry.metrics_expose_text()
    snap = json.loads(jni_entry.metrics_snapshot_json())
    assert "registry" in snap and "journal" in snap
    path = tmp_path / "journal.jsonl"
    assert jni_entry.metrics_journal_dump(str(path)) >= 2
    prior = jni_entry.metrics_set_enabled(False)
    assert prior is True and not obs.is_enabled()
    jni_entry.metrics_set_enabled(True)
    jni_entry.metrics_reset()
    assert len(obs.JOURNAL) == 0


def test_shim_tracing_entries(obs_on, tmp_path):
    from spark_rapids_tpu_torch.shim import jni_entry
    assert jni_entry.tracing_enabled()
    with obs.TRACER.span("one"):
        pass
    assert jni_entry.tracing_dump(str(tmp_path / "d.jsonl")) == 1
    assert jni_entry.tracing_flush(str(tmp_path / "f.jsonl")) == 1
    assert len(obs.TRACER) == 0
    with obs.TRACER.span("two"):
        pass
    jni_entry.tracing_reset()
    assert len(obs.TRACER) == 0
    assert jni_entry.tracing_set_enabled(False) is True
    assert not obs.is_tracing_enabled()


def test_tracing_flush_failure_requeues_spans(obs_on, tmp_path):
    from spark_rapids_tpu_torch.shim import jni_api
    with obs.TRACER.span("precious"):
        pass
    with pytest.raises(OSError):
        jni_api.tracing_flush(str(tmp_path / "no" / "such" / "d.jsonl"))
    ok = tmp_path / "spans.jsonl"
    assert jni_api.tracing_flush(str(ok)) == 1
    assert json.loads(ok.read_text())["name"] == "precious"
    assert len(obs.TRACER) == 0


# ------------------------------------------------------------- tracing


def test_span_nesting_parents_and_trace_identity():
    tr = Tracer()
    tr.enabled = True
    with tr.span("root", kind="query") as root:
        with tr.span("mid", kind="stage") as mid:
            with tr.span("leaf") as leaf:
                assert leaf.trace_id == root.trace_id
                assert leaf.parent_id == mid.span_id
            assert mid.parent_id == root.span_id
        assert root.parent_id == 0
    recs = tr.records()
    assert [r["name"] for r in recs] == ["leaf", "mid", "root"]
    assert recs[2]["parent_id"] is None
    assert len({r["trace_id"] for r in recs}) == 1
    with tr.span("other_root"):
        pass
    assert tr.records()[-1]["trace_id"] != recs[0]["trace_id"]
    assert tr.current_context() is None


def test_span_disabled_is_noop_singleton():
    tr = Tracer()
    span = tr.start_span("x")
    assert span is NOOP_SPAN and span.context is None
    span.set_attr("a", 1).add_link(SpanContext(1, 2)).end()
    with tr.span("y"):
        pass
    assert tr.activate(SpanContext(1, 2)) is NOOP_SPAN
    assert len(tr) == 0 and tr.depth() == 0


def test_span_thread_local_context_isolated():
    tr = Tracer()
    tr.enabled = True
    out = {}

    def worker():
        with tr.span("worker_root") as s:
            out["trace"] = s.trace_id
            out["parent"] = s.parent_id

    with tr.span("main_root") as main_span:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert out["parent"] == 0
        assert out["trace"] != main_span.trace_id


def test_span_remote_context_activation():
    tr = Tracer()
    tr.enabled = True
    with tr.span("writer") as w:
        ctx = w.context
    done = {}

    def worker():
        with tr.activate(ctx):
            with tr.span("adopted") as s:
                done["trace"] = s.trace_id
                done["parent"] = s.parent_id

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert done == {"trace": ctx.trace_id, "parent": ctx.span_id}
    assert [r["name"] for r in tr.records()] == ["writer", "adopted"]


def test_span_out_of_order_end_tolerated():
    tr = Tracer()
    tr.enabled = True
    a = tr.start_span("a")
    b = tr.start_span("b")
    a.end()
    b.end()
    b.end()
    assert tr.depth() == 0
    assert {r["name"] for r in tr.records()} == {"a", "b"}


def test_span_cross_thread_end_pops_origin_stack():
    tr = Tracer()
    tr.enabled = True
    handed = tr.start_span("handed_off")
    t = threading.Thread(target=handed.end)
    t.start()
    t.join()
    assert tr.depth() == 0
    with tr.span("after") as s:
        assert s.parent_id == 0
        assert s.trace_id != handed.trace_id


def test_span_bounded_attributes():
    tr = Tracer()
    tr.enabled = True
    with tr.span("big", attrs={f"k{i}": i for i in range(40)}):
        pass
    assert tr.records()[0]["attrs"]["__attrs_dropped__"] == 40 - 16
    with tr.span("long", attrs={"v": "x" * 1000, "o": object}):
        pass
    attrs = tr.records()[-1]["attrs"]
    assert len(attrs["v"]) < 300 and isinstance(attrs["o"], str)


def test_set_attr_at_cap_evicts_oldest_not_newest():
    tr = Tracer()
    tr.enabled = True
    try:
        with tr.span("full", attrs={f"k{i}": i for i in range(16)}):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    attrs = tr.records()[0]["attrs"]
    assert attrs["error"] == "RuntimeError"
    assert "k0" not in attrs
    assert attrs["__attrs_dropped__"] == 1


def test_span_ring_drain_requeue_and_drop_count():
    tr = Tracer(capacity=3)
    tr.enabled = True
    for i in range(5):
        tr.start_span(f"s{i}").end()
    assert len(tr) == 3 and tr.dropped == 2
    drained = tr.drain()
    assert [r["name"] for r in drained] == ["s2", "s3", "s4"]
    tr.start_span("new").end()
    tr.requeue(drained)
    assert [r["name"] for r in tr.records()] == ["s3", "s4", "new"]
    assert tr.dropped == 3
    buf = io.StringIO()
    assert tr.dump_jsonl(buf) == 3


def test_span_ids_come_from_the_system_rng():
    import random

    from spark_rapids_tpu_torch.observability import tracing as T
    assert isinstance(T._ID_RNG, random.SystemRandom)
    random.seed(0)
    a = T._new_id()
    random.seed(0)
    assert T._new_id() != a and a != 0


def test_span_task_attribution_via_rmm_bindings(obs_on):
    tid = threading.get_ident()
    obs.TASKS.bind_thread(tid, (42,))
    obs.TASKS.bind_thread(tid + 1, (1, 2))
    try:
        with obs.TRACER.span("attributed"):
            pass
    finally:
        obs.TASKS.unbind_thread(tid)
        obs.TASKS.unbind_thread(tid + 1)
    rec = [r for r in obs.TRACER.records() if r["name"] == "attributed"]
    assert rec[0]["task"] == 42


def test_span_feeds_histogram_and_journal(obs_on):
    with obs.TRACER.span("fed", kind="stage"):
        pass
    text = obs.expose_text()
    assert 'srt_span_duration_ns_bucket' in text
    assert 'span_kind="stage",name="fed"' in text
    assert 'srt_spans_finished_total{span_kind="stage"} 1' in text
    assert "fed" in [r["name"] for r in obs.JOURNAL.records("span")]
    path = io.StringIO()
    assert obs.dump_spans_jsonl(path) == 1


def test_oom_block_episode_becomes_one_span(obs_on):
    obs.record_oom_event("thread_blocked", thread_id=777, task_id=3)
    assert not [r for r in obs.TRACER.records()
                if r["name"] == "oom_blocked"]
    obs.record_oom_event("thread_unblocked", thread_id=777, task_id=3,
                         blocked_ns=5)
    recs = [r for r in obs.TRACER.records() if r["name"] == "oom_blocked"]
    assert len(recs) == 1
    assert recs[0]["span_kind"] == "oom"
    assert recs[0]["attrs"]["task_id"] == 3


def test_oom_block_span_closes_with_tracing_turned_off(obs_on):
    obs.record_oom_event("thread_blocked", thread_id=778, task_id=4)
    obs.disable_tracing()
    obs.record_oom_event("thread_removed", thread_id=778, task_id=4)
    assert [r["name"] for r in obs.TRACER.records()] == ["oom_blocked"]
    assert obs._BLOCK_SPANS == {}


def test_oom_retry_instant_span(obs_on):
    obs.record_oom_event("oom_retry", thread_id=1, task_id=9,
                         injected=True)
    recs = [r for r in obs.TRACER.records() if r["name"] == "oom_retry"]
    assert len(recs) == 1 and recs[0]["attrs"]["injected"] is True


# ------------------------------------------------ kudo trace extension


def _int32_col(values):
    from spark_rapids_tpu_torch.columns import dtypes
    from spark_rapids_tpu_torch.columns.column import Column
    return Column.from_pylist(values, dtypes.INT32, device="cpu")


def test_kudo_stream_bytes_unchanged_when_tracing_off(obs_off):
    from spark_rapids_tpu_torch.shuffle import kudo
    buf = io.BytesIO()
    n = kudo.write_to_stream([_int32_col([1, 2, 3, 4])], buf, 0, 4)
    assert kudo.TRACE_MAGIC not in buf.getvalue()
    assert n == len(buf.getvalue())


def test_kudo_trace_context_round_trip(obs_on):
    from spark_rapids_tpu_torch.columns import dtypes
    from spark_rapids_tpu_torch.shuffle import kudo
    from spark_rapids_tpu_torch.shuffle.schema import Field

    buf = io.BytesIO()
    with obs.TRACER.span("write_stage", kind="stage") as wsp:
        n = kudo.write_to_stream_with_metrics(
            [_int32_col([1, 2, 3, 4])], buf, 0, 4)
        writer_trace, writer_span = wsp.trace_id, wsp.span_id
    raw = buf.getvalue()
    assert raw.startswith(kudo.TRACE_MAGIC)
    assert n.written_bytes == len(raw)
    kt = kudo.read_one_table(io.BytesIO(raw))
    trace_id, span_id = kt.header.trace_ctx
    assert trace_id == writer_trace
    write_rec = [r for r in obs.TRACER.records()
                 if r["name"] == "kudo_write"][0]
    assert write_rec["span_id"] == f"{span_id:016x}"
    assert write_rec["parent_id"] == f"{writer_span:016x}"
    assert write_rec["attrs"] == {"rows": 4, "bytes": len(raw)}

    merged = {}

    def remote_merge():
        table, _m = kudo.merge_to_table_with_metrics(
            [kt], [Field(dtypes.INT32)], device="cpu")
        merged["rows"] = table.num_rows

    t = threading.Thread(target=remote_merge)
    t.start()
    t.join()
    assert merged["rows"] == 4
    merge_rec = [r for r in obs.TRACER.records()
                 if r["name"] == "kudo_merge"][0]
    assert merge_rec["trace_id"] == f"{writer_trace:016x}"
    assert merge_rec["parent_id"] == f"{span_id:016x}"
    assert merge_rec["links"][0]["span_id"] == f"{span_id:016x}"
    text = obs.expose_text()
    assert f"srt_shuffle_write_bytes_total {len(raw)}" in text
    assert "srt_shuffle_merge_rows_total 4" in text


def test_kudo_local_merge_keeps_local_parent_but_links(obs_on):
    from spark_rapids_tpu_torch.columns import dtypes
    from spark_rapids_tpu_torch.shuffle import kudo
    from spark_rapids_tpu_torch.shuffle.schema import Field

    buf = io.BytesIO()
    with obs.TRACER.span("writer_q", kind="query"):
        kudo.write_to_stream_with_metrics([_int32_col([5, 6])], buf, 0, 2)
    kt = kudo.read_one_table(io.BytesIO(buf.getvalue()))
    with obs.TRACER.span("reader_q", kind="query") as rq:
        kudo.merge_to_table([kt], [Field(dtypes.INT32)], device="cpu")
        reader_trace = rq.trace_id
    merge_rec = [r for r in obs.TRACER.records()
                 if r["name"] == "kudo_merge"][0]
    assert merge_rec["trace_id"] == f"{reader_trace:016x}"
    assert merge_rec["links"]


def test_kudo_row_count_only_carries_context(obs_on):
    from spark_rapids_tpu_torch.shuffle import kudo
    buf = io.BytesIO()
    with obs.TRACER.span("rows_only", kind="stage"):
        n = kudo.write_row_count_only(buf, 7)
    assert n == len(buf.getvalue())
    h = kudo.KudoTableHeader.read(io.BytesIO(buf.getvalue()))
    assert h.num_rows == 7 and h.trace_ctx is not None


# -------------------------------------------------------------- lockdep


@pytest.fixture
def fresh_lockdep(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_LOCKDEP", "1")
    lockdep.reset()
    yield
    lockdep.reset()


def _abba(mod, a_name, b_name):
    a = mod.make_lock(a_name)
    b = mod.make_lock(b_name)
    e1, e2 = threading.Event(), threading.Event()

    def t1():
        with a:
            e1.set()
            e2.wait(2)
            if b.acquire(timeout=0.2):
                b.release()

    def t2():
        e1.wait(2)
        with b:
            e2.set()
            if a.acquire(timeout=0.2):
                a.release()

    th1, th2 = threading.Thread(target=t1), threading.Thread(target=t2)
    th1.start()
    th2.start()
    th1.join(5)
    th2.join(5)
    return mod.report()


def test_lockdep_off_by_default_returns_plain_lock(monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_TPU_LOCKDEP", raising=False)
    assert type(lockdep.make_lock("test.plain")) is type(threading.Lock())
    assert type(lockdep.make_rlock("test.rplain")) is \
        type(threading.RLock())
    assert not lockdep.enabled()


def test_lockdep_abba_cycle_detected(fresh_lockdep):
    rep = _abba(lockdep, "t.A", "t.B")
    cycles = [c["cycle"] for c in rep["cycles"]]
    assert any("t.A" in c and "t.B" in c for c in cycles)
    assert rep["cycles"][0]["forward"]["stack"]
    assert {"t.A", "t.B"} <= set(rep["classes"])
    jlockdep.reset()
    try:
        ref = _abba(jlockdep, "t.A", "t.B")
    finally:
        jlockdep.reset()
    assert [c["cycle"] for c in rep["cycles"]] == \
        [c["cycle"] for c in ref["cycles"]]
    assert rep["edges"] == ref["edges"]


def test_lockdep_consistent_order_no_cycle(fresh_lockdep):
    a = lockdep.make_lock("o.A")
    b = lockdep.make_lock("o.B")
    for _ in range(3):
        with a:
            with b:
                pass
    rep = lockdep.report()
    assert rep["cycles"] == []
    assert {"from": "o.A", "to": "o.B", "count": 3} in rep["edges"]
    assert rep["enabled"] and rep["installed"]


def test_lockdep_rlock_reentrant_no_self_edge(fresh_lockdep):
    r = lockdep.make_rlock("t.R")
    with r:
        with r:
            assert not r.locked()      # self-held probes as unlocked
    rep = lockdep.report()
    assert rep["cycles"] == []
    assert all(e["from"] != "t.R" or e["to"] != "t.R"
               for e in rep["edges"])


def test_lockdep_same_class_nesting_is_a_cycle(fresh_lockdep):
    a1 = lockdep.make_lock("n.X")
    a2 = lockdep.make_lock("n.X")
    with a1:
        with a2:
            pass
    assert [c["cycle"] for c in lockdep.report()["cycles"]] == \
        [["n.X", "n.X"]]


def test_lockdep_held_across_blocking(fresh_lockdep):
    lk = lockdep.make_lock("t.IO")
    lockdep.note_blocking("unit.noheld")
    with lk:
        lockdep.note_blocking("unit.op")
    rep = lockdep.report()
    assert rep["blocking_total"] == 1
    ev = rep["blocking"][0]
    assert ev["op"] == "unit.op" and ev["held"] == ["t.IO"]
    assert ev["stack"]


def test_lockdep_condition_over_instrumented_lock(fresh_lockdep):
    lk = lockdep.make_lock("t.CV")
    cv = threading.Condition(lk)
    hits = []

    def waiter():
        with cv:
            cv.wait(timeout=2)
            hits.append(lockdep.held_classes())

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    with cv:
        cv.notify()
    th.join(5)
    assert hits and hits[0] == ["t.CV"]
    assert lockdep.held_classes() == []


def test_lockdep_cycle_evidence_reaches_metrics_and_journal(
        fresh_lockdep, obs_on):
    _abba(lockdep, "ev.A", "ev.B")
    series = obs.METRICS.snapshot()["srt_lockdep_cycles_total"]["series"]
    assert series and series[0]["value"] >= 1
    recs = [r for r in obs.JOURNAL.records() if r.get("kind") == "lockdep"]
    assert recs and recs[0]["event"] == "cycle" and "ev.A" in recs[0]["cycle"]
    lk = lockdep.make_lock("ev.IO")
    with lk:
        lockdep.note_blocking("unit.io")
    assert 'srt_lockdep_blocking_total{op="unit.io"} 1' in obs.expose_text()


def test_port_locks_take_their_lockdep_classes(fresh_lockdep):
    """The port's lock sites that the JAX package instruments take the
    same lockdep classes when SPARK_RAPIDS_TPU_LOCKDEP=1 is set at
    creation."""
    from spark_rapids_tpu_torch.distributed import transport
    from spark_rapids_tpu_torch.shim.handles import HandleRegistry
    reg = MetricsRegistry(enabled=True)
    reg.counter("c_total", "").inc()
    h = HandleRegistry()
    h.release(h.register(object()))
    transport.Inbox()
    classes = lockdep.report()["classes"]
    for name in ("metrics.series", "metrics.family", "metrics.registry",
                 "shim.handles", "dist.inbox"):
        assert name in classes, name


# --------------------------------------------------------------- dumpio


def test_atomic_write_replaces_whole_file_with_umask_mode(tmp_path):
    path = tmp_path / "out.jsonl"
    path.write_text("old\n")
    assert dumpio.atomic_write(str(path), lambda f: f.write("new\n")) == 4
    assert path.read_text() == "new\n"
    mode = stat.S_IMODE(os.stat(path).st_mode)
    assert mode == 0o666 & ~dumpio._UMASK


def test_atomic_write_failure_leaves_old_file_and_no_tmp(tmp_path):
    path = tmp_path / "out.jsonl"
    path.write_text("old\n")

    def boom(f):
        f.write("partial")
        raise RuntimeError("disk full")

    with pytest.raises(RuntimeError):
        dumpio.atomic_write(str(path), boom)
    assert path.read_text() == "old\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out.jsonl"]


def test_dump_via_writes_a_caller_stream_directly():
    buf = io.StringIO()
    assert dumpio.dump_via(buf, lambda f: (f.write("x"), 7)[1]) == 7
    assert buf.getvalue() == "x"


# ------------------------------------------------------------ telemetry


def test_telemetry_unsupported_surface():
    for fn in (telemetry.get_power_usage_watts, telemetry.get_clock_mhz):
        with pytest.raises(telemetry.TelemetryNotSupported):
            fn(0, device="cpu")
    with pytest.raises(telemetry.TelemetryNotSupported):
        telemetry.get_device_utilization(0, device="cpu")


def test_telemetry_host_counters():
    try:
        cpu = telemetry.get_host_cpu_times()
    except telemetry.TelemetryNotSupported:
        pass   # sandboxed /proc/stat (all-zero jiffies)
    else:
        assert cpu["user"] >= 0 and cpu["idle"] > 0
    assert telemetry.get_host_memory_info().get("MemTotal", 0) > 0


def test_telemetry_cpu_device_matches_the_reference_cpu_backend():
    from spark_rapids_tpu.utils import telemetry as jtel
    info = telemetry.get_device_info(0, device="cpu")
    ref = jtel.get_device_info(0)
    assert (info.index, info.platform, info.process_index) == \
        (ref.index, ref.platform, ref.process_index) == (0, "cpu", 0)
    assert telemetry.get_device_count(device="cpu") == 1
    assert telemetry.get_memory_info(0, device="cpu") == {}
    with pytest.raises(IndexError):
        telemetry.get_device_info(1, device="cpu")


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="asserts the no-card refusal")
def test_telemetry_without_a_card_raises_unless_asked_for_the_host():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        telemetry.get_device_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        telemetry.get_device_info(0)


def test_telemetry_jni_entries_on_the_host():
    from spark_rapids_tpu_torch.shim import jni_entry
    assert jni_entry.telemetry_device_count("cpu") == 1
    assert jni_entry.telemetry_device_name(0, "cpu") == "cpu:cpu"
    assert jni_entry.telemetry_snapshot_packed(0, "cpu") == [-1] * 7


def test_monitor_stop_idempotent():
    m = telemetry.Monitor(10, listener=lambda infos: None, device="cpu")
    m.stop()
    m.start()
    m.start()
    m.stop(timeout=5)
    m.stop(timeout=5)
    assert m._thread is None


def test_monitor_counts_errors_and_samples(obs_on):
    seen = []
    errs = []

    def listener(infos):
        seen.append([i.platform for i in infos])
        if len(seen) == 2:
            raise RuntimeError("listener bug")

    m = telemetry.Monitor(20, listener, on_error=errs.append, device="cpu")
    m.start()
    time.sleep(0.3)
    m.stop()
    assert m.sample_count >= 2 and seen[0] == ["cpu"]
    assert m.error_count >= 1 and errs
    assert m.last_cpu_utilization is None or \
        0.0 <= m.last_cpu_utilization <= 1.0
    assert obs._LAST_MONITOR_SAMPLE is not None


def test_monitor_reports_device_sampling_errors():
    errs = []
    m = telemetry.Monitor(10, lambda infos: None, on_error=errs.append,
                          device="cpu")
    m.device = "nodevice"     # not a device torch can name
    m.start()
    time.sleep(0.1)
    m.stop()
    assert m.error_count >= 1 and m.sample_count == 0
