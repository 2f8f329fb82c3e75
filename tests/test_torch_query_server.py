"""PyTorch port: the multi-tenant query server (``server/``) held
against the JAX package's.

Each scenario is one scripted sequence (gated runners, so what runs and
what waits is decided by the script, not by timing) driven through both
packages' ``QueryServer``; the transcripts (states, outcomes, typed
errors, scheduler picks, ``stats()`` counts, journal records) must be
equal.  The fair-share scheduler is also driven through seeded
enqueue/pick/charge sequences, and the interleaved TPC-DS mix (q9, q3,
q5, q72 at 1024-row sizes, ``device`` "cpu") must give the JAX
``run_catalog_query`` rows through the port's server.  Tolerance: exact
everywhere, except times and query ids, which must be present (times
non-negative, ids ``q-NNNNNN``).
"""

import json
import os
import re
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu import models as JM
from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu import server as JS
from spark_rapids_tpu.memory import exceptions as JEXC
from spark_rapids_tpu.memory import rmm_spark as JRMM
from spark_rapids_tpu.memory import task_priority as JTP
from spark_rapids_tpu.perf import result_cache as JRC
from spark_rapids_tpu.server import scheduler as JSCH
from spark_rapids_tpu_torch import models as TM
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch import server as TS
from spark_rapids_tpu_torch.memory import exceptions as TEXC
from spark_rapids_tpu_torch.memory import rmm_spark as TRMM
from spark_rapids_tpu_torch.memory import task_priority as TTP
from spark_rapids_tpu_torch.perf import result_cache as TRC
from spark_rapids_tpu_torch.server import scheduler as TSCH
from torch_planes import isolate

JAX = SimpleNamespace(name="jax", models=JM, obs=jobs, server=JS,
                      exc=JEXC, tp=JTP, rmm=JRMM, sched=JSCH, rc=JRC)
PORT = SimpleNamespace(name="torch", models=TM, obs=obs, server=TS,
                       exc=TEXC, tp=TTP, rmm=TRMM, sched=TSCH, rc=TRC)
QID = re.compile(r"^q-\d{6}$")
TIMES = ("wait_ns", "dur_ns")


@pytest.fixture(autouse=True)
def planes(monkeypatch, tmp_path):
    yield from isolate(monkeypatch, tmp_path)


def both(fn):
    """fn(package namespace) for the port and the reference."""
    return fn(PORT), fn(JAX)


def wait_for(predicate, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return False


def make_server(P, runner, *, concurrency=1, max_queue=8,
                device_bytes_fn=None, **kw):
    cfg = P.server.ServerConfig(max_concurrency=concurrency,
                                max_queue=max_queue, stall_ms=0, **kw)
    return P.server.QueryServer(cfg, runner=runner,
                                device_bytes_fn=device_bytes_fn).start()


def gated():
    """(runner, gate, started): jobs block on the gate, polling their
    cancel flag."""
    gate, started = threading.Event(), []

    def run(query, params, ctx):
        started.append(query)
        while not gate.wait(0.005):
            ctx.check_cancel()
        ctx.check_cancel()
        return ["done", query]

    return run, gate, started


def norm(st):
    """A poll status with its times and id checked, then dropped."""
    st = dict(st)
    for k in TIMES:
        assert st.pop(k) >= 0
    qid = st.pop("query_id")
    assert qid == "unknown" or QID.match(qid), qid
    return st


def overloaded(P, fn):
    with pytest.raises(P.server.ServerOverloaded) as ei:
        fn()
    return ei.value.to_dict()


def tenant_counts(stats):
    """Per-tenant counters of stats() without the quota and byte rows."""
    return {t: {k: v for k, v in row.items()
                if k not in ("device_bytes", "quota")}
            for t, row in stats["tenants"].items()}


def journal(P, *kinds, drop=("t_mono_ns", "seq", "query_id", "wait_ns",
                             "dur_ns", "thread", "t_ns", "ts_ns")):
    """Journal records of `kinds`, sorted, without times and ids."""
    out = []
    for kind in kinds:
        for r in P.obs.JOURNAL.records(kind):
            out.append(json.dumps({k: v for k, v in r.items()
                                   if k not in drop}, sort_keys=True))
    return sorted(out)


# ------------------------------------------------------------- admission


def test_concurrent_admission_up_to_n_with_overflow_queue():
    def seq(P):
        run, gate, started = gated()
        s = make_server(P, run, concurrency=2)
        try:
            ids = [s.submit("a", f"g{i}") for i in range(5)]
            assert wait_for(lambda: len(started) == 2)
            st = s.stats()
            out = [st["running_total"], st["queued_total"]]
            gate.set()
            out.append([norm(s.poll(q, timeout_s=20)) for q in ids])
            out.append(tenant_counts(s.stats()))
            return out
        finally:
            gate.set()
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[:2] == [2, 3]
    assert [st["state"] for st in port[2]] == ["done"] * 5


def test_queue_full_and_tenant_quota_typed_backpressure():
    def seq(P):
        run, gate, started = gated()
        s = make_server(P, run, concurrency=1, max_queue=2)
        try:
            s.submit("a", "g0")
            assert wait_for(lambda: started == ["g0"])
            s.set_tenant_quota("greedy", max_inflight=1)
            s.submit("greedy", "g1")
            out = [overloaded(P, lambda: s.submit("greedy", "g2"))]
            s.submit("a", "g3")                     # queue now full
            out.append(overloaded(P, lambda: s.submit("polite", "x")))
            out.append(tenant_counts(s.stats()))
            gate.set()
            return out
        finally:
            gate.set()
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["reason"] == "tenant_inflight"
    assert port[1]["reason"] == "queue_full"
    assert port[1]["retry_after_s"] == 0.03
    assert port[2]["polite"]["rejected"] == 1
    assert port[2]["a"]["rejected"] == 0


def test_tenant_device_bytes_quota():
    def seq(P):
        held = {"pig": 1 << 30}
        run, gate, _ = gated()
        s = make_server(P, run, device_bytes_fn=lambda t: held.get(t, 0))
        s.set_tenant_quota("pig", max_device_bytes=1 << 20)
        try:
            out = [overloaded(P, lambda: s.submit("pig", "g0"))]
            held["pig"] = 0
            qid = s.submit("pig", "g1")
            gate.set()
            out.append(norm(s.poll(qid, timeout_s=20)))
            out.append(s.stats()["tenants"]["pig"]["device_bytes"])
            return out
        finally:
            gate.set()
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["reason"] == "tenant_bytes"


def test_admission_controller_policy():
    def seq(P):
        from importlib import import_module
        adm = import_module(P.server.__name__ + ".admission")
        ac = adm.AdmissionController(max_queue=2)
        ac.set_quota("t", max_inflight=3, max_device_bytes=100,
                     weight=2.0)
        out = [ac.weight_for("t"), ac.weight_for("other")]
        for kw in (dict(queued_total=1, tenant_inflight=1,
                        tenant_device_bytes=0),
                   dict(queued_total=2, tenant_inflight=0,
                        tenant_device_bytes=0),
                   dict(queued_total=0, tenant_inflight=3,
                        tenant_device_bytes=0),
                   dict(queued_total=0, tenant_inflight=0,
                        tenant_device_bytes=100)):
            try:
                ac.check("t", **kw)
                out.append("ok")
            except P.server.ServerOverloaded as e:
                out.append(e.to_dict())
        ac.set_quota("t", weight=4.0)
        q = ac.quota_for("t")
        out.append((q.max_inflight, q.max_device_bytes, q.weight))
        out.append([ac.retry_after(n) for n in (0, 5, 500)])
        return out
    port, ref = both(seq)
    assert port == ref
    assert port[-2] == (3, 100, 4.0)


# ------------------------------------------------------------ fair share


def mk_job(P, tenant, seq_no):
    return P.sched.Job(query_id=f"q{seq_no}", tenant=tenant, query="x",
                       params={}, seq=seq_no, task_id=seq_no, priority=0,
                       submit_ns=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_share_picks_match_reference(seed):
    """A seeded script of arrivals, dispatches and completions with
    weighted tenants: both schedulers pick the same jobs in the same
    order and hold the same vruntimes and deficits."""
    def seq(P):
        rng = np.random.default_rng(seed)
        sched = P.sched.FairShareScheduler()
        weights = {"a": 1.0, "b": 2.0, "c": 0.5, "d": 1.0}
        running = {}
        live = []
        picks = []
        n = 0
        for _ in range(200):
            op = rng.integers(0, 3)
            if op == 0:
                t = "abcd"[rng.integers(0, 4)]
                sched.enqueue(mk_job(P, t, n), dict(running))
                n += 1
            elif op == 1:
                j = sched.pick(running, weights.__getitem__)
                if j is not None:
                    picks.append(j.query_id)
                    running[j.tenant] = running.get(j.tenant, 0) + 1
                    live.append(j)
            elif live:
                j = live.pop(int(rng.integers(0, len(live))))
                running[j.tenant] -= 1
                sched.charge(j.tenant, float(rng.integers(1, 50)) / 100,
                             weights[j.tenant])
        return picks, sched.snapshot(), sched.queued_total()
    port, ref = both(seq)
    assert port == ref
    assert len(port[0]) > 20


def test_fair_share_scheduler_unit():
    def seq(P):
        sched = P.sched.FairShareScheduler()
        a1, a2, b1 = mk_job(P, "a", 0), mk_job(P, "a", 1), mk_job(P, "b", 2)
        for j in (a1, a2, b1):
            sched.enqueue(j)
        w = {"a": 1.0, "b": 1.0}
        out = [sched.pick({}, w.__getitem__).query_id,
               sched.pick({"a": 1}, w.__getitem__).query_id]
        sched.charge("a", 2.0, 1.0)
        sched.charge("b", 1.0, 1.0)
        out.append(sched.deficit())
        out.append([sched.remove(a2), sched.remove(a2),
                    sched.queued_total()])
        sched.charge("c", 2.0, 2.0)
        out.append(sched.snapshot())
        # idle return: floored to the active tenants' minimum
        s2 = P.sched.FairShareScheduler()
        s2.charge("a", 1.0, 1.0)
        s2.charge("b", 50.0, 1.0)
        s2.enqueue(mk_job(P, "b", 0), {})
        s2.enqueue(mk_job(P, "a", 1), {"b": 1})
        s2.enqueue(mk_job(P, "b", 2), {})
        out.append(s2.snapshot())
        return out
    port, ref = both(seq)
    assert port == ref
    assert port[:2] == ["q0", "q2"]
    assert port[-1]["vruntime"] == {"a": 50.0, "b": 50.0}


def test_job_status_shapes_match_reference():
    def seq(P):
        j = mk_job(P, "t", 3)
        out = [j.status()]
        j.state, j.result, j.outcome = "done", [1, 2], "success"
        j.hung, j.cancel_reason = True, "hang"
        j.error = {"type": "QueryHung"}
        out.append(j.status())
        return out
    port, ref = both(seq)
    assert port == ref


def test_finished_jobs_bounded_and_running_rows_dropped():
    def seq(P):
        cfg = P.server.ServerConfig(max_concurrency=1, max_queue=8,
                                    stall_ms=0, finished_keep=3)
        s = P.server.QueryServer(cfg, runner=lambda q, p, c: [q]).start()
        try:
            ids = []
            for i in range(6):
                qid = s.submit("a", f"q{i}")
                assert s.poll(qid, timeout_s=20)["state"] == "done"
                ids.append(qid)
            return [s.stats()["jobs_total"], s.poll(ids[0])["state"],
                    norm(s.poll(ids[-1])), dict(s._running)]
        finally:
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[:2] == [3, "unknown"] and port[3] == {}


def test_tenant_stats_rows_bounded():
    def seq(P):
        s = make_server(P, lambda q, p, c: None)
        try:
            with s._lock:
                for i in range(400):
                    s._stat(f"flood-{i}", "rejected")
            tenants = s.stats()["tenants"]
            return len(tenants), tenants[s._OTHER]["rejected"]
        finally:
            s.stop()
    port, ref = both(seq)
    assert port == ref == (257, 144)


def test_pipeline_cache_bounded(monkeypatch):
    def seq(P):
        monkeypatch.setattr(P.models, "_PIPELINES_MAX", 4)
        built = []
        with P.models._PIPELINES_LOCK:
            P.models._PIPELINES.clear()
        for i in range(10):
            P.models._pipeline(("t", i), lambda i=i: built.append(i) or i)
        out = [len(P.models._PIPELINES)]
        n = len(built)
        out.append(P.models._pipeline(("t", 9), lambda: built.append(99)))
        out.append(len(built) - n)
        with P.models._PIPELINES_LOCK:
            P.models._PIPELINES.clear()
        return out
    port, ref = both(seq)
    assert port == ref == [4, 9, 0]


# ---------------------------------------------------------- cancellation


def test_cancel_queued_and_running():
    def seq(P):
        run, gate, started = gated()
        s = make_server(P, run)
        try:
            blocker = s.submit("a", "blocker")
            queued = s.submit("a", "victim")
            assert wait_for(lambda: started == ["blocker"])
            out = [s.cancel(queued), norm(s.poll(queued)),
                   s.cancel(blocker), norm(s.poll(blocker, timeout_s=20)),
                   list(started), s.cancel(blocker), s.cancel("nope")]
            out.append(journal(P, "server_cancel"))
            return out
        finally:
            gate.set()
            s.stop()
    obs.enable()
    jobs.enable()
    port, ref = both(seq)
    assert port == ref
    assert port[1]["state"] == port[3]["state"] == "cancelled"
    assert port[4] == ["blocker"]


def test_cancel_between_pick_and_execute_frees_running_slot():
    """A job cancelled after a worker picked it but before it ran must
    still release its tenant's running count."""
    def seq(P):
        run, gate, started = gated()

        def runner(query, params, ctx):
            if query == "doomed":   # pragma: no cover - must not run
                raise AssertionError("cancelled job must not execute")
            return run(query, params, ctx)

        s = make_server(P, runner)
        try:
            s.submit("b", "blocker")     # holds the only worker
            assert wait_for(lambda: started == ["blocker"])
            qid = s.submit("a", "doomed")
            with s._work:
                job = s._sched.pick(s._running, s._admission.weight_for)
                assert job is s._jobs[qid]
                job.state = "running"
                s._running["a"] = s._running.get("a", 0) + 1
            job.cancel_event.set()
            s._execute(job, queue_depth=0)
            gate.set()
            st = s.stats()
            return [norm(s.poll(qid)), st["tenants"]["a"]["running"],
                    tenant_counts(st)["a"]]
        finally:
            gate.set()
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["state"] == "cancelled" and port[1] == 0


def test_cancel_dominates_oom_outcome():
    def seq(P):
        started = threading.Event()

        def run(query, params, ctx):
            started.set()
            while not ctx.cancelled():
                time.sleep(0.005)
            raise P.exc.GpuRetryOOM("runner unwound via OOM on cancel")

        s = make_server(P, run, max_requeues=2)
        try:
            qid = s.submit("a", "q")
            assert started.wait(10)
            return [s.cancel(qid), norm(s.poll(qid, timeout_s=20)),
                    tenant_counts(s.stats())["a"]]
        finally:
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[1]["state"] == "cancelled" and "error" not in port[1]
    assert port[2]["requeued"] == port[2]["shed"] == 0


def test_poll_timeout_and_cancel_after_done():
    def seq(P):
        run, gate, started = gated()
        s = make_server(P, run)
        try:
            qid = s.submit("a", "slow")
            assert wait_for(lambda: started == ["slow"])
            out = [norm(s.poll(qid, timeout_s=0.02)), norm(s.poll(qid))]
            gate.set()
            out += [norm(s.poll(qid, timeout_s=20)),
                    norm(s.poll(qid, timeout_s=0.01)), s.cancel(qid),
                    norm(s.poll(qid)),
                    tenant_counts(s.stats())["a"]["cancelled"]]
            return out
        finally:
            gate.set()
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["timed_out"] is True and "timed_out" not in port[1]
    assert port[2]["result"] == ["done", "slow"] and port[4] is False


# ---------------------------------------------------------- deadlines


def test_deadline_expires_queued_and_cancels_running():
    def seq(P):
        run, gate, started = gated()
        s = make_server(P, run, watchdog_interval_s=0.02)
        try:
            blocker = s.submit("a", "blocker")
            assert wait_for(lambda: started == ["blocker"])
            doomed = s.submit("a", "doomed", deadline_s=0.05)
            out = [norm(s.poll(doomed, timeout_s=20))]
            gate.set()
            out.append(norm(s.poll(blocker, timeout_s=20)))
            gate.clear()
            slow = s.submit("a", "slow", deadline_s=0.1)
            st = norm(s.poll(slow, timeout_s=20))
            # the watchdog's flag or the runner's own deadline check,
            # whichever comes first (both give the deadline outcome)
            assert st.pop("cancel_reason", "deadline") == "deadline"
            out.append(st)
            out.append(tenant_counts(s.stats())["a"])
            out.append([r for r in journal(P, "server_watchdog")
                        if "deadline_expired_queued" in r])
            return out
        finally:
            gate.set()
            s.stop()
    obs.enable()
    jobs.enable()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["error"] == {"type": "QueryDeadlineExceeded",
                                "reason": "deadline_expired_queued"}
    assert port[2]["outcome"] == "deadline"
    assert port[3]["deadline"] == 2


def test_cooperative_deadline_and_user_cancel_precedence():
    def seq(P):
        m = P.models
        ctx = m.QueryContext("q-x", "t",
                             deadline_ns=time.monotonic_ns() - 1)
        out = []
        try:
            ctx.check_cancel()
        except m.QueryCancelled as e:
            out.append(type(e).__name__)
        out.append(ctx.remaining_s() < 0)
        ev = threading.Event()
        ev.set()
        ctx2 = m.QueryContext("q-y", "t", cancel_event=ev,
                              deadline_ns=time.monotonic_ns() - 1)
        try:
            ctx2.check_cancel()
        except m.QueryCancelled as e:
            out.append(type(e).__name__)
        out.append(issubclass(m.QueryDeadlineExceeded, m.QueryCancelled))
        return out
    port, ref = both(seq)
    assert port == ref == ["QueryDeadlineExceeded", True,
                           "QueryCancelled", True]


# --------------------------------------------------------- load shedding


def test_load_shed_requeues_at_lower_priority_then_succeeds():
    def seq(P):
        attempts = {}

        def flaky(query, params, ctx):
            attempts[query] = attempts.get(query, 0) + 1
            if attempts[query] == 1:
                time.sleep(0.02)
                raise P.exc.GpuRetryOOM("tenant over quota")
            return ["ok", attempts[query]]

        s = make_server(P, flaky, max_requeues=1)
        try:
            qid = s.submit("a", "flaky")
            job = s._jobs[qid]
            p0 = job.priority
            st = norm(s.poll(qid, timeout_s=20))
            vr = s.stats()["scheduler"]["vruntime"]["a"]
            return [st, job.priority < p0, vr >= 0.015,
                    tenant_counts(s.stats())["a"],
                    journal(P, "server_requeue")]
        finally:
            s.stop()
    obs.enable()
    jobs.enable()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["result"] == ["ok", 2] and port[0]["demotions"] == 1
    assert port[1] and port[2] and port[3]["requeued"] == 1


def test_load_shed_exhausted_fails_alone():
    def seq(P):
        def doomed(query, params, ctx):
            if query == "doomed":
                raise P.exc.GpuSplitAndRetryOOM("still too big")
            return ["fine"]

        s = make_server(P, doomed, max_requeues=1)
        try:
            bad = s.submit("a", "doomed")
            good = s.submit("b", "healthy")
            return [norm(s.poll(bad, timeout_s=20)),
                    norm(s.poll(good, timeout_s=20)),
                    tenant_counts(s.stats())]
        finally:
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["error"]["reason"] == "oom_quota_exhausted"
    assert port[0]["error"]["type"] == "GpuSplitAndRetryOOM"
    assert port[2]["a"]["shed"] == 1 and port[1]["state"] == "done"


def test_spill_rescue_requeues_without_a_demotion():
    class Store:
        def __init__(self):
            self.calls = 0

        def ensure_headroom(self, n):
            self.calls += 1
            return 4096

    def seq(P):
        from importlib import import_module
        spill = import_module(P.rmm.__name__.rsplit(".", 1)[0] + ".spill")
        attempts = []

        def flaky(query, params, ctx):
            attempts.append(query)
            if len(attempts) == 1:
                raise P.exc.GpuRetryOOM("pressure")
            return ["ok"]

        store = Store()
        saved = spill.installed_store
        spill.installed_store = lambda: store
        s = make_server(P, flaky, max_requeues=0)
        try:
            st = norm(s.poll(s.submit("a", "q"), timeout_s=20))
            return [st, store.calls, tenant_counts(s.stats())["a"]]
        finally:
            s.stop()
            spill.installed_store = saved
    port, ref = both(seq)
    assert port == ref
    assert port[0]["state"] == "done" and port[0]["demotions"] == 0
    assert port[1] == 1 and port[2]["requeued"] == 1


# --------------------------------------------- rmm / memory-ledger fold


def test_tenant_device_bytes_from_memory_ledger():
    def seq(P):
        P.rmm.clear_event_handler()
        P.rmm.set_event_handler(1 << 20)
        hold, release = threading.Event(), threading.Event()

        def alloc_and_hold(query, params, ctx):
            P.rmm.get_adaptor().allocate(4096)
            hold.set()
            release.wait(10)
            P.rmm.get_adaptor().deallocate(4096)
            return ["freed"]

        s = make_server(P, alloc_and_hold)
        try:
            qid = s.submit("a", "holder")
            assert hold.wait(10)
            out = [s.stats()["tenants"]["a"]["device_bytes"]]
            release.set()
            out.append(norm(s.poll(qid, timeout_s=20)))
            out.append(s.stats()["tenants"]["a"]["device_bytes"])
            return out
        finally:
            release.set()
            s.stop()
            P.rmm.clear_event_handler()
    port, ref = both(seq)
    assert port == ref
    assert port[0] == 4096 and port[2] == 0


# ----------------------------------------- byte identity + attribution

# one executor's mix at a small size: q9 and q3, two seeds each, per
# tenant pair (the JAX package compiles each shape once)
TPCDS_MIX = [
    ("tenant_a", "tpcds_q9", {"rows": 1024, "seed": 1}),
    ("tenant_a", "tpcds_q3", {"rows": 1024, "seed": 2}),
    ("tenant_b", "tpcds_q9", {"rows": 1024, "seed": 3}),
    ("tenant_b", "tpcds_q3", {"rows": 1024, "seed": 4}),
    ("tenant_c", "tpcds_q5", {"rows": 1024, "seed": 5}),
    ("tenant_c", "tpcds_q9", {"rows": 1024, "seed": 6}),
    ("tenant_d", "tpcds_q72", {"rows": 1024, "seed": 7}),
    ("tenant_d", "tpcds_q5", {"rows": 1024, "seed": 8}),
]


def test_interleaved_tpcds_equals_the_reference_with_attribution(
        monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    ref = [JM.run_catalog_query(q, dict(p)) for _t, q, p in TPCDS_MIX]
    obs.enable()
    obs.enable_tracing()
    obs.enable_slo()
    obs.reset()
    s = TS.QueryServer(TS.ServerConfig(max_concurrency=3, max_queue=16,
                                       stall_ms=0)).start()
    try:
        ids = [s.submit(t, q, dict(p, device="cpu"))
               for t, q, p in TPCDS_MIX]
        got = [s.poll(qid, timeout_s=120) for qid in ids]
    finally:
        s.stop()
    assert [g["state"] for g in got] == ["done"] * len(TPCDS_MIX)
    for (t, q, p), g, want in zip(TPCDS_MIX, got, ref):
        assert g["result"] == want, (t, q, p)
    tenants = {t for t, _q, _p in TPCDS_MIX}
    assert {e["tenant"] for e in obs.JOURNAL.records("server_admit")} \
        == tenants
    completes = obs.JOURNAL.records("server_complete")
    assert {e["tenant"] for e in completes} == tenants
    assert {e["outcome"] for e in completes} == {"success"}
    spans = [r for r in obs.TRACER.records()
             if r["name"].startswith("server_query:")]
    assert {r["attrs"]["tenant"] for r in spans} == tenants
    assert len({r["attrs"]["server_task_id"] for r in spans}) \
        == len(TPCDS_MIX)
    text = obs.expose_text()
    for family in ("srt_server_admitted_total", "srt_server_completed_total",
                   "srt_server_queue_wait_ns"):
        assert family in text
    st = s.stats()
    assert set(st["tenants"]) == tenants
    for t in tenants:
        assert st["tenants"][t]["success"] == 2
    assert sum(v["events"] for v in obs.SLO.status().values()) \
        == len(TPCDS_MIX)


def test_stats_shape_matches_reference():
    def seq(P):
        run, gate, _ = gated()
        s = make_server(P, run, concurrency=1)
        try:
            s.set_tenant_quota("a", max_inflight=5, weight=2.0)
            qid = s.submit("a", "g")
            gate.set()
            s.poll(qid, timeout_s=20)
            st = s.stats()
        finally:
            gate.set()
            s.stop()
        st["lifeguard"]["watchdog"].pop("scans")
        st["scheduler"].pop("vruntime")
        st["scheduler"].pop("deficit")
        st.pop("task_priority")
        return st
    port, ref = both(seq)
    assert port == ref
    assert port["tenants"]["a"]["quota"] == {
        "max_inflight": 5, "max_device_bytes": 0, "weight": 2.0}


def test_server_config_from_env_reads_the_same_knobs(monkeypatch):
    for k, v in (("MAX_CONCURRENCY", "7"), ("MAX_QUEUE", "9"),
                 ("TENANT_MAX_INFLIGHT", "3"), ("STALL_MS", "11"),
                 ("HANG_S", "4.5"), ("WATCHDOG_MS", "5"),
                 ("QUARANTINE_FAILURES", "6"), ("PROFILE_KEEP", "2"),
                 ("DRAIN_DEADLINE_S", "bogus")):
        monkeypatch.setenv("SPARK_RAPIDS_TPU_SERVER_" + k, v)
    port, ref = both(lambda P: vars(P.server.ServerConfig.from_env()))
    assert port == ref
    assert port["watchdog_interval_s"] == 0.01
    assert port["drain_deadline_s"] == 30.0


# ----------------------------------------- admission stall + profiles


def test_admission_stall_bundle_matches_reference(tmp_path):
    def seq(P):
        P.obs.enable()
        P.obs.reset()
        out_dir = tmp_path / P.name
        P.obs.enable_flight_recorder(out_dir=str(out_dir),
                                     min_interval_s=0.0)
        run, gate, started = gated()
        held = {"hog": 123 << 20, "victim": 0}
        cfg = P.server.ServerConfig(max_concurrency=1, max_queue=8,
                                    stall_ms=1)
        s = P.server.QueryServer(cfg, runner=run,
                                 device_bytes_fn=held.get).start()
        try:
            s.submit("hog", "blocker")
            assert wait_for(lambda: started == ["blocker"])
            victim = s.submit("victim", "stalled")
            time.sleep(0.03)
            gate.set()
            assert s.poll(victim, timeout_s=20)["state"] == "done"
        finally:
            gate.set()
            s.stop()
            P.obs.disable_flight_recorder()
        bundles = sorted(n for n in os.listdir(out_dir)
                         if n.startswith("incident-"))
        with open(out_dir / bundles[-1] / "trigger.json") as f:
            trig = json.load(f)
        d = trig["detail"]
        return [trig["kind"], trig["severity"], d["tenant"],
                d["queue_depth"], d["tenant_device_bytes"],
                d["queue_wait_ms"] >= 1]
    port, ref = both(seq)
    assert port == ref
    assert port[:5] == ["admission_stall", "warn", "victim", 0,
                        {"hog": 123 << 20, "victim": 0}]


def test_profile_retention_window_per_tenant():
    def seq(P):
        P.obs.enable_profiling()
        cfg = P.server.ServerConfig(max_concurrency=1, max_queue=8,
                                    stall_ms=0, profile_keep=2)
        s = P.server.QueryServer(cfg, runner=lambda q, p, c: [q]).start()
        try:
            ids = [s.submit(t, f"q{i}") for i, t in
                   enumerate(["a", "a", "a", "b"])]
            for qid in ids:
                s.poll(qid, timeout_s=20)
            kept = s.profile_ids("a")
            prof = s.profile(ids[-1])
            return [kept == ids[1:3], s.profile_ids("b") == ids[3:],
                    s.profile(ids[0]) is None, prof["tenant"],
                    prof["query"]]
        finally:
            s.stop()
            P.obs.disable_profiling()
    port, ref = both(seq)
    assert port == ref == [True, True, True, "b", "q3"]


# ------------------------------------------------------ socket front door


def rpc_session(path, reqs):
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(path)
    f = conn.makefile("rwb")
    out = []
    try:
        for req in reqs:
            f.write((req if isinstance(req, bytes)
                     else json.dumps(req).encode()) + b"\n")
            f.flush()
            out.append(json.loads(f.readline()))
    finally:
        conn.close()
    return out


def test_socket_front_door_answers_like_the_reference(tmp_path):
    def seq(P):
        run, gate, started = gated()

        def runner(query, params, ctx):
            if query == "echo":
                return {"payload": params.get("x")}
            if query == "unjson":
                return {1, 2, 3}
            return run(query, params, ctx)

        s = make_server(P, runner, max_queue=1)
        path = str(tmp_path / f"{P.name}.sock")
        door = P.server.SocketFrontDoor(s, path).start()
        try:
            first = rpc_session(path, [
                {"op": "submit", "tenant": "remote", "query": "echo",
                 "params": {"x": 42}}])[0]
            out = rpc_session(path, [
                {"op": "poll", "query_id": first["query_id"],
                 "timeout_s": 20},
                {"op": "submit", "tenant": "remote", "query": "unjson"}])
            bad = rpc_session(path, [
                {"op": "poll", "query_id": out[1]["query_id"],
                 "timeout_s": 20},
                {"op": "submit", "tenant": "remote", "query": "g0"}])
            assert wait_for(lambda: started == ["g0"])
            bad += rpc_session(path, [
                {"op": "submit", "tenant": "remote", "query": f"g{i}"}
                for i in range(1, 4)] + [
                {"op": "nope"}, {"op": "poll", "query_id": "missing"},
                {"op": "profile", "query_id": "missing"},
                b"[1, 2]", b"{not json"])
            stats = rpc_session(path, [{"op": "stats"}])[0]
            gate.set()
        finally:
            gate.set()
            door.stop()
            s.stop()
        out[0]["status"] = norm(out[0]["status"])
        shaped = [dict(r) for r in [first, out[1]] + bad]
        for r in shaped:
            if "query_id" in r:
                assert QID.match(r.pop("query_id"))
        return [out[0], shaped, sorted(stats["stats"]),
                os.path.exists(path)]
    port, ref = both(seq)
    assert port == ref
    assert port[0]["status"]["result"] == {"payload": 42}
    assert port[1][2]["ok"] is False
    assert port[1][2]["error"]["type"] == "UnserializableResult"
    assert any(r.get("error", {}).get("reason") == "queue_full"
               for r in port[1])
    assert port[3] is False


def test_socket_unknown_query_is_typed_for_a_catalog_server(tmp_path):
    def seq(P):
        s = P.server.QueryServer(P.server.ServerConfig(
            max_concurrency=1, max_queue=4, stall_ms=0)).start()
        path = str(tmp_path / f"u{P.name}.sock")
        door = P.server.SocketFrontDoor(s, path).start()
        try:
            return rpc_session(path, [{"op": "submit", "tenant": "t",
                                       "query": "no_such_query"}])
        finally:
            door.stop()
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["error"]["type"] == "UnknownQuery"


# --------------------------------------------- the result cache's hits


def canon(value) -> bytes:
    return json.dumps(value, sort_keys=True, default=str).encode()


def test_server_warm_hit_byte_identical_and_counted(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_RESULT_CACHE", "1")
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")

    def seq(P):
        s = P.server.QueryServer(P.server.ServerConfig(
            max_concurrency=2, stall_ms=0)).start()
        try:
            p = {"rows": 512, "seed": 19, "device": "cpu"}
            out = []
            for tenant, params in (("alpha", p), ("alpha", p),
                                   ("bravo", p),
                                   ("alpha", dict(p, seed=20))):
                st = s.poll(s.submit(tenant, "tpcds_q3", dict(params)),
                            timeout_s=120)
                out.append((st["state"], st.get("outcome"),
                            canon(st["result"])))
            counts = {t: row["cache_hit"]
                      for t, row in s.stats()["tenants"].items()}
            return out, counts
        finally:
            s.stop()
    port, ref = both(seq)
    assert port == ref
    outs, counts = port
    assert [o[1] for o in outs] == ["success", "cache_hit", "cache_hit",
                                    "success"]
    assert outs[0][2] == outs[1][2] == outs[2][2] != outs[3][2]
    assert counts == {"alpha": 1, "bravo": 1}
    assert TRC.CACHE.stats()["hits"] == JRC.CACHE.stats()["hits"] == 2


def test_warm_hit_profile_and_attribution_conserved(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_RESULT_CACHE", "1")
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    from spark_rapids_tpu_torch.observability import attribution
    obs.enable()
    obs.enable_profiling()
    s = TS.QueryServer(TS.ServerConfig(max_concurrency=2,
                                       stall_ms=0)).start()
    try:
        p = {"rows": 512, "seed": 21, "device": "cpu"}
        assert s.poll(s.submit("alpha", "tpcds_q3", dict(p)),
                      timeout_s=120)["state"] == "done"
        warm_id = s.submit("alpha", "tpcds_q3", dict(p))
        assert s.poll(warm_id, timeout_s=120)["outcome"] == "cache_hit"
        prof = s.profile(warm_id)
    finally:
        s.stop()
    assert prof["cache"]["hits"] == 1 and prof["cache"]["lookup_ns"] > 0
    led = attribution.attribute_profile(prof)
    assert led["conserved"]
    assert led["buckets"]["cache_lookup"] == prof["wall_ns"]


# ------------------------------------------- chip_smoke's server phase


def test_server_phase_rehearsal_on_cpu(monkeypatch, tmp_path):
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    res = C.server_phase("cpu", params=C.SERVER_SMALL,
                         flagship_rows=1 << 10, q9_rows=1 << 10,
                         deadline_q5=C.SERVER_SMALL_DEADLINE_Q5)
    assert res["interleaved"]["requests"] == 8
    assert res["interleaved"]["slo_events"] == 8
    assert res["backpressure"] == {"rejects": 2, "requeues": 1}
    assert res["lifeguard"]["incidents"] == ["admission_stall",
                                             "query_hang"]
    assert res["lifeguard"]["quarantine_events"] == [
        "opened", "rejected", "probe", "closed"]
    assert res["socket_drain"]["drain"]["abandoned"] == 0
    assert res["dynamo_graphs_added"] == 0
    assert TS.get_server() is None


# ----------------------------------------------------- the tools' half


def test_metrics_report_server_table(tmp_path):
    """The reference's server-table case: each package's journal dump,
    read by both packages' metrics_report, gives the same report and
    the same rendered server table."""
    from spark_rapids_tpu.tools import metrics_report as JMR
    from spark_rapids_tpu_torch.tools import metrics_report as PMR

    def dump(P):
        P.obs.enable()
        P.obs.reset()
        run, gate, started = gated()

        def runner(query, params, ctx):
            if query == "q_ok":
                return [1]
            return run(query, params, ctx)

        s = make_server(P, runner, concurrency=1, max_queue=1)
        try:
            qid = s.submit("acme", "q_ok")
            assert s.poll(qid, timeout_s=20)["state"] == "done"
            s.submit("acme", "blocker")
            assert wait_for(lambda: started == ["blocker"])
            s.submit("acme", "queued")      # queue full from here on
            with pytest.raises(P.server.ServerOverloaded):
                s.submit("acme", "flood")
            gate.set()
        finally:
            gate.set()
            s.stop()
        path = str(tmp_path / f"{P.name}.jsonl")
        P.obs.dump_journal_jsonl(path)
        P.obs.reset()
        P.obs.disable()
        return path

    for path in both(dump):
        report = PMR.build_report(PMR.load_jsonl([path]))
        assert report == JMR.build_report(JMR.load_jsonl([path]))
        rows = {(r["tenant"], r["query"]): r for r in report["server"]}
        assert rows[("acme", "*")]["admitted"] >= 1
        assert rows[("acme", "*")]["rejected"] >= 1
        assert rows[("acme", "q_ok")]["success"] == 1
        _rollup, registry, events = PMR.split_records(
            PMR.load_jsonl([path]))
        lines = "\n".join(PMR.render_server_table(events, registry))
        assert "acme:*" in lines and "acme:q_ok" in lines
        _r, jreg, jev = JMR.split_records(JMR.load_jsonl([path]))
        assert lines == "\n".join(JMR.render_server_table(jev, jreg))


def test_admission_stall_doctor_names_the_memory_holder(tmp_path):
    """The doctor half of the reference's admission-stall case: each
    package's admission_stall bundle, read by both doctors, carries the
    stall and names the tenant holding device memory."""
    from spark_rapids_tpu.tools import doctor as JD
    from spark_rapids_tpu_torch.tools import doctor as PD

    def bundle(P):
        P.obs.enable()
        P.obs.reset()
        out_dir = tmp_path / P.name
        P.obs.enable_flight_recorder(out_dir=str(out_dir),
                                     min_interval_s=0.0)
        run, gate, started = gated()
        held = {"hog": 123 << 20, "victim": 0}
        cfg = P.server.ServerConfig(max_concurrency=1, max_queue=8,
                                    stall_ms=1)
        s = P.server.QueryServer(cfg, runner=run,
                                 device_bytes_fn=held.get).start()
        try:
            blocker = s.submit("hog", "blocker")
            assert wait_for(lambda: started == ["blocker"])
            victim = s.submit("victim", "stalled")
            time.sleep(0.05)   # queue wait must cross the 1ms stall bar
            gate.set()
            assert s.poll(victim, timeout_s=20)["state"] == "done"
            assert s.poll(blocker, timeout_s=20)["state"] == "done"
        finally:
            gate.set()
            s.stop()
            P.obs.disable_flight_recorder()
        P.obs.reset()
        P.obs.disable()
        return str(out_dir)

    for out in both(bundle):
        bundles = PD.find_bundles(out)
        assert bundles, "admission stall produced no incident bundle"
        b = PD.Bundle(bundles[-1])
        assert b.trigger["kind"] == "admission_stall"
        findings = PD.analyze(b)
        assert findings == JD.analyze(JD.Bundle(bundles[-1]))
        kinds = {f["kind"] for f in findings}
        assert "admission_stall" in kinds
        memory = [f for f in findings if f["kind"] == "tenant_memory"]
        assert memory and "'hog'" in memory[0]["message"]
        assert "123.0 MiB" in memory[0]["message"]
