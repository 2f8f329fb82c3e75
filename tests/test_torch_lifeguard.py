"""PyTorch port: the query lifeguard (``robustness/lifeguard.py``) and
the server's eviction half (hung workers, quarantine, drain, the socket
door's idle timeout) held against the JAX package's.

The breaker runs on injected clocks, so its verdicts, retry-after hints
and snapshots are compared exactly; the server scenarios are scripted
(gated or silent runners) and compared as transcripts of states,
outcomes, typed errors, journal records and drain reports.  Tolerance:
exact everywhere, except times and ids, which must be present (times
non-negative).
"""

import json
import os
import socket
import threading
import time
from types import SimpleNamespace

import pytest

from spark_rapids_tpu import models as JM
from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu import server as JS
from spark_rapids_tpu.memory import exceptions as JEXC
from spark_rapids_tpu.memory import rmm_spark as JRMM
from spark_rapids_tpu.robustness import lifeguard as JLG
from spark_rapids_tpu.robustness import retry as JR
from spark_rapids_tpu_torch import models as TM
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch import server as TS
from spark_rapids_tpu_torch.memory import exceptions as TEXC
from spark_rapids_tpu_torch.memory import rmm_spark as TRMM
from spark_rapids_tpu_torch.robustness import lifeguard as TLG
from spark_rapids_tpu_torch.robustness import retry as TR
from torch_planes import isolate

JAX = SimpleNamespace(name="jax", models=JM, obs=jobs, server=JS,
                      exc=JEXC, rmm=JRMM, lg=JLG, retry=JR)
PORT = SimpleNamespace(name="torch", models=TM, obs=obs, server=TS,
                       exc=TEXC, rmm=TRMM, lg=TLG, retry=TR)


@pytest.fixture(autouse=True)
def planes(monkeypatch, tmp_path):
    yield from isolate(monkeypatch, tmp_path)


def both(fn):
    return fn(PORT), fn(JAX)


def wait_for(predicate, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return False


def lifeguard_server(P, runner, *, concurrency=1, hang_s=0.2,
                     quarantine_failures=0, cooldown_s=0.2,
                     max_requeues=0, drain_deadline_s=10.0):
    cfg = P.server.ServerConfig(
        max_concurrency=concurrency, max_queue=16, stall_ms=0,
        max_requeues=max_requeues, hang_s=hang_s,
        watchdog_interval_s=0.02, quarantine_failures=quarantine_failures,
        quarantine_cooldown_s=cooldown_s,
        drain_deadline_s=drain_deadline_s)
    return P.server.QueryServer(cfg, runner=runner).start()


def status(st):
    st = dict(st)
    for k in ("wait_ns", "dur_ns"):
        assert st.pop(k) >= 0
    st.pop("query_id")
    return st


def records(P, kind, keep):
    return [{k: r.get(k) for k in keep}
            for r in P.obs.JOURNAL.records(kind)]


# ------------------------------------------------------------ heartbeats


def test_beats_are_gated_by_the_hook_and_round_trip():
    def seq(P):
        lg = P.lg
        ident = threading.get_ident()
        lg.clear_beat(ident)
        lg.beat("ignored")                  # no consumer: nothing kept
        out = [lg.last_beat(ident)]
        lg.install_heartbeat_hook()
        try:
            lg.beat("unit")
            t_ns, label = lg.last_beat(ident)
            out += [label, 0 <= time.monotonic_ns() - t_ns < 5e9]
            lg.clear_beat(ident)
            out.append(lg.last_beat(ident))
        finally:
            lg.release_heartbeat_hook()
        return out
    port, ref = both(seq)
    assert port == ref == [None, "unit", True, None]


def test_retry_attempts_and_op_records_beat():
    def seq(P):
        P.lg.install_heartbeat_hook()
        try:
            ident = threading.get_ident()
            P.lg.clear_beat(ident)
            P.retry.with_retry(
                lambda: 1, name="lg_beat",
                policy=P.retry.RetryPolicy(base_backoff_s=0.0))
            out = [P.lg.last_beat(ident)[1]]
            P.obs.record_op("lg_op", 123)   # metrics off: hook only
            out.append(P.lg.last_beat(ident)[1])
            return out
        finally:
            P.lg.release_heartbeat_hook()
    port, ref = both(seq)
    assert port == ref == ["retry:lg_beat", "op:lg_op"]


def test_check_cancel_beats_the_query_context():
    def seq(P):
        P.lg.install_heartbeat_hook()
        try:
            P.models.QueryContext("q-7", "t").check_cancel()
            return P.lg.last_beat(threading.get_ident())[1]
        finally:
            P.lg.release_heartbeat_hook()
    port, ref = both(seq)
    assert port == ref == "ctx:q-7"


def test_beat_table_prunes_dead_threads_past_its_bound(monkeypatch):
    def seq(P):
        monkeypatch.setattr(P.lg, "_BEATS_MAX", 8)
        P.lg.install_heartbeat_hook()
        try:
            for _ in range(12):
                t = threading.Thread(target=P.lg.beat, args=("x",))
                t.start()
                t.join()
            P.lg.beat("main")
            with P.lg._BEATS_LOCK:
                return len(P.lg._BEATS) <= 8
        finally:
            P.lg.release_heartbeat_hook()
    port, ref = both(seq)
    assert port == ref == True  # noqa: E712


def test_thread_stack_names_live_frames():
    def seq(P):
        here, done = threading.Event(), threading.Event()

        def parked():
            here.set()
            done.wait(10)

        t = threading.Thread(target=parked, daemon=True)
        t.start()
        assert here.wait(5)
        stack = P.lg.thread_stack(t.ident)
        done.set()
        t.join(5)
        return [any("parked" in line or "done.wait" in line
                    for line in stack), P.lg.thread_stack(None),
                P.lg.thread_stack(1)]
    port, ref = both(seq)
    assert port == ref == [True, [], []]


@pytest.mark.parametrize("tenant,query,params", [
    ("t", "q", {"rows": 1024}), ("t", "q", {"rows": 2048}),
    ("u", "tpcds_q9", {"rows": 1024, "seed": 3}), ("t", "q", None),
    ("t", "q", {"nested": {"b": [1, 2], "a": 1.5}})])
def test_signature_equals_the_reference(tenant, query, params):
    port, ref = both(lambda P: P.lg.signature(tenant, query, params))
    assert port == ref and port.startswith(f"{tenant}/{query}@")


# ----------------------------------------------------- quarantine breaker


def breaker(P, failures, cooldown_s, clock):
    return P.lg.QuarantineBreaker(failures=failures, cooldown_s=cooldown_s,
                                  clock=lambda: clock["t"])


def test_breaker_open_probe_close_cycle():
    def seq(P):
        clock = {"t": 0.0}
        br = breaker(P, 2, 10.0, clock)
        sig = "t/q@abc"
        out = [br.admit(sig), br.note_death(sig, "failed"),
               br.note_death(sig, "hung")]
        clock["t"] = 4.0
        out.append(br.admit(sig))
        out.append(br.snapshot())
        clock["t"] = 10.5
        out += [br.admit(sig), br.admit(sig),
                br.note_success(sig, probe=True), br.admit(sig),
                br.snapshot()]
        return out
    port, ref = both(seq)
    assert port == ref
    assert port[3] == {"verdict": "refused", "retry_after_s": 6.0,
                       "strikes": 2}
    assert [v["verdict"] for v in (port[5], port[6], port[8])] == [
        "probe", "refused", "ok"]
    assert port[9]["quarantined"] == {}


def test_breaker_failed_probe_escalates_and_cancelled_probe_rearms():
    def seq(P):
        clock = {"t": 0.0}
        br = breaker(P, 1, 1.0, clock)
        sig = "t/q@bad"
        out = [br.note_death(sig, "shed")]
        clock["t"] = 1.5
        out += [br.admit(sig), br.note_death(sig, "shed", probe=True)]
        clock["t"] = 4.0
        out.append(br.admit(sig))
        br.note_neutral(sig, probe=True)
        out.append(br.admit(sig))
        br.abort_probe(sig)
        out.append(br.admit(sig))
        for opens in range(6):
            out.append(br._cooldown_for(opens))
        return out
    port, ref = both(seq)
    assert port == ref
    assert port[2]["retry_after_s"] == 2.0
    assert port[-6:] == [1.0, 1.0, 2.0, 4.0, 8.0, 8.0]


def test_breaker_bounds_and_open_entry_survives_churn():
    def seq(P):
        clock = {"t": 0.0}
        br = breaker(P, 2, 100.0, clock)
        poison = "t/poison@sig"
        br.note_death(poison, "failed")
        br.note_death(poison, "hung")
        for i in range(br.MAX_ENTRIES + 100):
            br.note_death(f"t/churn@{i}", "failed")
            if i % 7 == 0:
                br.admit(poison)
        bounded = P.lg.QuarantineBreaker(failures=1, cooldown_s=1.0)
        for i in range(bounded.MAX_ENTRIES + 50):
            bounded.note_death(f"t/q@{i}", "failed")
        return [br.admit(poison), br.snapshot()["tracked"],
                bounded.snapshot()["tracked"]]
    port, ref = both(seq)
    assert port == ref
    assert port[0]["verdict"] == "refused"
    assert port[2] <= 2 * 512


def test_breaker_stale_half_open_probe_self_heals_and_disabled():
    def seq(P):
        clock = {"t": 0.0}
        br = breaker(P, 1, 1.0, clock)
        sig = "t/q@zzz"
        br.note_death(sig, "failed")
        clock["t"] = 1.5
        out = [br.admit(sig)]
        clock["t"] = 2.0
        out.append(br.admit(sig))
        clock["t"] = 62.5
        out.append(br.admit(sig))
        off = breaker(P, 0, 1.0, clock)
        out += [off.enabled, off.admit(sig), off.note_death(sig, "hung"),
                off.note_success(sig), off.snapshot()]
        return out
    port, ref = both(seq)
    assert port == ref
    assert [v["verdict"] for v in port[:3]] == ["probe", "refused",
                                                 "probe"]


def test_watchdog_swallows_scan_errors():
    def seq(P):
        calls = []

        def scan():
            calls.append(1)
            if len(calls) % 2:
                raise RuntimeError("scan bug")

        wd = P.lg.Watchdog(scan, 0.001).start()
        assert wait_for(lambda: len(calls) >= 6)
        wd.stop()
        snap = wd.snapshot()
        return [snap["interval_s"], snap["alive"],
                snap["scan_errors"] >= 3, snap["scans"] >= 6,
                wd.start() is wd, wd.stop()]
    port, ref = both(seq)
    assert port == ref == [0.01, False, True, True, True, None]


# --------------------------------------------- the server's lifeguard


def test_queued_deadline_expiry_is_not_a_quarantine_death():
    def seq(P):
        gate, started = threading.Event(), []

        def runner(query, params, ctx):
            started.append(query)
            while not gate.wait(0.005):
                ctx.check_cancel()
            return ["ok"]

        s = lifeguard_server(P, runner, hang_s=0, quarantine_failures=1,
                             cooldown_s=60.0)
        try:
            s.submit("t", "blocker")
            assert wait_for(lambda: started == ["blocker"])
            doomed = s.submit("t", "congested", {"k": 1},
                              deadline_s=0.05)
            out = [status(s.poll(doomed, timeout_s=20))]
            again = s.submit("t", "congested", {"k": 1})
            gate.set()
            out += [status(s.poll(again, timeout_s=20)),
                    s.stats()["lifeguard"]["quarantine"]]
            return out
        finally:
            gate.set()
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["error"]["reason"] == "deadline_expired_queued"
    assert port[1]["state"] == "done" and port[2]["quarantined"] == {}


def test_heartbeat_hook_released_with_the_last_server():
    def seq(P):
        base = P.lg._HOOK_INSTALLS
        s1 = lifeguard_server(P, lambda q, p, c: ["ok"], hang_s=0)
        s2 = lifeguard_server(P, lambda q, p, c: ["ok"], hang_s=0)
        out = [P.lg._HOOK_INSTALLS - base,
               P.obs._HEARTBEAT_HOOK is not None]
        s1.stop()
        out.append(P.obs._HEARTBEAT_HOOK is not None)
        s2.stop()
        out += [P.lg._HOOK_INSTALLS - base, P.obs._HEARTBEAT_HOOK is None]
        return out
    port, ref = both(seq)
    assert port == ref == [2, True, True, 0, True]


def test_watchdog_releases_a_hung_worker_and_the_pool_recovers(tmp_path):
    def seq(P):
        P.obs.enable()
        P.obs.reset()
        out_dir = tmp_path / P.name
        P.obs.enable_flight_recorder(out_dir=str(out_dir),
                                     min_interval_s=0.0)
        release, entered = threading.Event(), threading.Event()

        def runner(query, params, ctx):
            if query == "wedge":
                entered.set()
                release.wait(30)        # silent: no beat, no poll
                return ["late"]
            return ["ok", query]

        s = lifeguard_server(P, runner, hang_s=0.15)
        try:
            qid = s.submit("victim_tenant", "wedge", {"rows": 7})
            assert entered.wait(10)
            hung = status(s.poll(qid, timeout_s=20))
            silent = hung["error"].pop("silent_ms")
            nxt = status(s.poll(s.submit("neighbor", "fine"),
                                timeout_s=20))
            acts = records(P, "server_watchdog",
                           ("action", "tenant", "reason", "last_op"))
            release.set()
            assert wait_for(lambda: s.stats()["lifeguard"]
                            ["orphaned_workers"] == 0)
            late = status(s.poll(qid))
            counts = s.stats()["tenants"]["victim_tenant"]["hung"]
        finally:
            release.set()
            s.stop()
            P.obs.disable_flight_recorder()
        bundles = sorted(n for n in os.listdir(out_dir)
                         if n.startswith("incident-"))
        with open(out_dir / bundles[-1] / "trigger.json") as f:
            trig = json.load(f)
        d = trig["detail"]
        return [hung, silent >= 100, nxt, acts, late, counts,
                trig["kind"], trig["severity"], d["query"], d["tenant"],
                d["reason"], d["last_op"], d["quarantine"],
                d["silent_ms"] >= 100, bool(d["stack"])]
    port, ref = both(seq)
    assert port == ref
    assert port[0]["error"]["type"] == "QueryHung" and port[0]["hung"]
    assert port[2]["state"] == "done" and port[5] == 1
    assert port[6] == "query_hang" and port[8] == "wedge"


def test_a_hung_task_is_force_released_from_the_ledger():
    def seq(P):
        P.rmm.clear_event_handler()
        P.rmm.set_event_handler(1 << 20)
        release, held = threading.Event(), threading.Event()

        def runner(query, params, ctx):
            if query == "hog":
                P.rmm.get_adaptor().allocate(4096)
                held.set()
                release.wait(30)
                return ["late"]
            return ["ok"]

        s = lifeguard_server(P, runner, hang_s=0.15)
        try:
            qid = s.submit("piggy", "hog")
            assert held.wait(10)
            out = [s.poll(qid, timeout_s=20)["state"],
                   s.stats()["tenants"]["piggy"]["device_bytes"]]
            adaptor = P.rmm.installed_adaptor()
            out += [all(not t["pool_tasks"]
                        for t in adaptor.thread_state_dump()),
                    any("FORCE_RELEASE" in row for row in adaptor.get_log())]
            return out
        finally:
            release.set()
            s.stop()
            P.rmm.clear_event_handler()
    port, ref = both(seq)
    assert port == ref == ["failed", 0, True, True]


def test_adaptor_force_release_task_direct():
    def seq(P):
        P.rmm.clear_event_handler()
        P.rmm.set_event_handler(1 << 20)
        try:
            adaptor = P.rmm.get_adaptor()
            tid = P.rmm.current_thread_id()
            P.rmm.pool_thread_working_on_tasks(False, tid, [777001])
            adaptor.allocate(2048)
            info = adaptor.force_release_task(777001)
            adaptor.deallocate(2048)
            return [info["threads"] == [tid], info["held_bytes"],
                    all(777001 not in t["pool_tasks"]
                        for t in adaptor.thread_state_dump())]
        finally:
            P.rmm.clear_event_handler()
    port, ref = both(seq)
    assert port == ref == [True, 2048, True]


def test_poison_query_quarantined_then_a_probe_readmits():
    def seq(P):
        P.obs.enable()
        P.obs.reset()
        healthy = {"on": False}

        def runner(query, params, ctx):
            if query == "poison" and not healthy["on"]:
                raise P.exc.GpuSplitAndRetryOOM("still too big")
            return ["ok", query]

        s = lifeguard_server(P, runner, quarantine_failures=2,
                             cooldown_s=0.15)
        try:
            out = [status(s.poll(s.submit("acme", "poison", {"rows": 1}),
                                 timeout_s=20)) for _ in range(2)]
            with pytest.raises(P.server.ServerOverloaded) as ei:
                s.submit("acme", "poison", {"rows": 1})
            e = ei.value.to_dict()
            assert 0 < e.pop("retry_after_s") <= 0.15
            e.pop("message")
            out.append(e)
            out.append(status(s.poll(s.submit("acme", "poison",
                                              {"rows": 2}), timeout_s=20)))
            out.append(status(s.poll(s.submit("bravo", "fine"),
                                     timeout_s=20)))
            healthy["on"] = True
            time.sleep(0.2)
            out.append(status(s.poll(s.submit("acme", "poison",
                                              {"rows": 1}), timeout_s=20)))
            out.append(status(s.poll(s.submit("acme", "poison",
                                              {"rows": 1}), timeout_s=20)))
            out.append(s.stats()["lifeguard"]["quarantine"]["quarantined"])
            out.append(records(P, "server_quarantine",
                               ("event", "tenant", "query", "signature",
                                "strikes", "reason")))
            return out
        finally:
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[2]["reason"] == "quarantined"
    assert [r["event"] for r in port[-1]] == ["opened", "rejected",
                                               "probe", "closed"]


def test_a_failed_probe_reopens_with_an_escalated_cooldown():
    def seq(P):
        def runner(query, params, ctx):
            raise RuntimeError("always broken")

        s = lifeguard_server(P, runner, quarantine_failures=1,
                             cooldown_s=0.1)
        try:
            out = [status(s.poll(s.submit("t", "bad"), timeout_s=20))]
            with pytest.raises(P.server.ServerOverloaded):
                s.submit("t", "bad")
            time.sleep(0.15)
            out.append(status(s.poll(s.submit("t", "bad"),
                                     timeout_s=20)))
            with pytest.raises(P.server.ServerOverloaded) as ei:
                s.submit("t", "bad")
            out += [ei.value.reason, ei.value.retry_after_s > 0.1]
            return out
        finally:
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["error"] == {"type": "RuntimeError",
                                "message": "always broken"}
    assert port[2:] == ["quarantined", True]


# ----------------------------------------------------- the socket door


def test_socket_idle_timeout_answers_typed_and_closes(tmp_path):
    def seq(P):
        s = lifeguard_server(P, lambda q, p, c: ["ok"], hang_s=0)
        path = str(tmp_path / f"idle_{P.name}.sock")
        door = P.server.SocketFrontDoor(s, path, idle_s=0.2).start()
        try:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.connect(path)
            f = conn.makefile("rwb")
            f.write(b'{"op": "stats"')       # half a request, then quiet
            f.flush()
            conn.settimeout(5)
            out = [json.loads(f.readline()), f.readline()]
            conn.close()
            conn2 = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn2.connect(path)
            f2 = conn2.makefile("rwb")
            f2.write(json.dumps({"op": "stats"}).encode() + b"\n")
            f2.flush()
            out.append(json.loads(f2.readline())["ok"])
            conn2.close()
            return out
        finally:
            door.stop()
            s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["error"]["type"] == "IdleTimeout"
    assert port[1] == b"" and port[2] is True


def test_idle_timeout_knob_and_live_path_refusal(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_SERVER_SOCKET_IDLE_S", "7.5")

    def seq(P):
        s = lifeguard_server(P, lambda q, p, c: ["ok"], hang_s=0)
        path = str(tmp_path / f"live_{P.name}.sock")
        door = P.server.SocketFrontDoor(s, path).start()
        try:
            with pytest.raises(OSError) as ei:
                P.server.SocketFrontDoor(s, path).start()
            return [door.idle_s, "live server" in str(ei.value)]
        finally:
            door.stop()
            s.stop()
    port, ref = both(seq)
    assert port == ref == [7.5, True]


def test_socket_drain_op(tmp_path):
    def seq(P):
        s = lifeguard_server(P, lambda q, p, c: ["ok"], hang_s=0)
        path = str(tmp_path / f"drain_{P.name}.sock")
        door = P.server.SocketFrontDoor(s, path).start()
        try:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.connect(path)
            f = conn.makefile("rwb")
            f.write(json.dumps({"op": "drain",
                                "deadline_s": 5.0}).encode() + b"\n")
            f.flush()
            resp = json.loads(f.readline())
            f.write(json.dumps({"op": "submit", "tenant": "t",
                                "query": "q"}).encode() + b"\n")
            f.flush()
            resp2 = json.loads(f.readline())
            conn.close()
        finally:
            door.stop()
            if s._started:
                s.stop()
        rep = resp["report"]
        assert rep.pop("duration_s") >= 0
        return [resp["ok"], rep, resp2]
    port, ref = both(seq)
    assert port == ref
    assert port[1]["state"] == "drained"
    assert port[2]["error"]["type"] == "ServerOverloaded"


# --------------------------------------------------------------- drain


def test_drain_finishes_in_flight_refuses_new_and_reports(tmp_path):
    def seq(P):
        P.obs.enable()
        P.obs.reset()
        gate, started = threading.Event(), []

        def runner(query, params, ctx):
            started.append(query)
            while not gate.wait(0.005):
                ctx.check_cancel()
            return ["done", query]

        s = lifeguard_server(P, runner, concurrency=2, hang_s=0)
        box = {}
        try:
            a, b = s.submit("t", "a"), s.submit("t", "b")
            assert wait_for(lambda: len(started) == 2)
            dr = threading.Thread(target=lambda: box.setdefault(
                "r", s.drain(flush_dir=str(tmp_path / P.name))))
            dr.start()
            assert wait_for(lambda: s._draining)
            with pytest.raises(P.server.ServerOverloaded) as ei:
                s.submit("t", "late")
            refused = [ei.value.reason, ei.value.retry_after_s > 0]
            gate.set()
            dr.join(20)
        finally:
            gate.set()
            if "r" not in box:
                s.stop()
        r = box["r"]
        assert r.pop("duration_s") >= 0
        flush = r.pop("flush")
        files = sorted(os.listdir(flush["dir"]))
        out = [refused, r, files, status(s.poll(a)), status(s.poll(b)),
               sorted({e["phase"] for e in
                       P.obs.JOURNAL.records("server_drain")}),
               s._started]
        s.start()
        try:
            out.append(status(s.poll(s.submit("t", "after"),
                                     timeout_s=20))["state"])
        finally:
            gate.set()
            s.stop()
        return out
    port, ref = both(seq)
    assert port == ref
    assert port[0] == ["draining", True]
    assert port[1]["completed"] == 2 and port[1]["abandoned"] == 0
    assert port[2] == ["journal.jsonl", "metrics.json", "spans.jsonl"]
    assert port[-2:] == [False, "done"]


def test_drain_deadline_cancels_stragglers():
    def seq(P):
        stuck = threading.Event()

        def runner(query, params, ctx):
            stuck.set()
            while True:
                ctx.check_cancel()
                time.sleep(0.005)

        s = lifeguard_server(P, runner, hang_s=0, drain_deadline_s=0.2)
        try:
            qid = s.submit("t", "straggler")
            assert stuck.wait(10)
            r = s.drain()
            assert r.pop("duration_s") >= 0
            return [r, status(s.poll(qid)),
                    s.drain()]                # already stopped
        finally:
            if s._started:
                s.stop()
    port, ref = both(seq)
    assert port == ref
    assert port[0]["cancelled"] == 1 and port[0]["abandoned"] == 0
    assert port[1]["cancel_reason"] == "drain"
    assert port[2]["state"] == "stopped"


def test_drain_without_a_directory_skips_the_flush():
    def seq(P):
        s = lifeguard_server(P, lambda q, p, c: ["ok"], hang_s=0)
        r = s.drain(deadline_s=1.0)
        return r["flush"], r["state"]
    port, ref = both(seq)
    assert port == ref == ({"skipped": "no drain dir configured"},
                           "drained")


def test_module_level_drain_clears_the_singleton_and_restarts():
    def seq(P):
        srv, m = P.server, P.models
        m.register_query("lg_echo", lambda params, ctx: params.get("v"))
        try:
            cfg = dict(max_concurrency=1, max_queue=4, stall_ms=0)
            srv.start_server(srv.ServerConfig(**cfg))
            report = srv.drain_server(deadline_s=5.0)
            out = [report["state"], srv.get_server() is None,
                   srv.drain_server()]
            s2 = srv.start_server(srv.ServerConfig(**cfg))
            out.append(s2.poll(s2.submit("t", "lg_echo", {"v": 7}),
                               timeout_s=20)["result"])
            return out
        finally:
            srv.stop_server()
            m.unregister_query("lg_echo")
    port, ref = both(seq)
    assert port == ref == ["drained", True, {"state": "not_running"}, 7]


def test_drain_server_leaves_a_newer_servers_door_alone(tmp_path):
    def seq(P):
        srv = P.server
        cfg = dict(max_concurrency=1, max_queue=4, stall_ms=0)
        old = srv.QueryServer(srv.ServerConfig(**cfg),
                              runner=lambda q, p, c: ["ok"]).start()
        fresh = srv.QueryServer(srv.ServerConfig(**cfg),
                                runner=lambda q, p, c: ["ok"]).start()
        door = srv.SocketFrontDoor(
            fresh, str(tmp_path / f"fresh_{P.name}.sock")).start()
        with srv._LOCK:
            saved = srv._SERVER, srv._DOOR
            srv._SERVER, srv._DOOR = old, door
        try:
            report = srv.drain_server(deadline_s=5.0)
            return [report["state"], srv._DOOR is door,
                    door._sock is not None]
        finally:
            with srv._LOCK:
                srv._SERVER, srv._DOOR = saved
            door.stop()
            fresh.stop()
            if old._started:
                old.stop()
    port, ref = both(seq)
    assert port == ref == ["drained", True, True]


# --------------------------------------------------- the doctor's half


def hung_worker_bundle(P, out_dir):
    """A silent worker declared hung under an armed flight recorder; the
    query_hang bundle's path."""
    P.obs.enable()
    P.obs.reset()
    P.obs.enable_flight_recorder(out_dir=str(out_dir), min_interval_s=0.0)
    release, entered = threading.Event(), threading.Event()

    def runner(query, params, ctx):
        if query == "wedge":
            entered.set()
            release.wait(30)        # silent: no beat, no poll
            return ["late"]
        return ["ok", query]

    s = lifeguard_server(P, runner, hang_s=0.15)
    try:
        qid = s.submit("victim_tenant", "wedge", {"rows": 7})
        assert entered.wait(10)
        assert s.poll(qid, timeout_s=20)["state"] == "failed"
        release.set()
        assert wait_for(lambda: s.stats()["lifeguard"]
                        ["orphaned_workers"] == 0)
    finally:
        release.set()
        s.stop()
        P.obs.disable_flight_recorder()
    return str(out_dir)


def test_doctor_reads_the_hung_worker_bundle(tmp_path):
    """The doctor half of the reference's hung-worker case: each
    package's query_hang bundle, read by both packages' doctors, names
    the hung query and where its worker was stuck."""
    from spark_rapids_tpu.tools import doctor as JD
    from spark_rapids_tpu_torch.tools import doctor as PD
    for P in (PORT, JAX):
        out = hung_worker_bundle(P, tmp_path / P.name)
        bundles = PD.find_bundles(out)
        assert bundles and bundles == JD.find_bundles(out)
        b = PD.Bundle(bundles[-1])
        assert b.trigger["kind"] == "query_hang"
        detail = b.trigger["detail"]
        assert detail["query"] == "wedge"
        assert detail["tenant"] == "victim_tenant"
        assert detail["silent_ms"] >= 100
        findings = PD.analyze(b)
        assert findings == JD.analyze(JD.Bundle(bundles[-1]))
        hang = [f for f in findings if f["kind"] == "query_hang"]
        assert hang and "'wedge'" in hang[0]["message"]
        assert any(f["kind"] == "hung_stack" for f in findings)
