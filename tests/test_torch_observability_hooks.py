"""PyTorch port: the observability hooks in the port's layers, held
against the JAX package's on one seeded scenario per layer.

Each case runs the same calls through both packages with metrics and
tracing on, then compares:

  * ``expose_text()``: every line equal, except the time-valued
    families (``TIME_FAMILIES``), whose series must exist in both and
    whose counters are positive;
  * the journal's record counts by kind;
  * the span trees: (name, kind, parent's name, attributes without the
    time-valued ones, link count), never ids or times.

The op brackets both ops layers open around every public op
(``span_kind="op"`` spans and ``srt_op_latency_ns``) are compared like
any other record.  What only the JAX package records is left out and
named here: the compile-cache events of the programs it compiles per
row bucket (off here through ``SPARK_RAPIDS_TPU_JIT_CACHE=0``; the port
runs those ops eagerly and takes no cache entry for them).

Every test starts with the Monitor's liveness stamp cleared in both
packages and no Monitor thread left running (``both_on``), and the
incident and profile cases arm fresh flight recorders.
"""

import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu_torch import observability as obs
from test_torch_memory import JAX, PORT, TaskThread, outcome, wait_parked
from torch_port_data import host_column, jax_table, port_table

# families whose values are wall or CPU times measured at run time
TIME_FAMILIES = {
    "srt_shuffle_write_time_ns_total", "srt_shuffle_merge_time_ns_total",
    "srt_span_duration_ns", "srt_retry_time_lost_ns_total",
    "srt_spill_ns_total", "srt_thread_blocked_time_ns_total",
    "srt_io_read_ns", "srt_io_decode_ns_total",
    "srt_shuffle_wire_ns_total", "srt_shuffle_wait_ns_total",
    "srt_monitor_last_sample_age_s", "srt_profile_assembly_ns",
    "srt_attribution_ns_total", "srt_jit_compile_ns",
    "srt_stats_sketch_ns", "srt_timeseries_tick_ns", "srt_op_latency_ns",
}
# span attributes holding times
TIME_ATTRS = {"lost_ns", "wall_ns"}


def stop_stray_monitors():
    """Stop every telemetry Monitor thread an earlier test in this
    process left running: its next sample would stamp the package's
    ``_LAST_MONITOR_SAMPLE`` in the middle of a comparison."""
    from spark_rapids_tpu.utils import telemetry as JT
    from spark_rapids_tpu_torch.utils import telemetry as PT
    for t in threading.enumerate():
        owner = getattr(getattr(t, "_target", None), "__self__", None)
        if isinstance(owner, (JT.Monitor, PT.Monitor)):
            owner.stop()


@pytest.fixture(autouse=True)
def both_on(monkeypatch, tmp_path):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_JIT_CACHE", "0")
    # the Monitor's liveness stamp is process state that reset() keeps:
    # a Monitor an earlier test ran leaves it set in one package only
    stop_stray_monitors()
    for m in (obs, jobs):
        monkeypatch.setattr(m, "_LAST_MONITOR_SAMPLE", None)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CALIB_CACHE",
                       str(tmp_path / "calib.json"))
    from spark_rapids_tpu.perf import calibrate as JCAL
    from spark_rapids_tpu_torch.perf import calibrate as CAL
    CAL.forget()
    JCAL.forget()
    priors = [(m, m.is_enabled(), m.is_tracing_enabled())
              for m in (obs, jobs)]
    for m, _, _ in priors:
        m.enable()
        m.enable_tracing()
        m.reset()
    yield
    for m, on, tr in priors:
        m.reset()
        (m.enable if on else m.disable)()
        (m.enable_tracing if tr else m.disable_tracing)()


def _family(name):
    base = name.split("{")[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if base.endswith(suffix) and base[:-len(suffix)] in TIME_FAMILIES:
            return base[:-len(suffix)], suffix
    return base, ""


def exposition(o):
    """(exact lines, time-valued series -> value) of one package."""
    exact, timed = [], {}
    for ln in o.expose_text().splitlines():
        if ln.startswith("#"):
            exact.append(ln)
            continue
        key, value = ln.rsplit(" ", 1)
        fam, suffix = _family(key)
        if fam in TIME_FAMILIES and suffix != "_count":
            timed[key] = float(value)
        else:
            exact.append(ln)
    return exact, timed


def journal_kinds(o):
    out = {}
    for r in o.JOURNAL.records():
        out[r["kind"]] = out.get(r["kind"], 0) + 1
    return out


def span_tree(o):
    recs = o.TRACER.records()
    by_id = {r["span_id"]: r for r in recs}

    def parent_name(r):
        p = by_id.get(r["parent_id"])
        if p is not None:
            return p["name"]
        return "<outside>" if r["parent_id"] else None

    tree = []
    for r in recs:
        attrs = {k: v for k, v in (r.get("attrs") or {}).items()
                 if k not in TIME_ATTRS}
        tree.append((r["name"], r["span_kind"], parent_name(r),
                     json.dumps(attrs, sort_keys=True),
                     len(r.get("links", ()))))
    return sorted(tree)


def assert_same_observations(expect_kinds=()):
    port, ref = exposition(obs), exposition(jobs)
    assert port[0] == ref[0]
    assert sorted(port[1]) == sorted(ref[1])
    for key, v in port[1].items():
        fam, suffix = _family(key)
        if fam.endswith("_total"):
            assert v > 0, key
    kinds = journal_kinds(obs)
    assert kinds == journal_kinds(jobs)
    for k in expect_kinds:
        assert kinds.get(k, 0) > 0, k
    assert obs.JOURNAL.dropped == 0
    tree = span_tree(obs)
    assert tree == span_tree(jobs)
    return kinds, tree


# --------------------------------------------------------------- memory


def oom_scenario(M):
    """Forced retry and split on task 1, then task 2 blocks until task
    1 frees: every adaptor hook (OOM events, block episode, device
    memory gauge) fires once or more."""
    a = M.sra.SparkResourceAdaptor(M.res.LimitingMemoryResource(1000))
    t1 = TaskThread(a, task_id=1)
    t2 = TaskThread(a, task_id=2)
    obs_ = []
    a.force_retry_oom(t1.ident, 1)
    obs_.append(outcome(t1.do(lambda: a.allocate(100))))
    a.force_split_and_retry_oom(t1.ident, 1)
    obs_.append(outcome(t1.do(lambda: a.allocate(100))))
    t1.do(lambda: a.allocate(800)).result(10)
    fut = t2.do(lambda: a.allocate(800))
    wait_parked(a, t2.ident)
    t1.do(lambda: a.deallocate(800)).result(10)
    obs_.append(outcome(fut))
    t2.do(lambda: a.deallocate(800)).result(10)
    a.task_done(1)
    a.task_done(2)
    t1.done()
    t2.done()
    a.shutdown()
    return obs_


def test_adaptor_oom_retry_split_and_block():
    assert oom_scenario(PORT) == oom_scenario(JAX) == \
        ["GpuRetryOOM", "GpuSplitAndRetryOOM", "ok"]
    kinds, tree = assert_same_observations(
        ("oom_retry", "oom_split_retry", "thread_blocked",
         "thread_unblocked"))
    assert ("oom_blocked", "oom", None, json.dumps(
        {"device": "device", "injected": False, "task_id": 2},
        sort_keys=True), 0) in tree
    assert "srt_device_memory_allocated_bytes 0" in exposition(obs)[0]


def test_task_leak_is_recorded_at_task_done():
    def leak(M):
        a = M.sra.SparkResourceAdaptor(M.res.LimitingMemoryResource(1000))
        t = TaskThread(a, task_id=5)
        t.do(lambda: a.allocate(300)).result(10)
        a.task_done(5)
        t.done()
        a.shutdown()

    leak(PORT)
    leak(JAX)
    assert_same_observations(("memory_leak",))
    assert "srt_memory_leaked_bytes_total 300" in exposition(obs)[0]


def test_facade_binds_and_folds_the_task_table():
    def facade(M):
        M.rmm.set_event_handler(1000)
        try:
            M.rmm.current_thread_is_dedicated_to_task(42)
            g = M.rmm.get_adaptor()
            g.allocate(100)
            g.deallocate(100)
            M.rmm.task_done(42)
        finally:
            M.rmm.clear_event_handler()

    facade(PORT)
    facade(JAX)
    assert_same_observations(("task_done",))
    want = {k: v for k, v in jobs.TASKS.rollup()[42].items()
            if not k.endswith("time_ns")}
    got = {k: v for k, v in obs.TASKS.rollup()[42].items()
           if not k.endswith("time_ns")}
    assert got == want and got["max_device_memory"] == 100
    assert obs.TASKS.bound_threads() == {}


def _spill(store_cls, cols, tmp, tier_of):
    store = store_cls(spill_dir=str(tmp))
    h = store.register(cols, name="batch", task_id=3, stage="q5")
    h.spill()
    assert tier_of(h) == "host"
    store._host_limit = 0
    store._enforce_host_limit()
    assert tier_of(h) == "disk"
    back = h.get()
    h.close()
    store.close()
    return back


def test_spill_to_host_and_disk_and_back(tmp_path):
    from spark_rapids_tpu.memory import spill as JS
    from spark_rapids_tpu_torch.memory import spill as PS
    rng = np.random.default_rng(16)
    specs = [host_column(rng, k, 300, nullable=True)
             for k in ("int64", "float64", "string")]
    _spill(PS.SpillStore, port_table(specs).columns, tmp_path / "p",
           lambda h: h.tier)
    _spill(JS.SpillStore, jax_table(specs).columns, tmp_path / "j",
           lambda h: h.tier)
    kinds, _ = assert_same_observations(("spill", "spill_restore",
                                         "spill_wait"))
    assert kinds["spill"] == 2
    port = exposition(obs)[0]
    assert 'srt_spill_restores_total{stage="q5",tier="disk"} 1' in port


# ---------------------------------------------------------------- retry


def test_retry_episodes_and_spans():
    from spark_rapids_tpu.memory import exceptions as jexc
    from spark_rapids_tpu.robustness import retry as JR
    from spark_rapids_tpu_torch.memory import exceptions as pexc
    from spark_rapids_tpu_torch.robustness import retry as PR

    def episodes(R, ex, o):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise ex.GpuRetryOOM("injected")
            return 7

        def split_once(part):
            if len(part) > 2:
                raise ex.GpuSplitAndRetryOOM("injected")
            return sum(part)

        with o.TRACER.span("query", kind="query"):
            a = R.with_retry(flaky, name="flaky")
            b = R.split_and_retry(split_once, [1, 2, 3, 4],
                                  combine=sum, name="halves")
            c = R.with_retry(lambda: 1, name="clean")
        return a, b, c

    assert episodes(PR, pexc, obs) == episodes(JR, jexc, jobs) == (7, 10, 1)
    kinds, tree = assert_same_observations(("retry_episode",))
    assert kinds["retry_episode"] == 2
    names = [t[0] for t in tree]
    assert "retry_episode:flaky" in names and \
        "retry_episode:clean" not in names


def test_link_retry_and_fleet_membership():
    from spark_rapids_tpu.robustness import fleet as JF
    from spark_rapids_tpu.robustness import links as JL
    from spark_rapids_tpu.robustness.retry import RetryPolicy as JPol
    from spark_rapids_tpu_torch.robustness import fleet as PF
    from spark_rapids_tpu_torch.robustness import links as PL
    from spark_rapids_tpu_torch.robustness.retry import RetryPolicy

    def drive(L, F, Pol):
        tries = {"n": 0}

        def attempt():
            tries["n"] += 1
            if tries["n"] < 3:
                raise L.ShuffleLinkError("nak", reason="nak")
            return 5

        pol = Pol(max_attempts=5, base_backoff_s=0.0)
        assert L.with_link_retry(attempt, peer=1, policy=pol) == 5
        fleet = F.ElasticFleet(0, 3)
        assert fleet.note_death([2])
        assert fleet.note_join(2)
        assert fleet.note_leave(1)
        fleet.learn_epoch(9)
        return fleet.epoch

    assert drive(PL, PF, RetryPolicy) == drive(JL, JF, JPol) == 9
    kinds, _ = assert_same_observations(("shuffle_link_retry",
                                         "retry_episode",
                                         "fleet_membership"))
    text = exposition(obs)[0]
    assert "srt_fleet_epoch 9" in text
    assert 'srt_shuffle_link_retries_total{peer="1",reason="nak"} 2' \
        in text


# -------------------------------------------------------- kudo and KTRX


def _kudo_specs(seed=11, rows=257):
    rng = np.random.default_rng(seed)
    return [host_column(rng, k, rows, nullable=True)
            for k in ("int64", "int32", "float64", "string", "bool8")]


def test_kudo_ktrx_bytes_equal_the_reference():
    """Under the same activated SpanContext the port's kudo stream is
    byte-equal to the JAX stream, and equal to the untraced stream with
    the 20-byte KTRX prefix in front."""
    from spark_rapids_tpu.shuffle import kudo as JK
    from spark_rapids_tpu_torch.shuffle import kudo as PK
    specs = _kudo_specs()
    pcols, jcols = port_table(specs).columns, jax_table(specs).columns
    ctx = (0x1122334455667788, 0x99AABBCCDDEEFF01)
    streams = []
    for o, K, cols in ((obs, PK, pcols), (jobs, JK, jcols)):
        plain = io.BytesIO()
        o.disable_tracing()
        K.write_to_stream(cols, plain, 5, 200)
        o.enable_tracing()
        traced = io.BytesIO()
        with o.TRACER.activate(o.SpanContext(*ctx)):
            n = K.write_to_stream(cols, traced, 5, 200)
        assert n == len(traced.getvalue())
        streams.append((plain.getvalue(), traced.getvalue()))
    (p_plain, p_traced), (j_plain, j_traced) = streams
    assert p_traced == j_traced
    assert p_plain == j_plain
    assert p_traced == b"KTRX" + ctx[0].to_bytes(8, "big") + \
        ctx[1].to_bytes(8, "big") + p_plain


def test_kudo_write_merge_and_resync():
    from spark_rapids_tpu.shuffle import kudo as JK
    from spark_rapids_tpu.shuffle.schema import schema_of_table as jschema
    from spark_rapids_tpu_torch.shuffle import kudo as PK
    from spark_rapids_tpu_torch.shuffle.schema import schema_of_table
    specs = _kudo_specs(12)

    def drive(o, K, table, schema, merge_kw):
        buf = io.BytesIO()
        with o.TRACER.span("map_task", kind="stage"):
            for off in (0, 100, 200):
                K.write_to_stream_with_metrics(table.columns, buf, off,
                                               min(100, 257 - off))
        blob = bytearray(buf.getvalue())
        tables = K.read_tables(io.BytesIO(bytes(blob)))
        merged = {}

        def reader():    # a remote reader with no span of its own
            t, _m = K.merge_to_table_with_metrics(
                tables, schema(table), **merge_kw)
            merged["rows"] = t.num_rows

        th = threading.Thread(target=reader)
        th.start()
        th.join(30)
        # resync: the second table's magic smashed, the salvage mode
        # skips to the next table
        second = len(blob) // 3 + 25
        at = bytes(blob).index(b"KUD0", second - 40)
        blob[at] ^= 0xFF
        salvaged = K.read_tables(io.BytesIO(bytes(blob)), resync=True)
        return merged["rows"], len(salvaged)

    got = drive(obs, PK, port_table(specs), schema_of_table,
                {"device": "cpu"})
    want = drive(jobs, JK, jax_table(specs), jschema, {})
    assert got == want == (257, 2)
    kinds, tree = assert_same_observations(
        ("shuffle_write", "shuffle_merge", "kudo_corrupt"))
    assert kinds["shuffle_write"] == 3
    merge = [t for t in tree if t[0] == "kudo_merge"]
    assert merge == [("kudo_merge", "shuffle_merge", "kudo_write",
                      json.dumps({"rows": 257, "tables": 3},
                                 sort_keys=True), 3)]


# ------------------------------------------------------------- exchange


def test_exchange_doubling():
    from spark_rapids_tpu.parallel import exchange as JX
    from spark_rapids_tpu_torch.parallel import exchange as PX

    def drive(X):
        def make_step(cap):
            return lambda need: (cap, np.asarray([need > cap]))

        run = X.with_capacity_retry(make_step, 2)
        with pytest.raises(X.CapacityExceeded):
            X.with_capacity_retry(make_step, 2, max_doublings=1)(100)
        return run(9)

    got, want = drive(PX), drive(JX)
    assert got[1] == want[1] == 16
    kinds, tree = assert_same_observations(
        ("exchange_capacity_doubling", "exchange_capacity_exceeded",
         "retry_episode"))
    assert "srt_exchange_capacity_doublings_total 4" in exposition(obs)[0]
    assert sum(t[0] == "exchange_capacity_retry" for t in tree) == 2


# ------------------------------------------------------------------- io


def test_parquet_read(tmp_path):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from spark_rapids_tpu.io import parquet_reader as JPR
    from spark_rapids_tpu_torch.io import parquet_reader as PPR
    rng = np.random.default_rng(13)
    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({
        "a": pa.array(rng.integers(-1000, 1000, 3000), pa.int64()),
        "b": pa.array(rng.random(3000)),
        "s": pa.array([f"s{i % 17}" for i in range(3000)])}),
        path, row_group_size=1000, compression="NONE")
    got = PPR.read_table(path, device="cpu")
    want = JPR.read_table(path)
    assert got.num_rows == want.num_rows == 3000
    kinds, tree = assert_same_observations(("io_read", "io_file"))
    assert [t[0] for t in tree] == ["io_read"]
    text = exposition(obs)[0]
    assert "srt_io_files_total 1" in text and "srt_io_rows_total 3000" \
        in text


# ---------------------------------------------------- kernel paths


def test_join_and_json_engine_paths():
    from spark_rapids_tpu.ops import joins as JJ
    from spark_rapids_tpu.ops import json_path as JP
    from spark_rapids_tpu_torch.ops import joins as PJ
    from spark_rapids_tpu_torch.ops import json_path as PP
    from torch_port_data import strings_spec, values_spec
    keys_l = values_spec("int64", [1, 2, 3, 2, None, 7])
    keys_r = values_spec("int64", [2, 3, 9, None])
    docs = strings_spec(['{"a": 1}', '{"a": {"b": 2}}', None, "bad"])
    got = PJ.sort_merge_inner_join(port_table([keys_l]),
                                   port_table([keys_r]))
    want = JJ.sort_merge_inner_join(jax_table([keys_l]),
                                    jax_table([keys_r]))
    assert [np.asarray(g).tolist() for g in got] == \
        [np.asarray(w).tolist() for w in want]
    pj = PP.get_json_object(port_table([docs]).columns[0], "$.a")
    jj = JP.get_json_object(jax_table([docs]).columns[0], "$.a")
    assert pj.to_pylist() == jj.to_pylist()
    assert_same_observations(("kernel_path",))
    text = exposition(obs)[0]
    assert 'srt_kernel_path_total{op="join.inner",path="host_rank"} 1' \
        in text
    assert 'srt_kernel_path_total{op="get_json_object",path="host"} 1' \
        in text


def test_star_join_query_span():
    from spark_rapids_tpu.models import query as JQ
    from spark_rapids_tpu_torch.models import query as PQ
    fact = [values_spec_("int32", [1, 2, 2, 3, 4]),
            values_spec_("int64", [10, 20, 30, 40, 50])]
    dim = [values_spec_("int32", [1, 2, 3]),
           values_spec_("int32", [7, 8, 7])]
    got = PQ.simple_star_join_agg(port_table(fact), port_table(dim))
    want = JQ.simple_star_join_agg(jax_table(fact), jax_table(dim))
    assert got.num_rows == want.num_rows == 2
    _, tree = assert_same_observations(("kernel_path",))
    assert ("simple_star_join_agg", "query", None, "{}", 0) in tree


def values_spec_(kind, values):
    from torch_port_data import values_spec
    return values_spec(kind, values)


def test_calibration_journal():
    from spark_rapids_tpu.perf import calibrate as JCAL
    from spark_rapids_tpu_torch.perf import calibrate as CAL
    cands = {"a": lambda: 1, "b": lambda: 2}
    CAL.pick_path("t.op", "d0", cands, "a", device="cpu")
    JCAL.pick_path("t.op", "d0", cands, "a")
    recs = [obs.JOURNAL.records("kernel_calibrated"),
            jobs.JOURNAL.records("kernel_calibrated")]
    assert [len(r) for r in recs] == [1, 1]
    for r in recs:
        assert r[0]["op"] == "t.op" and r[0]["verdict"] in cands
        assert set(r[0]["timings_us"]) == {"a", "b"}
    assert recs[0][0]["backend"] == "torch-cpu"


def test_stage_fusion_record_op_by_op(monkeypatch):
    """An op-by-op stage run records its outcome by stage name in both
    packages; the fused engine's compile span is held on the card."""
    import jax.numpy as jnp

    from spark_rapids_tpu.plan import compiler as JC
    from spark_rapids_tpu.plan import ir as JIR
    from spark_rapids_tpu_torch.plan import compiler as C
    from spark_rapids_tpu_torch.plan import ir as IR
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    outs = []
    for M, comp, arr in ((IR, C, torch.arange(6)),
                         (JIR, JC, jnp.arange(6))):
        plan = M.StagePlan(
            "tiny_double", inputs=(M.ScanBind("t", (M.ColSpec("x"),)),),
            nodes=(M.Project("y", M.Bin("mul", M.Col("x"), M.Lit(2))),),
            outputs=("y",))
        outs.append(np.asarray(comp.compile_stage(plan).run(
            {"t": (arr,)})[0]).tolist())
    assert outs[0] == outs[1] == [0, 2, 4, 6, 8, 10]
    assert_same_observations(("stage_fusion",))
    assert 'srt_stage_fusion_total{stage="tiny_double",' \
        'outcome="unfused"} 1' in exposition(obs)[0]
    (rec,) = obs.JOURNAL.records("stage_fusion")
    assert rec["nodes"] == 1 and rec["compiled"] is False


def test_observability_phase_rehearsal_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's observability phase end to end on CPU tensors at
    small sizes: outputs equal with observability off and on, each
    traced kudo table the untraced bytes behind its KTRX prefix, the
    counters equal to the known counts, one span tree, both dumps
    parsed, the Monitor sampling."""
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    res = C.observability_phase("cpu", flagship_rows=1 << 10,
                                shuffle_rows=1 << 12, task_rows=3000,
                                iters=1)
    assert res["on"]["merged_rows"] == res["off"]["merged_rows"] == 1 << 12
    assert res["on"]["tasks"]["forced_split"]["split_retries"] == 1
    assert res["journal_by_kind"]["shuffle_write"] == 2 * 200
    assert res["samples"] >= 2 and res["hbm_worst_rel_diff"] == 0
    assert obs.is_enabled() and obs.is_tracing_enabled()   # restored
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "observability"))


# ------------------------------------------- incidents and profiles


def _arm_flight(monkeypatch, tmp_path):
    from spark_rapids_tpu.observability import flight_recorder as JFR
    from spark_rapids_tpu_torch.observability import flight_recorder as FR
    for o, fr in ((obs, FR), (jobs, JFR)):
        monkeypatch.setattr(o, "FLIGHT", fr.FlightRecorder(
            enabled=True, out_dir=str(tmp_path / o.__name__),
            min_interval_s=0.0))


def test_incident_triggers(monkeypatch, tmp_path):
    """retry_exhausted, kudo_corrupt, fleet_incident and lockdep_cycle
    each freeze one bundle in both packages, with the same trigger
    detail and the same observations."""
    from spark_rapids_tpu.analysis import lockdep as JLD
    from spark_rapids_tpu.columns import dtypes as jdt
    from spark_rapids_tpu.columns.column import Column as JCol
    from spark_rapids_tpu.memory import exceptions as jexc
    from spark_rapids_tpu.robustness import fleet as JF
    from spark_rapids_tpu.robustness import retry as JR
    from spark_rapids_tpu.shuffle import kudo as JK
    from spark_rapids_tpu_torch.analysis import lockdep as LD
    from spark_rapids_tpu_torch.columns import dtypes as pdt
    from spark_rapids_tpu_torch.columns.column import Column as PCol
    from spark_rapids_tpu_torch.memory import exceptions as pexc
    from spark_rapids_tpu_torch.robustness import fleet as PF
    from spark_rapids_tpu_torch.robustness import retry as PR
    from spark_rapids_tpu_torch.shuffle import kudo as PK
    _arm_flight(monkeypatch, tmp_path)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_LOCKDEP", "1")

    def drive(o, R, ex, K, column, dt, F, LDm):
        def oom():
            raise ex.GpuRetryOOM("injected")

        with pytest.raises(R.RetryExhausted):
            R.with_retry(oom, name="fr_probe",
                         policy=R.RetryPolicy(max_attempts=2,
                                              base_backoff_s=0.0))
        prior = K.set_crc_enabled(True)
        try:
            buf = io.BytesIO()
            K.write_to_stream([column([1, 2, 3], dt.INT64)], buf, 0, 3)
            raw = bytearray(buf.getvalue())
            raw[-10] ^= 0xFF
            with pytest.raises(K.KudoCorruptException):
                K.read_one_table(io.BytesIO(bytes(raw)))
        finally:
            K.set_crc_enabled(prior)
        F.ElasticFleet(0, 3).note_death([2])
        LDm.reset()
        a, b = LDm.make_lock("t.a"), LDm.make_lock("t.b")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        LDm.reset()
        out = []
        for inc in sorted(o.FLIGHT.incident_list(),
                          key=lambda i: i["path"]):
            with open(os.path.join(inc["path"], "trigger.json")) as f:
                trig = json.load(f)
            detail = trig["detail"]
            detail.pop("evidence", None)      # acquisition stacks
            detail.pop("lost_ns", None)
            out.append((inc["kind"], inc["severity"], detail,
                        [c["type"] for c in trig["cause_chain"]]))
        return out

    port = drive(obs, PR, pexc, PK,
                 lambda v, t: PCol.from_pylist(v, t, device="cpu"), pdt,
                 PF, LD)
    ref = drive(jobs, JR, jexc, JK, JCol.from_pylist, jdt, JF, JLD)
    assert port == ref
    assert [k for k, *_ in port] == ["retry_exhausted", "kudo_corrupt",
                                     "fleet_incident", "lockdep_cycle"]
    assert port[0][3] == ["RetryExhausted", "GpuRetryOOM"]
    assert port[3][2]["cycle"] in (["t.a", "t.b"], ["t.b", "t.a"],
                                   ["t.a", "t.b", "t.a"],
                                   ["t.b", "t.a", "t.b"])
    assert_same_observations(("retry_episode",))
    assert 'srt_incidents_total{trigger="retry_exhausted"} 1' in \
        exposition(obs)[0]


def test_stage_profile_records(monkeypatch):
    """A stage run inside a profiled query adds one stage record to its
    profile in both packages, and the profile's end records a
    query_profile journal event."""
    import jax.numpy as jnp

    from spark_rapids_tpu.plan import compiler as JC
    from spark_rapids_tpu.plan import ir as JIR
    from spark_rapids_tpu_torch.plan import compiler as C
    from spark_rapids_tpu_torch.plan import ir as IR
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    stages = []
    for o, M, comp, arr in ((obs, IR, C, torch.arange(6)),
                            (jobs, JIR, JC, jnp.arange(6))):
        monkeypatch.setattr(o.PROFILER, "enabled", True)
        plan = M.StagePlan(
            "tiny_prof", inputs=(M.ScanBind("t", (M.ColSpec("x"),)),),
            nodes=(M.Project("y", M.Bin("mul", M.Col("x"), M.Lit(3))),
                   M.Project("p", M.Bin("gt", M.Col("y"), M.Lit(4)))),
            outputs=("y", "p"))
        sess = o.PROFILER.begin("q-prof", query="tiny", tenant="acme")
        comp.compile_stage(plan).run({"t": (arr,)})
        prof = o.PROFILER.end(sess)
        (s,) = prof["stages"]
        assert s.pop("wall_ns") > 0
        for k in ("t_start_ns", "t_end_ns", "compile_ns", "digest"):
            s.pop(k, None)
        stages.append((s, prof["hot_stage"]))
    assert stages[0] == stages[1]
    assert stages[0][0]["engine"] == "unfused"
    assert stages[0][0]["dispatches"] == 2
    kinds, _tree = assert_same_observations(("query_profile",
                                             "stage_fusion"))
    assert kinds["query_profile"] == 1


# ---------------------------------------------------------- query server


def server_hooks(o):
    """Every record_server_* hook once or more, with fixed values."""
    o.record_server_admit("acme", "tpcds_q9", "q-000001", 1)
    o.record_server_admit("bravo", "tpcds_q3", "q-000002", 2)
    o.record_server_reject("acme", "tpcds_q9", "queue_full", 0.03)
    o.record_server_dequeue("acme", "q-000001", 1_500_000)
    o.record_server_requeue("acme", "q-000001", "GpuRetryOOM", 1)
    o.record_server_complete("acme", "tpcds_q9", "q-000001", "success",
                             2_000_000, 1_500_000)
    o.record_server_complete("bravo", "tpcds_q3", "q-000002", "hung",
                             9_000_000, 0)
    o.record_server_watchdog("hang_release", "bravo", "q-000002",
                             query="tpcds_q3", reason="heartbeat_silent",
                             silent_ms=2040, last_op="job_start",
                             task_id=1_000_002)
    o.record_server_watchdog("deadline_cancel", "acme", "q-000003",
                             query="tpcds_q5")
    o.record_server_quarantine("opened", "bravo", "tpcds_q3", "bravo/x@1",
                               strikes=2, reason="hung",
                               retry_after_s=30.0)
    o.record_server_quarantine("rejected", "bravo", "tpcds_q3",
                               "bravo/x@1", strikes=2, retry_after_s=29.5)
    o.record_server_drain("begin", in_flight=2, deadline_s=30.0)
    o.record_server_drain("end", in_flight=2, completed=2, cancelled=0,
                          abandoned=0, duration_s=0.5)
    o.set_server_tenant_gauges({"acme": 1, "bravo": 0}, {"acme": 2},
                               {"acme": 0.25, "bravo": 0.0},
                               {"acme": 4096})


def test_server_hooks_record_like_the_reference():
    server_hooks(obs)
    server_hooks(jobs)
    kinds, _tree = assert_same_observations(
        ("server_admit", "server_reject", "server_dequeue",
         "server_requeue", "server_complete", "server_watchdog",
         "server_quarantine", "server_drain"))
    assert kinds["server_complete"] == 2
    text = exposition(obs)[0]
    for line in ('srt_server_rejected_total{tenant="acme",'
                 'reason="queue_full"} 1',
                 'srt_server_completed_total{tenant="bravo",'
                 'outcome="hung"} 1',
                 'srt_server_watchdog_total{action="hang_release"} 1',
                 'srt_server_quarantine_total{event="opened"} 1',
                 'srt_server_drain_total{phase="end"} 1',
                 'srt_server_fair_share_deficit{tenant="acme"} 0.25',
                 'srt_server_tenant_device_bytes{tenant="acme"} 4096'):
        assert line in text, line
    def watchdog_records(o):
        return [{k: v for k, v in r.items() if k != "t_ns"}
                for r in o.JOURNAL.records("server_watchdog")]
    assert watchdog_records(obs) == watchdog_records(jobs)


def test_server_hooks_cost_nothing_when_off():
    for o in (obs, jobs):
        o.disable()
        o.reset()
        server_hooks(o)
        assert o.JOURNAL.records() == []
        assert "srt_server_admitted_total{" not in o.expose_text()


def test_server_completions_feed_the_slo_first():
    """record_server_complete feeds the SLO monitor under its own switch
    (metrics off here): one event a completion, latency = wait + run."""
    statuses = []
    for o in (obs, jobs):
        o.disable()
        o.reset()
        o.SLO.reset()
        o.enable_slo()
        try:
            for outcome, dur in (("success", 1_000_000),
                                 ("success", 10_000_000_000),
                                 ("failed", 1_000), ("cancelled", 1_000),
                                 ("cache_hit", 0)):
                o.record_server_complete("acme", "q", "q-1", outcome,
                                         dur, 5_000)
            statuses.append(o.SLO.status())
            assert o.JOURNAL.records() == []
        finally:
            o.disable_slo()
            o.SLO.reset()
    assert statuses[0] == statuses[1]
    assert statuses[0]["acme"]["events"] == 3


def test_scripted_server_run_records_like_the_reference(monkeypatch):
    """A gated two-tenant run with a typed rejection, a load-shed requeue
    and a cancel: the same journal kinds, families and span tree (the
    queue-wait histogram and the deficit gauge hold times)."""
    import time

    import test_torch_lifeguard as LG
    monkeypatch.setattr(
        __import__(__name__), "TIME_FAMILIES",
        TIME_FAMILIES | {"srt_server_queue_wait_ns",
                         "srt_server_fair_share_deficit"})

    def run(P):
        gate, started, tries = threading.Event(), [], {}

        def runner(query, params, ctx):
            started.append(query)
            tries[query] = tries.get(query, 0) + 1
            if query == "oom" and tries[query] == 1:
                raise P.exc.GpuRetryOOM("shed me")
            while not gate.wait(0.005):
                ctx.check_cancel()
            return [query]

        cfg = P.server.ServerConfig(max_concurrency=1, max_queue=2,
                                    stall_ms=0, max_requeues=1)
        s = P.server.QueryServer(cfg, runner=runner).start()
        try:
            first = s.submit("acme", "blocker")
            assert LG.wait_for(lambda: started == ["blocker"])
            victim = s.submit("acme", "victim")
            oom = s.submit("bravo", "oom")
            try:
                s.submit("bravo", "over")
            except P.server.ServerOverloaded:
                pass
            s.cancel(victim)
            gate.set()
            for qid in (first, oom):
                assert s.poll(qid, timeout_s=20)["state"] == "done"
        finally:
            gate.set()
            s.stop()
            time.sleep(0.01)

    run(LG.PORT)
    run(LG.JAX)
    kinds, tree = assert_same_observations(
        ("server_admit", "server_reject", "server_requeue",
         "server_complete", "server_cancel"))
    # blocker, and oom's two attempts (the victim was cancelled queued)
    assert sum(1 for t in tree if t[0].startswith("server_query:")) == 3


# ------------------------------------------------------------- op layer


def test_op_brackets_record_like_the_reference():
    """The op layer's brackets: the same public ops called directly, on
    a task thread, and through the JVM door give the same op spans (name
    and parent), the same ``srt_op_latency_ns`` sample counts per op and
    the same per-task op counts in both packages."""
    from spark_rapids_tpu.shim import jni_api as JAPI
    from spark_rapids_tpu_torch.shim import jni_api as PAPI
    rng = np.random.default_rng(19)
    specs = [host_column(rng, k, 200, nullable=True)
             for k in ("int64", "int32", "float64")]

    def run(o, ops, rc, api, table, dtype):
        with o.TRACER.span("op_query", kind="query"):
            t = table(specs)
            ops.murmur3_32(t, 42)
            ops.xxhash64(t)
            ops.hive_hash(t)
            rows = rc.convert_to_rows(t)
            rc.convert_from_rows(rows, [c.dtype for c in t.columns])
        o.TASKS.bind_thread(threading.get_ident(), [5])
        try:
            ops.murmur3_32(table(specs), 7)
        finally:
            o.TASKS.unbind_thread(threading.get_ident())
        h = api.make_column_from_host([1, 2, 3], dtype)
        api.murmur_hash3_32(42, [h])
        api.release_column(h)

    from spark_rapids_tpu import ops as jops
    from spark_rapids_tpu.columns import dtypes as JD
    from spark_rapids_tpu.ops import row_conversion as jrc
    from spark_rapids_tpu_torch import ops as pops
    from spark_rapids_tpu_torch.columns import dtypes as PD
    from spark_rapids_tpu_torch.ops import row_conversion as prc

    def port_api_column(values, dtype):
        return PAPI.make_column_from_host(values, dtype, device="cpu")

    run(obs, pops, prc, type("A", (), {
        "make_column_from_host": staticmethod(port_api_column),
        "murmur_hash3_32": staticmethod(PAPI.murmur_hash3_32),
        "release_column": staticmethod(PAPI.release_column)}),
        port_table, PD.INT32)
    run(jobs, jops, jrc, JAPI, jax_table, JD.INT32)

    def observed(o):
        recs = o.TRACER.records()
        by_id = {r["span_id"]: r for r in recs}
        spans = sorted(
            (r["name"], (by_id.get(r["parent_id"]) or {}).get("name", "-"))
            for r in recs if r["span_kind"] == "op")
        counts = sorted(ln for ln in o.expose_text().splitlines()
                        if ln.startswith("srt_op_latency_ns_count"))
        ops_by_task = {t: {op: v["calls"] for op, v in
                               (row.get("ops") or {}).items()}
                       for t, row in o.TASKS.rollup().items()}
        return spans, counts, ops_by_task

    port, ref = observed(obs), observed(jobs)
    assert port == ref
    spans, counts, _ = port
    assert ("convert_to_rows", "op_query") in spans
    assert spans.count(("murmur3_32", "-")) == 2
    assert 'srt_op_latency_ns_count{op="murmur3_32"} 3' in counts
