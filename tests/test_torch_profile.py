"""PyTorch port: the query profiler (``observability/profile.py``), the
time-attribution ledger (``observability/attribution.py``) and the
cross-rank critical path (``observability/critical_path.py``), held
against the JAX package's.

The same ring records (task ops, journal events, registry counters)
go through a JAX profiler and a port profiler, and the same catalog
stages run under each package's profiler; the assembled profiles are
equal once their measured times are left out.  ``merge_profiles``,
``diff_profiles``, ``attribute_profile``, ``attribute_many``,
``diff_attribution``, ``hot_rank`` and ``critical_path`` give equal
results on the same inputs (the reference suites' fixtures).
Tolerance: exact everywhere, except wall, compile and assembly times
and wall-clock stamps, which must be present and non-negative.
"""

import copy
import json
import threading

import pytest

from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu.models import tpcds as JT
from spark_rapids_tpu.observability import attribution as JATT
from spark_rapids_tpu.observability import critical_path as JCP
from spark_rapids_tpu.observability import journal as JJ
from spark_rapids_tpu.observability import profile as JP
from spark_rapids_tpu.observability import registry as JREG
from spark_rapids_tpu.observability import task_metrics as JTM
from spark_rapids_tpu.plan import catalog as JCAT
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch.models import tpcds as TT
from spark_rapids_tpu_torch.observability import attribution as ATT
from spark_rapids_tpu_torch.observability import critical_path as CP
from spark_rapids_tpu_torch.observability import journal as J
from spark_rapids_tpu_torch.observability import profile as P
from spark_rapids_tpu_torch.observability import registry as REG
from spark_rapids_tpu_torch.observability import task_metrics as TM
from spark_rapids_tpu_torch.plan import catalog as TCAT
from test_attribution import synth_profile, two_rank_trace
from test_query_profile import _rank_profile
from torch_planes import isolate

PORT = (P, J, TM, REG)
REF = (JP, JJ, JTM, JREG)
# measured times: present, left out of the comparison
TIME_KEYS = {"t_unix_ms", "wall_ns", "t_start_ns", "t_end_ns",
             "compile_ns", "assembly_ns", "t_ns", "dur_ns", "lookup_ns",
             "mean_ns", "max_ns", "p50_ns"}


@pytest.fixture(autouse=True)
def planes(monkeypatch, tmp_path):
    yield from isolate(monkeypatch, tmp_path)


def untimed(x):
    """``x`` with every time-valued key dropped (checked non-negative)."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in TIME_KEYS:
                assert v is None or v >= 0, k
                continue
            out[k] = untimed(v)
        return out
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def isolated_profiler(mods):
    prof_mod, journal_mod, tasks_mod, reg_mod = mods
    journal = journal_mod.EventJournal(capacity=512)
    tasks = tasks_mod.TaskMetricsTable()
    registry = reg_mod.MetricsRegistry(enabled=True)
    prof = prof_mod.QueryProfiler(journal=journal, tasks=tasks,
                                  registry=registry)
    prof.enabled = True
    return prof, journal, tasks, registry


def _session(mods):
    prof, journal, tasks, registry = isolated_profiler(mods)
    tid = threading.get_ident()
    tasks.bind_thread(tid, [7])
    tasks.note_op("kudo_write", 1000)          # before the session
    tasks.fold_rmm_task(7, retry_oom=2, blocked_time_ns=100)
    links = registry.counter("srt_shuffle_link_bytes_total", "",
                             labels=("direction", "peer"))
    jit = registry.counter("srt_jit_cache_misses_total", "",
                           labels=("kernel",))
    links.inc(50, labels=("send", "1"))
    sess = prof.begin("q-1", query="q5", tenant="acme", rank=0, world=2)
    tasks.note_op("kudo_write", 200)
    tasks.note_op("kudo_write", 300)
    tasks.note_op("join", 50)
    tasks.fold_rmm_task(7, retry_oom=3, blocked_time_ns=400)
    links.inc(700, labels=("send", "1"))
    links.inc(650, labels=("recv", "1"))
    jit.inc(labels=("stage.q5",))
    journal.emit("retry_episode", name="x", attempts=3, retries=2,
                 lost_ns=77, thread=tid)
    journal.emit("oom", event="retry", thread=tid)
    prof.note_stage({"stage": "s1", "digest": "d", "engine": "fused",
                     "compiled": True, "compile_ns": 5, "wall_ns": 90,
                     "t_start_ns": 10, "t_end_ns": 100,
                     "dispatches": 1, "nodes_total": 3, "nodes": [],
                     "inputs": []})
    prof.note_stage({"stage": "s1", "digest": "d", "engine": "fused",
                     "compiled": False, "compile_ns": 0, "wall_ns": 60,
                     "t_start_ns": 110, "t_end_ns": 170,
                     "dispatches": 1, "nodes_total": 3, "nodes": [],
                     "inputs": []})
    p = prof.end(sess)
    nested = prof.begin("q-2")
    dropped = prof.begin("q-3")               # nested: dropped
    prof.end(nested)
    return p, dropped, prof.stats(), prof.last()["query_id"]


def test_profile_from_the_same_records_matches_reference():
    port, ref = _session(PORT), _session(REF)
    assert untimed(port[0]) == untimed(ref[0])
    assert port[1:] == ref[1:]
    p = port[0]
    assert p["ops"] == {"kudo_write": {"calls": 2, "time_ns": 500},
                        "join": {"calls": 1, "time_ns": 50}}
    assert p["hot_stage"] == "s1" and p["stages"][0]["calls"] == 2


def test_retention_and_noop_match_reference():
    def seq(mods):
        prof_mod, journal_mod, tasks_mod, reg_mod = mods
        prof = prof_mod.QueryProfiler(
            journal=journal_mod.EventJournal(capacity=64),
            tasks=tasks_mod.TaskMetricsTable(),
            registry=reg_mod.MetricsRegistry(enabled=True), keep=2)
        prof.enabled = True
        ids = []
        for i in range(4):
            prof.end(prof.begin(f"q{i}"))
            ids.append([p["query_id"] for p in prof.retained()])
        prof.enabled = False
        return ids, prof.begin("off"), prof.active()
    assert seq(PORT) == seq(REF)


def _q3_profile(o, cat, gen, **kw):
    o.enable()
    o.enable_profiling()
    o.enable_stats()
    d = gen(rows=1500, items=64, days=730, brands=8, **kw)
    sess = o.PROFILER.begin("q", query="q3")
    cat.run_q3(d, 10_957, years=3, brands=8, manufact=2)
    cat.run_q3(d, 10_957, years=3, brands=8, manufact=2)
    return o.PROFILER.end(sess)


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_compiler_stage_records_match_reference(fusion, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", fusion)
    got = _q3_profile(obs, TCAT, TT.gen_q3, device="cpu")
    want = _q3_profile(jobs, JCAT, JT.gen_q3)
    (s,), (w,) = got["stages"], want["stages"]
    for rec in (s, w):
        assert rec.pop("wall_ns") > 0
        rec.pop("digest")          # operand digests name the dtypes
    assert untimed(s) == untimed(w)
    assert s["calls"] == 2
    assert s["engine"] == ("fused" if fusion == "1" else "unfused")
    facts = [i for i in s["inputs"] if i["name"] == "s"]
    assert facts[0] == {"name": "s", "rows": 1500, "bucket": 2048,
                        "pad_rows": 548}
    assert s["stats"]["nodes"]


def test_auto_calibration_records_one_engine(monkeypatch):
    """'auto' measures both engines once for a (plan, shapes, device),
    caches the verdict and records the winner; outputs equal both
    pinned engines'."""
    from spark_rapids_tpu_torch.perf import calibrate as CAL
    d = TT.gen_q3(rows=700, items=64, days=730, brands=8, device="cpu")
    outs = {}
    for mode in ("0", "1", ""):
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", mode)
        outs[mode] = TCAT.run_q3(d, 10_957, years=3, brands=8,
                                 manufact=2)
    for a, b, c in zip(outs["0"], outs["1"], outs[""]):
        assert a.dtype == c.dtype and (a == c).all() and (b == c).all()
    obs.enable()
    TCAT.run_q3(d, 10_957, years=3, brands=8, manufact=2)
    recs = [r for r in obs.JOURNAL.records()
            if r["kind"] == "stage_fusion"]
    assert recs and recs[-1]["outcome"] in ("fused", "unfused")
    verdicts = [k for k in CAL._PROC_CACHE if k[0] == "stage:q3"]
    assert len(verdicts) == 1


def test_merge_and_diff_match_reference():
    cases = [
        [_rank_profile(0, {"q5_partials": 100, "q5_finish": 10}),
         _rank_profile(1, {"q5_partials": 400, "q5_finish": 10})],
        [_rank_profile(0, {"s": 1}, trace="aaa"),
         _rank_profile(1, {"s": 2}, trace="bbb")],
        [_rank_profile(0, {"s": 1}, trace=None),
         _rank_profile(1, {"s": 2}, trace=None)],
        [_rank_profile(0, {"s": 1}, links={
            "bytes": {"send": {"1": 700}, "recv": {"1": 700}}}),
         _rank_profile(1, {"s": 1}, links={
             "bytes": {"send": {"0": 700}, "recv": {"0": 700}}})],
        [_rank_profile(0, {"s": 5})],
    ]
    for profiles in cases:
        assert P.merge_profiles(copy.deepcopy(profiles)) == \
            JP.merge_profiles(copy.deepcopy(profiles))
    merged = P.merge_profiles(cases[0])
    assert merged["stages"][0]["per_rank_wall_ns"] == {"0": 100,
                                                       "1": 400}
    base = _rank_profile(0, {"a": 10_000_000, "b": 10_000_000})
    cur = _rank_profile(0, {"a": 40_000_000, "b": 11_000_000,
                            "new": 99_000_000})
    for kw in ({}, {"threshold": 1.05}, {"min_delta_ns": 0},
               {"threshold": 1.5, "min_delta_ns": 20_000_000}):
        assert P.diff_profiles(base, cur, **kw) == \
            JP.diff_profiles(base, cur, **kw)
    with pytest.raises(ValueError):
        P.merge_profiles([])


LEDGER_CASES = [
    dict(fused=100_000_000),
    dict(queue_wait=5_000_000, fused=80_000_000, unfused=20_000_000,
         compile_ns=30_000_000, wire=4_000_000, wait=6_000_000,
         spec=1_000_000, blocked=2_000_000, lost=3_000_000),
    dict(fused=10, blocked=50, lost=50),
    dict(fused=1_000, extra_wall=900_000),
]


@pytest.mark.parametrize("case", range(len(LEDGER_CASES)))
@pytest.mark.parametrize("tolerance", [0.0, 0.25])
def test_attribution_ledgers_match_reference(case, tolerance):
    prof = synth_profile(**LEDGER_CASES[case])
    got = ATT.attribute_profile(copy.deepcopy(prof), tolerance=tolerance)
    want = JATT.attribute_profile(copy.deepcopy(prof),
                                  tolerance=tolerance)
    assert got == want
    assert set(got["buckets"]) == set(ATT.BUCKETS) == set(JATT.BUCKETS)


def test_fleet_rollup_diff_and_hot_rank_match_reference():
    profs = [synth_profile(fused=100, wire=50, rank=0),
             synth_profile(fused=100, wire=900, rank=1),
             synth_profile(fused=100, wire=10, rank=1)]
    got = ATT.attribute_many(copy.deepcopy(profs))
    want = JATT.attribute_many(copy.deepcopy(profs))
    assert got == want
    assert ATT.hot_rank(got) == JATT.hot_rank(want)
    assert ATT.hot_rank(got, "shuffle_wire") == \
        JATT.hot_rank(want, "shuffle_wire")
    base = ATT.attribute_profile(synth_profile(fused=100_000_000))
    cur = ATT.attribute_profile(synth_profile(fused=100_000_000,
                                              wait=90_000_000))
    assert ATT.diff_attribution(base, cur) == \
        JATT.diff_attribution(base, cur) != []


@pytest.mark.parametrize("skew", [0, 5_000_000_000, -5_000_000_000])
def test_critical_paths_match_reference(skew):
    got = CP.critical_path(two_rank_trace(skew_ns=skew))
    want = JCP.critical_path(two_rank_trace(skew_ns=skew))
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    assert got["clamped_edges"] == 0 and got["path"]
    slow = two_rank_trace()
    for s in slow[0]:
        if s["name"] in ("merge0", "finish0"):
            s["t_ns"] += 300_000
    assert CP.critical_path(copy.deepcopy(slow)) == \
        JCP.critical_path(copy.deepcopy(slow))
    assert CP.critical_path({})["path"] == []


def test_profile_end_attaches_attribution_like_reference():
    res = []
    for o in (obs, jobs):
        o.enable()
        o.enable_profiling()
        o.enable_attribution()
        sess = o.PROFILER.begin("q-a", query="q", tenant="acme")
        o.PROFILER.note_stage({"stage": "s", "digest": "d",
                               "engine": "fused", "compiled": False,
                               "compile_ns": 0, "wall_ns": 10,
                               "t_start_ns": 0, "t_end_ns": 10,
                               "dispatches": 1, "nodes_total": 1,
                               "nodes": [], "inputs": []})
        p = o.PROFILER.end(sess)
        led = o.attribution_last()
        assert p["attribution"] is led
        res.append((sorted(led), sorted(led["buckets"]),
                    [r["kind"] for r in o.JOURNAL.records()],
                    sorted(o.METRICS.family_snapshot(
                        "srt_profile_queries_total")["series"][0][
                            "labels"])))
    assert res[0] == res[1]


def test_shim_profile_entries_match_reference():
    from spark_rapids_tpu.shim import jni_entry as JE
    from spark_rapids_tpu_torch.shim import jni_api, jni_entry
    for e in (jni_entry, JE):
        assert e.profile_set_enabled(True) is False
        assert e.attribution_set_enabled(True) is False
        assert e.profile_last_json() == ""
        assert e.attribution_last_json() == ""
    for o in (obs, jobs):
        o.PROFILER.end(o.PROFILER.begin("q-s", query="q"))
    port = json.loads(jni_entry.profile_last_json())
    ref = json.loads(JE.profile_last_json())
    # the ledger's buckets hold the measured wall
    assert sorted(port.pop("attribution")) == \
        sorted(ref.pop("attribution"))
    assert untimed(port) == untimed(ref)
    assert sorted(json.loads(jni_api.attribution_last_json())) == \
        sorted(json.loads(JE.attribution_last_json()))
    for e in (jni_entry, JE):
        assert e.profile_enabled() and e.attribution_enabled()
        assert e.profile_set_enabled(False) is True
        assert e.attribution_set_enabled(False) is True


def test_observability_plane_rehearsal_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's observability_plane phase end to end on CPU
    tensors at small sizes, op by op: outputs equal with the plane off
    and on, each q5 stage profiled, ledgers conserved, the critical
    path covering the query, every counter's windows summing to the
    registry, the stage cache hitting once per stage, the incremental
    q5 folding two batches, and two incident bundles."""
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    res = C.observability_plane_phase(
        "cpu", q5=dict(rows=1 << 12, stores=16, join_capacity=1 << 13),
        flagship_rows=1 << 10, fusion="0")
    pr, sc = res["profiled"], res["stage_cache"]
    assert pr["critical_path"]["path"] == ["exchange_capacity_retry"]
    assert pr["counters_conserved"] > 0 and pr["windows"] >= 1
    assert sc["hit_counts"] == {"hits": 2, "misses": 0, "puts": 0}
    assert sc["incremental_folds"] == 2
    assert res["incidents"]["kinds"] == ["kudo_corrupt",
                                         "retry_exhausted"]
    assert not obs.is_profiling_enabled() and not obs.FLIGHT.enabled
