"""PyTorch port: the data-statistics plane (``observability/stats.py``)
and its taps in the stage compiler, the catalog and the parquet
reader, held against the JAX package's.

The sketches (KMV, heavy hitters, histogram, column stats) of the same
seeded values are equal in both packages, a FLOAT64 tensor included
(sketched through its bits, the form the JAX package stores it in).
The store's JSON, the collector's sections and misestimate events, the
compiler's tapped row counts (fused and op by op), the catalog's input
estimates and the parquet footer's source rows are equal too.
Tolerance: exact everywhere; the store's ``t`` wall-clock stamps and
the sketch nanoseconds are only required to be present and positive.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu.models import tpcds as JT
from spark_rapids_tpu.observability import stats as JS
from spark_rapids_tpu.plan import catalog as JCAT
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch.models import tpcds as TT
from spark_rapids_tpu_torch.observability import stats as S
from spark_rapids_tpu_torch.plan import catalog as TCAT
from torch_planes import isolate


@pytest.fixture(autouse=True)
def planes(monkeypatch, tmp_path):
    yield from isolate(monkeypatch, tmp_path)


def _values(kind, rows, seed):
    rng = np.random.default_rng(seed)
    if kind == "zipf":
        return np.minimum(rng.zipf(1.3, rows), 10_000).astype(np.int64)
    if kind == "uniform":
        return rng.integers(0, 1 << 40, rows).astype(np.int64)
    if kind == "small":
        return rng.integers(0, 9, rows).astype(np.int32)
    if kind == "float":
        v = rng.normal(size=rows)
        v[::17] = np.nan
        v[::23] = -0.0
        return v
    if kind == "bool":
        return rng.integers(0, 2, rows).astype(bool)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["zipf", "uniform", "small", "float",
                                  "bool"])
@pytest.mark.parametrize("rows", [0, 1, 5000, 70_000])
def test_column_stats_match_reference(kind, rows):
    a = _values(kind, rows, seed=rows + len(kind))
    got = S.column_stats(S.host_head(torch.from_numpy(a), 1 << 20),
                         kmv_k=512, hh_capacity=16, bins=8)
    # the JAX package stores FLOAT64 as its uint64 bit pattern
    ref_in = a.view(np.uint64) if a.dtype == np.float64 else a
    want = JS.column_stats(ref_in, kmv_k=512, hh_capacity=16, bins=8)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True)


def test_sketch_functions_match_reference():
    a = _values("zipf", 40_000, 1)
    for fn in ("kmv_sketch", "heavy_hitter_sketch", "histogram_sketch"):
        assert getattr(S, fn)(a) == getattr(JS, fn)(a), fn
    assert S.heavy_hitter_topk(S.heavy_hitter_sketch(a), 5) == \
        JS.heavy_hitter_topk(JS.heavy_hitter_sketch(a), 5)
    assert np.array_equal(S._hash64(a), JS._hash64(a))
    s = np.array(["x", "y", "x", "zz"])
    assert S.kmv_sketch(s) == JS.kmv_sketch(s)


def test_host_head_copies_only_the_cap():
    t = torch.arange(100, dtype=torch.int64)
    assert np.array_equal(S.host_head(t, 10), np.arange(10))
    f = torch.tensor([1.5, -0.0, float("nan")], dtype=torch.float64)
    h = S.host_head(f, 8)
    assert h.dtype == np.uint64
    assert h.tobytes() == f.numpy().tobytes()


def _store_seq(mod, path):
    store = mod.StatsStore(path_fn=lambda: path)
    e0, e1 = {"s": 0, "r": 0}, {"s": 1, "r": 0}
    out = [store.record("dig", "input:s", e0, 100,
                        sketch={"ndv": 7}),
           store.record("dig", "input:s", e0, 120),
           store.record("dig", "j", e1, 40),
           store.lookup("dig", "input:s", e0),
           store.lookup("dig", "input:s", e1)]
    store.reset()
    out.append(store.lookup("dig", "j", e1))      # from the file
    for rec in out:
        if rec is not None:
            assert rec.pop("t") > 0
    with open(path) as f:
        disk = json.load(f)
    for rec in disk.values():
        rec.pop("t")
    n = store.clear()
    return out, disk, n, store.lookup("dig", "j", e1)


def test_store_json_and_lookups_match_reference(tmp_path):
    port = _store_seq(S, str(tmp_path / "port.json"))
    ref = _store_seq(JS, str(tmp_path / "ref.json"))
    assert port == ref
    out, disk, n, after = port
    assert out[1] == {"rows": 120, "calls": 2, "sketch": {"ndv": 7}}
    assert sorted(disk) == ["dig|input:s|r:0,s:0", "dig|j|r:0,s:1"]
    assert n == 2 and after is None


def _collector_seq(mod, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STATS_MISEST_RATIO", "8")
    events = []
    c = mod.StatsCollector(
        on_observation=lambda st, n, m: events.append(
            ("obs", st, len(n), len(m))),
        on_misestimate=lambda **kw: events.append(("mis", kw)),
        on_sketch=lambda ns: events.append(("sketch", ns > 0)))
    c.enabled = True
    c.register_input_estimates("q5", {"s": 6000}, origin="catalog")
    c.register_estimate("q5", "j", 100_000, origin="manual")
    c.note_source_rows("r", 750)
    ob = {"stage": "q5", "plan_digest": "dig",
          "inputs": [{"name": "s", "rows": 1000},
                     {"name": "r", "rows": 700}],
          "nodes": [{"node": "f", "kind": "Project", "rows": 250},
                    {"node": "j", "kind": "JoinProbe", "rows": 40}]}
    cols = {"s": np.arange(1000, dtype=np.int64) % 97}
    sections = [c.note_stage(ob, columns=cols) for _ in range(2)]
    return sections, events, c.snapshot()


def test_collector_sections_and_sentinel_match_reference(monkeypatch):
    port = _collector_seq(S, monkeypatch)
    ref = _collector_seq(JS, monkeypatch)
    assert port == ref
    sections, events, snap = port
    by = {n["node"]: n for n in sections[0]["nodes"]}
    assert by["input:s"]["ndv"] == 97 and by["f"]["selectivity"] == round(250 / 1700, 6)
    assert by["input:r"]["est_origin"] == "parquet_footer"
    mis = [e[1] for e in events if e[0] == "mis"]
    assert [m["first"] for m in mis] == [True, False]
    assert [e for e in events if e[0] == "sketch"] == [("sketch", True)]
    assert snap["misestimates"] == 2


def _run_q5(cat, gen, **kw):
    d = gen(rows=2000, stores=16, days=60, **kw)
    return cat.run_q5(d, 16, 1 << 11)


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_compiler_taps_match_reference(fusion, monkeypatch):
    """The q5 stage path with stats on in both packages: the same
    per-node rows, estimates and store records; outputs unchanged."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", fusion)
    base = _run_q5(TCAT, TT.gen_q5, device="cpu")
    obs.enable_stats()
    jobs.enable_stats()
    got = _run_q5(TCAT, TT.gen_q5, device="cpu")
    # the reference op by op (its fused taps are the same counts)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    _run_q5(JCAT, JT.gen_q5)
    for g, b in zip(got, base):
        assert torch.equal(g, b)
    for stage in ("q5_partials", "q5_finish"):
        sec, jsec = obs.STATS.last(stage), jobs.STATS.last(stage)
        assert sec == jsec, stage
    nodes = obs.STATS.last("q5_partials")["nodes"]
    assert any(n["kind"] == "JoinProbe" for n in nodes)
    ins = {n["node"]: n for n in nodes if n["kind"] == "input"}
    assert ins["input:s"]["est"] == ins["input:s"]["rows"] == 2000
    snap, jsnap = obs.STATS.snapshot(), jobs.STATS.snapshot()
    assert snap["estimates"] == jsnap["estimates"]
    assert snap["observations"] == jsnap["observations"] > 0


def test_q3_and_q72_estimates_match_reference():
    obs.enable_stats()
    jobs.enable_stats()
    d3 = TT.gen_q3(rows=500, items=64, days=730, brands=16, seed=3,
                   device="cpu")
    jd3 = JT.gen_q3(rows=500, items=64, days=730, brands=16, seed=3)
    TCAT.run_q3(d3, 10_957, years=2, brands=16, manufact=3)
    JCAT.run_q3(jd3, 10_957, years=2, brands=16, manufact=3)
    d72 = TT.gen_q72(cs_rows=400, inv_rows=200, items=32, days=35,
                     device="cpu")
    jd72 = JT.gen_q72(cs_rows=400, inv_rows=200, items=32, days=35)
    TCAT.run_q72(d72, 32, 8, 1 << 14, week0=11_000 // 7)
    JCAT.run_q72(jd72, 32, 8, 1 << 14, week0=11_000 // 7)
    assert obs.STATS.snapshot()["estimates"] == \
        jobs.STATS.snapshot()["estimates"]
    assert set(obs.STATS.snapshot()["stages"]) >= {"q3", "q72_partials"}


def test_parquet_read_notes_footer_rows_and_ingest(tmp_path):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from spark_rapids_tpu.io import parquet_reader as JPR
    from spark_rapids_tpu.perf import result_cache as JRC
    from spark_rapids_tpu_torch.io import parquet_reader as PR
    from spark_rapids_tpu_torch.perf import result_cache as RC
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": np.arange(321, dtype=np.int64)}), path)
    obs.enable_stats()
    jobs.enable_stats()
    PR.read_table(path, device="cpu")
    JPR.read_table(path)
    assert obs.STATS.snapshot()["sources"] == \
        jobs.STATS.snapshot()["sources"] == \
        {path: {"rows": 321, "origin": "parquet_footer"}}
    PR.read_table(path, device="cpu")
    assert RC.ingest_epoch(path) == 1 == JRC.ingest_epoch(path)


def test_misestimate_freezes_one_incident_like_reference(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STATS_MISEST_RATIO", "2")
    for o in (obs, jobs):
        o.enable()
        o.enable_stats()
        o.enable_flight_recorder(out_dir=str(tmp_path / o.__name__),
                                 min_interval_s=0)
        o.STATS.register_estimate("stg", "j", 10_000)
        for _ in range(2):
            o.STATS.note_stage({"stage": "stg", "plan_digest": "d",
                                "inputs": [],
                                "nodes": [{"node": "j",
                                           "kind": "JoinProbe",
                                           "rows": 3}]})
    kinds = [[b["kind"] for b in o.FLIGHT.incident_list()]
             for o in (obs, jobs)]
    assert kinds[0] == kinds[1] == ["cardinality_misestimate"]
    for fam in ("srt_stats_misestimate_total",
                "srt_stats_observations_total"):
        assert obs.METRICS.family_snapshot(fam) == \
            jobs.METRICS.family_snapshot(fam), fam


def test_shim_stats_entries_match_reference():
    from spark_rapids_tpu.shim import jni_entry as JE
    from spark_rapids_tpu_torch.shim import jni_api, jni_entry
    assert jni_entry.stats_set_enabled(True) is True
    assert JE.stats_set_enabled(True) is True
    for o in (obs, jobs):
        o.STATS.register_input_estimates("q", {"s": 5})
    assert json.loads(jni_entry.stats_snapshot_json()) == \
        json.loads(JE.stats_snapshot_json())
    assert jni_api.stats_enabled() is True
    jni_entry.stats_store_clear()
    assert jni_entry.stats_set_enabled(False) is False
