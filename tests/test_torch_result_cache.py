"""PyTorch port: the semantic result cache (``perf/result_cache.py``),
its ingest epochs, the stage cache in ``CompiledPipeline.run`` and the
incremental q5/q72 runners, held against the JAX package's.

The same calls go through both packages; their hit, miss, put, fold
and eviction counts are equal, and so are the rows the incremental
queries return, cold (cache off), warm and after epoch bumps.  Digests
are not compared: the port hashes FLOAT64 as its int64 bits, the JAX
package as its stored uint64 words.  The spill-store residency cases
(disk second life, cache evicted before query batches) run on the
port's own store.  Tolerance: exact everywhere; lookup nanoseconds are
only required to be positive.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_tpu import models as JM
from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu.perf import result_cache as JRC
from spark_rapids_tpu.plan import catalog as JCAT
from spark_rapids_tpu.plan import compiler as JPC
from spark_rapids_tpu_torch import models as TM
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch.memory import spill as spill_mod
from spark_rapids_tpu_torch.perf import result_cache as RC
from spark_rapids_tpu_torch.plan import catalog as TCAT
from spark_rapids_tpu_torch.plan import compiler as PC
from torch_planes import isolate

COUNTS = ("hits", "misses", "puts", "folds", "evictions", "entries",
          "by_scope")


@pytest.fixture(autouse=True)
def planes(monkeypatch, tmp_path):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_RESULT_CACHE", "1")
    gen = isolate(monkeypatch, tmp_path)
    next(gen)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_RESULT_CACHE", "1")
    yield
    next(gen, None)


def counts(cache):
    st = cache.stats()
    return {k: st[k] for k in COUNTS}


def both(fn):
    """fn(result_cache module) for the port and the reference."""
    return fn(RC), fn(JRC)


def test_ingest_epoch_fingerprint_semantics_match_reference():
    def seq(rc):
        src = "t_epoch_src"
        out = [rc.ingest_epoch(src), rc.note_ingest(src, "a"),
               rc.note_ingest(src, "a"), rc.note_ingest(src, "b"),
               rc.note_ingest(src), rc.bump_ingest_epoch(src),
               rc.bump_ingest_epoch(src, 3),
               rc.epoch_vector([src, "other"])]
        rc.reset_ingest_epochs()
        return out + [rc.ingest_epoch(src)]
    port, ref = both(seq)
    assert port == ref == [0, 1, 1, 2, 3, 4, 7, (7, 0), 0]


def test_result_scope_sequence_matches_reference():
    def seq(rc):
        src = "t_epoch_inval"
        rc.register_cache_spec("q_epoch", shared=True, sources=(src,))
        rc.register_cache_spec("q_private", shared=False)
        try:
            got = []
            rc.CACHE.store_result("a", "q_epoch", {"x": 1}, [1, 2, 3])
            got.append(rc.CACHE.lookup_result("a", "q_epoch", {"x": 1}))
            got.append(rc.CACHE.lookup_result("b", "q_epoch", {"x": 1}))
            got.append(rc.CACHE.lookup_result("a", "q_epoch", {"x": 2}))
            rc.bump_ingest_epoch(src)
            got.append(rc.CACHE.lookup_result("a", "q_epoch", {"x": 1}))
            rc.CACHE.store_result("alice", "q_private", {"k": 1},
                                  ["alice-secret"])
            got.append(rc.CACHE.lookup_result("bob", "q_private",
                                              {"k": 1}))
            got.append(rc.CACHE.lookup_result("alice", "q_private",
                                              {"k": 1}))
            got.append(rc.CACHE.store_result("a", "no_such_query", {},
                                             [1]))
            got.append(rc.CACHE.lookup_result("a", "no_such_query", {}))
            return [g[0] if isinstance(g, tuple) else g for g in got], \
                counts(rc.CACHE), rc.CACHE.stats()["bytes"]
        finally:
            rc.unregister_cache_spec("q_epoch")
            rc.unregister_cache_spec("q_private")
    port, ref = both(seq)
    assert port == ref
    values, c, _b = port
    assert values == [[1, 2, 3], [1, 2, 3], None, None, None,
                      ["alice-secret"], False, None]
    assert (c["hits"], c["misses"], c["puts"]) == (3, 3, 2)
    assert RC.CACHE.stats()["lookup_ns_total"] > 0


def test_entry_budget_eviction_matches_reference():
    def seq(rc):
        cache = rc.ResultCache(max_entries=2)
        rc.register_cache_spec("q_lru", shared=True)
        try:
            for i in range(4):
                cache.store_result("t", "q_lru", {"i": i}, [i] * 8)
            hits = [cache.lookup_result("t", "q_lru", {"i": i})[0]
                    for i in range(4)]
            return hits, counts(cache)
        finally:
            rc.unregister_cache_spec("q_lru")
    port, ref = both(seq)
    assert port == ref
    assert port[0] == [None, None, [2] * 8, [3] * 8]
    assert port[1]["evictions"] == 2


def test_catalog_specs_match_reference():
    for name in TM.catalog_queries():
        spec, jspec = RC.cache_spec(name), JRC.cache_spec(name)
        assert (spec is None) == (jspec is None), name
        if spec is not None:
            assert (spec.shared, spec.sources, spec.source_param) == \
                (jspec.shared, jspec.sources, jspec.source_param)
    assert RC.cache_spec("tpcds_q7_file") is None
    assert RC.cache_spec("tpcds_q5_incremental").sources_for(
        {"source": "s1"}) == ("s1",)


def test_data_digest_keys_by_content():
    a = [torch.arange(8, dtype=torch.int64)]
    assert RC.data_digest(a) == RC.data_digest(
        [np.arange(8, dtype=np.int64)])
    assert RC.data_digest(a) != RC.data_digest([a[0] + 1])
    assert RC.data_digest(a) != RC.data_digest([a[0].to(torch.int32)])
    assert RC.data_digest(a) != RC.data_digest([a[0].reshape(2, 4)])
    z = torch.tensor([0.0, 1.5], dtype=torch.float64)
    nz = torch.tensor([-0.0, 1.5], dtype=torch.float64)
    assert RC.data_digest([z]) != RC.data_digest([nz])
    assert RC.data_digest([z]) == RC.data_digest([z.clone()])


def test_fold_partials_matches_reference():
    rng = np.random.default_rng(3)
    state = [rng.integers(-50, 50, 16), rng.integers(0, 2, 16) > 0]
    delta = [rng.integers(-50, 50, 16), rng.integers(0, 2, 16) > 0]
    got = RC.fold_partials([torch.from_numpy(a) for a in state],
                           [torch.from_numpy(a) for a in delta],
                           or_indices=(-1,))
    want = JRC.fold_partials(state, delta, or_indices=(-1,))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def _q5_inputs(rows, seed):
    from spark_rapids_tpu.models import tpcds as JT
    from spark_rapids_tpu_torch.models import tpcds as TT
    d = TT.gen_q5(rows=rows, stores=8, days=60, seed=seed, device="cpu")
    jd = JT.gen_q5(rows=rows, stores=8, days=60, seed=seed)
    return d, jd


def test_stage_cache_hits_once_per_stage_with_same_bytes(monkeypatch):
    """The q5 pipeline twice through each package with the cache armed:
    the second run hits once per stage and returns the first's bytes."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    d, jd = _q5_inputs(600, 11)
    outs = {}
    for name, cat, comp, dd, rc in (("port", TCAT, PC, d, RC),
                                    ("ref", JCAT, JPC, jd, JRC)):
        pipe = comp.compile_pipeline(cat.q5_pipeline(8, 1 << 12))
        args = {"s": (dd.s_date, dd.s_store, dd.s_price, dd.s_profit),
                "r": (dd.r_date, dd.r_store, dd.r_amt, dd.r_loss),
                "d": (dd.d_date,), "dims": (dd.st_id,)}
        first = pipe.run(args)
        after_first = counts(rc.CACHE)
        second = pipe.run(args)
        outs[name] = (first, second, after_first, counts(rc.CACHE))
    first, second, c1, c2 = outs["port"]
    assert c1 == outs["ref"][2] and c2 == outs["ref"][3]
    assert (c1["misses"], c1["puts"], c1["hits"]) == (2, 2, 0)
    assert (c2["hits"], c2["puts"]) == (2, 2)
    assert c2["by_scope"] == {"stage": 2}
    for a, b, w in zip(first, second, outs["ref"][1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.device.type == "cpu"
        assert a.numpy().tobytes() == np.asarray(w).tobytes()


def test_cached_stage_reports_a_cached_profile_record(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    d, _jd = _q5_inputs(300, 12)
    st = PC.compile_stage(TCAT.q5_partials_plan(8, 1 << 12))
    args = {"s": (d.s_date, d.s_store, d.s_price, d.s_profit),
            "r": (d.r_date, d.r_store, d.r_amt, d.r_loss),
            "d": (d.d_date,)}
    obs.enable_profiling()
    sess = obs.PROFILER.begin("q-cached", query="q5")
    RC.CACHE.stage_run(st, args)
    RC.CACHE.stage_run(st, args)
    prof = obs.PROFILER.end(sess)
    engines = [s["engine"] for s in prof["stages"]]
    assert sorted(engines) == ["cached", "unfused"]


INCREMENTAL = [
    ("tpcds_q5_incremental",
     {"rows": 256, "stores": 8, "seed": 5, "source": "t_q5_stream"}),
    ("tpcds_q72_incremental",
     {"rows": 256, "items": 32, "max_week": 8, "seed": 72,
      "source": "t_q72_stream"}),
]


@pytest.mark.parametrize("query,params", INCREMENTAL,
                         ids=[q for q, _ in INCREMENTAL])
def test_incremental_rows_match_reference_cold_warm_and_bumped(
        query, params, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    src = params["source"]
    for e in range(3):
        if e:
            RC.bump_ingest_epoch(src)
            JRC.bump_ingest_epoch(src)
        warm = TM.run_catalog_query(query, dict(params, device="cpu"))
        ref = JM.run_catalog_query(query, dict(params))
        monkeypatch.setenv("SPARK_RAPIDS_TPU_RESULT_CACHE", "0")
        try:
            cold = TM.run_catalog_query(query, dict(params, device="cpu"))
        finally:
            monkeypatch.setenv("SPARK_RAPIDS_TPU_RESULT_CACHE", "1")
        assert json.dumps(warm) == json.dumps(cold) == json.dumps(ref), e
    # each new epoch folded exactly one delta batch into the state
    assert counts(RC.CACHE) == counts(JRC.CACHE)
    assert RC.CACHE.stats()["folds"] == 2


def test_eviction_to_disk_restores_byte_identical(tmp_path):
    store = spill_mod.install(spill_mod.SpillStore(
        spill_dir=str(tmp_path / "spill"), host_limit_bytes=0))
    try:
        arrays = [torch.arange(64, dtype=torch.int64),
                  torch.tensor([True, False, True]),
                  torch.linspace(0.0, 1.0, 17, dtype=torch.float64),
                  torch.tensor(7, dtype=torch.int32)]
        key = ("t_disk", 1)
        RC.CACHE.put_subplan(key, arrays, {"upto": 3})
        assert store.ensure_headroom(1 << 30) > 0
        assert store.stats()["spills_disk"] >= 1
        meta, back = RC.CACHE.get_subplan(key)
        assert meta["upto"] == 3
        for a, b in zip(arrays, back):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
    finally:
        spill_mod.uninstall()
        store.close()


def test_pressure_evicts_cache_before_query_batches(tmp_path):
    from spark_rapids_tpu_torch.columns import dtypes
    from spark_rapids_tpu_torch.columns.column import Column
    store = spill_mod.install(spill_mod.SpillStore(
        spill_dir=str(tmp_path / "spill")))
    try:
        query_h = store.register(
            [Column(dtypes.INT64, 256,
                    data=torch.arange(256, dtype=torch.int64))],
            device_bytes=2048, name="query_batch", task_id=7,
            stage="q5_join")
        key = ("t_prio", 1)
        RC.CACHE.put_subplan(key, [torch.arange(256, dtype=torch.int64)])
        cache_h = RC.CACHE._entries[(RC.SCOPE_SUBPLAN,) + key].handle
        assert cache_h.priority == RC.CACHE_PRIORITY == 0
        assert cache_h.priority < query_h.priority
        assert store.ensure_headroom(cache_h.device_bytes) >= \
            cache_h.device_bytes
        assert cache_h.tier != spill_mod.TIER_DEVICE
        assert query_h.tier == spill_mod.TIER_DEVICE
        got = RC.CACHE.get_subplan(key)
        assert torch.equal(got[1][0], torch.arange(256, dtype=torch.int64))
        query_h.close()
    finally:
        spill_mod.uninstall()
        store.close()


def test_cache_records_match_reference():
    for o, rc in ((obs, RC), (jobs, JRC)):
        o.enable()
        rc.register_cache_spec("q_rec", shared=True)
        try:
            rc.CACHE.store_result("t", "q_rec", {}, [1])
            rc.CACHE.lookup_result("t", "q_rec", {})
            rc.CACHE.lookup_result("t", "q_rec", {"x": 0})
            rc.CACHE.record_fold("q_rec")
        finally:
            rc.unregister_cache_spec("q_rec")
    for fam in ("srt_result_cache_hits_total",
                "srt_result_cache_misses_total",
                "srt_result_cache_bytes_total",
                "srt_result_cache_incremental_folds_total"):
        assert obs.METRICS.family_snapshot(fam) == \
            jobs.METRICS.family_snapshot(fam), fam


def test_shim_result_cache_entries_match_reference():
    from spark_rapids_tpu.shim import jni_entry as JE
    from spark_rapids_tpu_torch.shim import jni_api, jni_entry
    for rc in (RC, JRC):
        rc.register_cache_spec("q_shim", shared=True)
        rc.CACHE.store_result("t", "q_shim", {}, {"a": [1, 2]})
        rc.unregister_cache_spec("q_shim")
    port = json.loads(jni_entry.result_cache_stats())
    ref = json.loads(JE.result_cache_stats())
    assert sorted(port) == sorted(ref)
    assert {k: port[k] for k in COUNTS + ("bytes",)} == \
        {k: ref[k] for k in COUNTS + ("bytes",)}
    assert jni_entry.result_cache_bump_epoch("s") == 1 == \
        JE.result_cache_bump_epoch("s")
    assert jni_api.result_cache_clear() == 1 == JE.result_cache_clear()
    assert jni_entry.result_cache_clear(True) == 0


def test_cache_hit_profile_matches_reference():
    for o in (obs, jobs):
        o.enable_profiling()
    got = obs.cache_hit_profile("t", "q", "id1", 1234)
    want = jobs.cache_hit_profile("t", "q", "id1", 1234)
    for p in (got, want):
        p.pop("t_unix_ms")
    assert got == want
    assert obs.PROFILER.last()["cache"]["lookup_ns"] == 1234
