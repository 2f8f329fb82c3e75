"""PyTorch port: shim/jni_entry's op half, the embedded-interpreter
entries (primitives and handles in, primitives and handles out) of the
ops this slice ports, against the JAX package's jni_entry on the same
values: the entries of tests/test_jni_entry.py:81-241 that belong to
this slice.  Constructors default to the card; these tests ask for the
CPU."""

import pytest

from spark_rapids_tpu.shim import jni_entry as JJ
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.shim import jni_entry as J
from spark_rapids_tpu_torch.shim.errors import ShimArgumentError
from spark_rapids_tpu_torch.shim.handles import REGISTRY

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh():
    JJ.initialize()
    before = J.live_handles()
    yield before
    JJ.shutdown()


def host(h):
    return J.column_to_host(h)


def jhost(h):
    return JJ.column_to_host(h)


def test_constructors_helpers_and_free(_fresh):
    hs = [J.from_longs([1, None, 3], device=CPU),
          J.from_ints([7, 8], device=CPU),
          J.from_doubles([0.5, None], device=CPU),
          J.from_strings(["a", None, "中"], device=CPU),
          J.from_decimals([125, -7, None], -2, "decimal128", device=CPU)]
    assert [host(h) for h in hs] == [
        [1, None, 3], [7, 8], [0.5, None], ["a", None, "中"],
        [125, -7, None]]
    assert REGISTRY.get(hs[4]).dtype == dtypes.decimal128(-2)
    assert all(REGISTRY.get(h).device.type == "cpu" for h in hs)
    assert J.live_handles() == _fresh + 5
    for h in hs:
        J.free(h)
    assert J.live_handles() == _fresh
    with pytest.raises(ValueError):
        J.free(hs[0])                      # exactly once


def test_constructors_default_to_the_card():
    """A constructor called without a device uses the entries' device,
    which is the card until initialize() reads
    SPARK_RAPIDS_TPU_PLATFORM=cpu."""
    import inspect
    from spark_rapids_tpu_torch.utils import platform
    for fn in (J.from_longs, J.from_ints, J.from_doubles, J.from_strings,
               J.from_decimals, J.random_uuids, J.bloom_filter_create,
               J.bloom_filter_deserialize):
        assert inspect.signature(fn).parameters["device"].default is None
    assert platform.entry_device() == "cuda"


def test_casts_match_reference():
    assert host(J.cast_strings_to_date(
        J.from_strings(["2020-01-02", "x"], device=CPU), False)) == \
        jhost(JJ.cast_strings_to_date(JJ.from_strings(["2020-01-02", "x"]),
                                     False)) == [18263, None]
    assert host(J.long_to_binary_string(J.from_longs([5, -1], device=CPU))
                ) == jhost(JJ.long_to_binary_string(JJ.from_longs([5, -1])))
    assert host(J.format_number(J.from_doubles([1234.5], device=CPU), 1)
                ) == ["1,234.5"]


def test_strings_family():
    s = ["a.b.c", None, "x"]
    assert host(J.substring_index(J.from_strings(s, device=CPU), ".", 2)
                ) == jhost(JJ.substring_index(JJ.from_strings(s), ".", 2))
    u = host(J.random_uuids(3, 7, device=CPU))
    assert len(set(u)) == 3 and u == host(J.random_uuids(3, 7, device=CPU))


def test_zorder_and_case_when_match_reference():
    a, b = J.from_ints([1, 5], device=CPU), J.from_ints([2, None],
                                                        device=CPU)
    ja, jb = JJ.from_ints([1, 5]), JJ.from_ints([2, None])
    assert host(J.interleave_bits([a, b])) == \
        jhost(JJ.interleave_bits([ja, jb]))
    assert host(J.hilbert_index(4, [a, b])) == \
        jhost(JJ.hilbert_index(4, [ja, jb]))
    c1 = REGISTRY.register(Column.from_pylist([False, True], dtypes.BOOL8,
                                              CPU))
    c2 = REGISTRY.register(Column.from_pylist([True, False], dtypes.BOOL8,
                                              CPU))
    assert host(J.select_first_true_index([c1, c2])) == [1, 0]


@pytest.mark.parametrize("version", [1, 2])
def test_bloom_entries_match_reference(version):
    keys = [1, 2, 3, -9, 234000000]
    bf = J.bloom_filter_put(J.bloom_filter_create(3, 4, version,
                                                  device=CPU),
                            J.from_longs(keys, device=CPU))
    jbf = JJ.bloom_filter_put(JJ.bloom_filter_create(3, 4, version),
                              JJ.from_longs(keys))
    blob = J.bloom_filter_serialize(bf)
    assert blob == JJ.bloom_filter_serialize(jbf)
    back = J.bloom_filter_deserialize(blob, device=CPU)
    probe = J.from_longs(keys + [99, None], device=CPU)
    assert host(J.bloom_filter_probe(back, probe)) == \
        jhost(JJ.bloom_filter_probe(jbf, JJ.from_longs(keys + [99, None])))
    merged = J.bloom_filter_merge([bf, back])
    assert J.bloom_filter_serialize(merged) == blob


def test_arithmetic_and_histogram_entries_match_reference():
    a, b = [2**31 - 1, 3, None], [2, 4, 5]
    got = J.arithmetic_multiply(J.from_ints(a, device=CPU),
                                J.from_ints(b, device=CPU), False, True)
    want = JJ.arithmetic_multiply(JJ.from_ints(a), JJ.from_ints(b), False,
                                  True)
    assert host(got) == jhost(want) == [None, 12, None]
    r = [1.25, -2.5, None]
    assert host(J.arithmetic_round(J.from_doubles(r, device=CPU), 1,
                                   "HALF_EVEN")) == \
        jhost(JJ.arithmetic_round(JJ.from_doubles(r), 1, "HALF_EVEN"))
    with pytest.raises(ValueError):
        J.arithmetic_round(J.from_doubles(r, device=CPU), 1, "UP")
    v, f = [10.0, 20.0, 30.0, None], [1, 1, 2, 3]
    h = J.histogram_create(J.from_doubles(v, device=CPU),
                           J.from_longs(f, device=CPU))
    jh = JJ.histogram_create(JJ.from_doubles(v), JJ.from_longs(f))
    assert host(h) == jhost(jh)
    assert host(J.histogram_percentile(h, [0.0, 0.5, 1.0])) == \
        jhost(JJ.histogram_percentile(jh, [0.0, 0.5, 1.0]))


def test_decimal_binop_matches_reference():
    a = J.from_decimals([125, -10**37, None], -2, "decimal128", device=CPU)
    b = J.from_decimals([200, 10**3, 1], -2, "decimal128", device=CPU)
    ja = JJ.from_decimals([125, -10**37, None], -2, "decimal128")
    jb = JJ.from_decimals([200, 10**3, 1], -2, "decimal128")
    for op, scale in (("multiply", -4), ("add", -2), ("sub", -2),
                      ("divide", -6)):
        got = [host(h) for h in J.decimal128_binop(op, a, b, scale)]
        want = [jhost(h) for h in JJ.decimal128_binop(op, ja, jb, scale)]
        assert got == want, op
    ovf, res = J.decimal128_binop("multiply", a, b, -4)
    assert host(res)[0] == 25000 and host(ovf) == [False, True, None]


def test_iceberg_hllpp_and_struct_child():
    ic = J.from_longs([5, 6, 7], device=CPU)
    assert host(J.iceberg_bucket(ic, 8)) == [7, 1, 3]
    assert host(J.iceberg_truncate(ic, 5)) == [5, 5, 5]
    ts = REGISTRY.register(Column.from_pylist(
        [1_600_000_000_000_000], dtypes.TIMESTAMP_MICROS, CPU))
    for comp, want in (("year", 50), ("month", 608), ("day", 18518),
                       ("hour", 444444)):
        assert host(J.iceberg_datetime(ts, comp)) == [want]
    with pytest.raises(ShimArgumentError):
        J.iceberg_datetime(ts, "week")
    h = J.from_longs(list(range(1000)), device=CPU)
    sk = J.hllpp_reduce(h, 9)
    jsk = JJ.hllpp_reduce(JJ.from_longs(list(range(1000))), 9)
    assert host(sk) == jhost(jsk)
    est = host(J.hllpp_estimate(sk, 9))[0]
    assert est == jhost(JJ.hllpp_estimate(jsk, 9))[0]
    assert 900 < est < 1100                 # +-10% at precision 9
    child = J.struct_child(sk, 0)
    assert host(child) == [host(sk)[0][0]]


# ------------------------------------------- profiles, incidents, caches

JSON_ENTRIES = ["profile_last_json", "incident_list", "health_json",
                "timeseries_snapshot_json", "slo_status_json",
                "slo_evaluate_json", "attribution_last_json",
                "jit_cache_stats", "result_cache_stats",
                "stats_snapshot_json"]
SWITCH_ENTRIES = ["profile", "flight_recorder", "timeseries", "slo",
                  "attribution", "stats"]


@pytest.fixture
def planes(monkeypatch, tmp_path):
    from torch_planes import isolate
    yield from isolate(monkeypatch, tmp_path)


@pytest.mark.parametrize("name", JSON_ENTRIES)
def test_observability_json_entries_match_reference(name, planes):
    """Each JSON entry gives the reference's keys (values that are
    times, paths or pids aside: the keys alone are compared where the
    reference's document is a dict, the document where it is a list
    or empty)."""
    import json
    got, want = getattr(J, name)(), getattr(JJ, name)()
    if want == "":
        assert got == ""
        return
    got, want = json.loads(got), json.loads(want)
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
    else:
        assert got == want


@pytest.mark.parametrize("plane", SWITCH_ENTRIES)
def test_observability_switch_entries_match_reference(plane, planes):
    on = getattr(J, f"{plane}_set_enabled")
    jon = getattr(JJ, f"{plane}_set_enabled")
    assert on(True) == jon(True)
    assert getattr(J, f"{plane}_enabled")() is True
    assert on(False) == jon(False)
    assert getattr(J, f"{plane}_enabled")() is False


def test_cache_entries_and_incident_dump(planes, tmp_path):
    import json
    assert J.jit_cache_clear(True) == JJ.jit_cache_clear(True) == 0
    assert J.result_cache_clear(True) == JJ.result_cache_clear(True) == 0
    assert J.result_cache_bump_epoch("arrow") == \
        JJ.result_cache_bump_epoch("arrow") == 1
    J.flight_recorder_configure(str(tmp_path / "inc"), 1 << 20, 0.0)
    path = J.incident_dump("probe")
    assert path.startswith(str(tmp_path / "inc"))
    (inc,) = json.loads(J.incident_list())
    assert inc["kind"] == "manual" and inc["path"] == path
    J.stats_store_clear()


# --------------------------------------------------------- query server


def shim_server_session(E, models):
    """The JVM's server sequence through one package's jni_entry:
    JSON in, JSON out, ids and times dropped."""
    import json

    def clean(doc):
        doc = dict(doc)
        for k in ("wait_ns", "dur_ns", "query_id"):
            doc.pop(k, None)
        return doc

    models.register_query("t_shim_echo",
                          lambda params, ctx: params.get("v"))
    out = []
    try:
        out += [E.server_start(max_concurrency=1, max_queue=4),
                E.server_start()]
        E.server_set_tenant_quota("jvm", max_inflight=2)
        resp = json.loads(E.server_submit(
            "jvm", "t_shim_echo", json.dumps({"v": 31337})))
        assert resp.pop("ok") and resp["query_id"].startswith("q-")
        out.append(clean(json.loads(E.server_poll(resp["query_id"],
                                                  20.0))))
        stats = json.loads(E.server_stats_json())
        out.append(stats["tenants"]["jvm"]["success"])
        out.append(sorted(stats))
        out.append(json.loads(E.server_submit("jvm", "missing_query")))
        out.append(E.server_cancel("nonexistent"))
        out.append(json.loads(E.server_profile_json("q-999999")))
        report = json.loads(E.server_drain(5.0))
        report.pop("duration_s")
        out.append(report)
        out.append(E.server_start(max_concurrency=1, max_queue=4))
        resp2 = json.loads(E.server_submit(
            "jvm", "t_shim_echo", json.dumps({"v": 1}), 30.0))
        out.append(clean(json.loads(E.server_poll(resp2["query_id"],
                                                  20.0))))
        out.append(json.loads(E.server_drain())["state"])
        out.append(json.loads(E.server_drain()))
    finally:
        E.server_stop()
        models.unregister_query("t_shim_echo")
    out.append(json.loads(E.server_stats_json()))
    return out


def test_server_entries_json_match_reference(planes):
    from spark_rapids_tpu import models as JM
    from spark_rapids_tpu_torch import models as TM
    from spark_rapids_tpu_torch import server as TS
    got = shim_server_session(J, TM)
    want = shim_server_session(JJ, JM)
    assert got == want
    assert got[:2] == [True, False]
    assert got[2]["result"] == 31337
    assert got[5]["error"]["type"] == "UnknownQuery"
    assert got[7] == {"ok": False, "error": {
        "type": "UnknownProfile",
        "message": "no retained profile for 'q-999999'"}}
    assert got[-2] == {"state": "not_running"}
    assert got[-1] == {"started": False}
    assert TS.get_server() is None


def test_server_entries_need_a_running_server(planes):
    for E in (J, JJ):
        for call in (lambda: E.server_submit("t", "tpcds_q9"),
                     lambda: E.server_poll("q-000001"),
                     lambda: E.server_set_tenant_quota("t"),
                     lambda: E.server_profile_json("q-000001")):
            with pytest.raises(RuntimeError, match="not running"):
                call()
        assert E.server_cancel("q-000001") is False


def test_server_profile_json_returns_a_retained_profile(planes):
    import json

    from spark_rapids_tpu_torch import models as TM
    from spark_rapids_tpu_torch import observability as obs
    TM.register_query("t_shim_prof", lambda params, ctx: [1])
    obs.enable_profiling()
    try:
        J.server_start(max_concurrency=1, max_queue=4)
        qid = json.loads(J.server_submit("acme", "t_shim_prof"))["query_id"]
        assert json.loads(J.server_poll(qid, 20.0))["state"] == "done"
        doc = json.loads(J.server_profile_json(qid))
        assert doc["ok"] and doc["profile"]["query_id"] == qid
        assert doc["profile"]["tenant"] == "acme"
    finally:
        J.server_stop()
        obs.disable_profiling()
        TM.unregister_query("t_shim_prof")
