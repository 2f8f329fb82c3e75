"""PyTorch port: the rest of shim/jni_entry (initialize/shutdown, the
bulk string door, gather, the op entries over jni_api and the op layer,
ingest, platform, threads and priority, host tables, the kudo write
memo and merge, RmmSpark, the list/map and ORC helpers and the check
helpers), each against the JAX package's jni_entry on the same seeded
values: the cases of tests/test_jni_entry.py.  The port's entries run
on the CPU (SPARK_RAPIDS_TPU_PLATFORM=cpu through initialize())."""

import inspect
import io
import struct

import numpy as np
import pytest

import torch_port_data as D
from spark_rapids_tpu.shim import jni_entry as JJ
from spark_rapids_tpu.shim.handles import REGISTRY as JREG
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.shim import jni_entry as J
from spark_rapids_tpu_torch.shim.errors import (ShimArgumentError,
                                                ShimStateError)
from spark_rapids_tpu_torch.shim.handles import REGISTRY
from spark_rapids_tpu_torch.shuffle import kudo
from spark_rapids_tpu_torch.utils import platform


def _reset_entries():
    J._INITIALIZED = False
    platform.set_entry_device("cuda")


@pytest.fixture(autouse=True)
def entries(monkeypatch):
    """Both packages initialized, the port's entries on the CPU; both
    shut down after (0 live handles, no memo, no host tables)."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PLATFORM", "cpu")
    _reset_entries()
    JJ.initialize()
    J.initialize()
    yield
    J.shutdown()
    JJ.shutdown()
    _reset_entries()


def host(h):
    return J.column_to_host(h)


def jhost(h):
    return JJ.column_to_host(h)


def both(specs):
    """The same host columns registered in each package: (port handles,
    JAX handles)."""
    port = [REGISTRY.register(c) for c in D.port_table(specs).columns]
    jax = [JREG.register(c) for c in D.jax_table(specs).columns]
    return port, jax


# ------------------------------------------------------------ the door


def test_entry_names_are_the_jax_set_less_the_mesh_programs():
    """The port's entries are the JAX module's, the mesh programs
    (flagship_q5_mesh, flagship_q72_mesh) included: none is subtracted
    any more."""
    def names(mod, private):
        return {n for n, f in vars(mod).items()
                if inspect.isfunction(f) and f.__module__ == mod.__name__
                and n.startswith("_") == private}
    assert names(J, False) == names(JJ, False)
    assert {"flagship_q5_mesh", "flagship_q72_mesh"} <= names(J, False)
    # the JAX module's helpers too; the port adds four of its own
    assert names(J, True) - names(JJ, True) == {
        "_device", "_upload", "_unpack_validity", "_bracketed"}
    assert names(JJ, True) <= names(J, True)


def test_initialize_reads_the_platform(monkeypatch):
    assert platform.entry_device() == "cpu"
    assert REGISTRY.get(J.from_longs([1])).device.type == "cpu"
    J.initialize()                       # idempotent
    _reset_entries()
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PLATFORM", "tpu")
    with pytest.raises(ShimArgumentError, match="expected cpu, cuda"):
        J.initialize()
    assert not J._INITIALIZED and platform.entry_device() == "cuda"
    for value in ("", "cuda", "gpu"):
        monkeypatch.setenv("SPARK_RAPIDS_TPU_PLATFORM", value)
        if torch_has_cuda():
            J.initialize()
            assert platform.entry_device() == "cuda"
            _reset_entries()
        else:
            with pytest.raises(ShimStateError, match="no CUDA device"):
                J.initialize()
            assert not J._INITIALIZED


def torch_has_cuda():
    import torch
    return torch.cuda.is_available()


def test_shutdown_leaves_no_live_handles(tmp_path):
    import sys
    hs = [J.from_longs([1, 2, 3]), J.from_strings(["a", None, "bc"])]
    J.kudo_write(hs, 0, 2)
    ht = J.host_table_from_table(hs)
    assert J.live_handles() > 0 and J._HOST_TABLES
    stopped = []
    srv = sys.modules.get("spark_rapids_tpu_torch.server")
    if srv is not None:
        real = srv.stop_server
        srv.stop_server = lambda **kw: stopped.append(kw)
    try:
        J.shutdown()
    finally:
        if srv is not None:
            srv.stop_server = real
    assert J.live_handles() == 0
    assert not J._HOST_TABLES and not J._KUDO_WRITE_CACHE
    assert stopped == ([{"timeout_s": 5}] if srv is not None else [])
    with pytest.raises(ShimArgumentError):
        J.host_table_size_bytes(ht)


def test_shutdown_does_not_import_the_server(monkeypatch):
    import sys
    monkeypatch.delitem(sys.modules, "spark_rapids_tpu_torch.server",
                        raising=False)
    J.shutdown()
    assert "spark_rapids_tpu_torch.server" not in sys.modules


def test_device_attr_is_integrated_on_the_cpu():
    assert J.device_attr_is_integrated() is JJ.device_attr_is_integrated() \
        is True


# ------------------------------------------------------- bulk strings


def bulk_payload(seed, rows, nullable):
    rng = np.random.default_rng(seed)
    _k, chars, validity, offs = D.host_strings(rng, rows, 24,
                                               nullable=nullable)
    packed = (None if validity is None
              else np.packbits(validity, bitorder="little").tobytes())
    return chars.tobytes(), offs.astype("<i4").tobytes(), packed


@pytest.mark.parametrize("rows,nullable", [(0, False), (1, True),
                                           (1000, False), (1003, True)])
def test_from_strings_bulk_round_trip(rows, nullable):
    chars, offs, validity = bulk_payload(rows, rows, nullable)
    h = J.from_strings_bulk(chars, offs, validity)
    jh = JJ.from_strings_bulk(chars, offs, validity)
    assert REGISTRY.get(h).device.type == "cpu"
    assert host(h) == jhost(jh)
    assert J.string_column_chars(h) == JJ.string_column_chars(jh) \
        == chars[:len(J.string_column_chars(h))]
    assert J.string_column_offsets(h) == JJ.string_column_offsets(jh) \
        == offs


def offs_bytes(*vals):
    return np.asarray(vals, "<i4").tobytes()


@pytest.mark.parametrize("args,match", [
    ((b"abc", b"", None), "at least one"),
    ((b"abc", offs_bytes(0, 3, 1), None), "non-decreasing"),
    ((b"abc", offs_bytes(1, 3), None), "start at 0"),
    ((b"abc", offs_bytes(0, 9), None), "exceeds chars"),
    ((b"abcdefghij" * 2, offs_bytes(*range(0, 21)), b"\xff"),
     "validity shorter"),
])
def test_from_strings_bulk_boundary_validation(args, match):
    with pytest.raises(ShimArgumentError, match=match):
        J.from_strings_bulk(*args)
    with pytest.raises(ValueError, match=match):
        JJ.from_strings_bulk(*args)


def test_string_readback_refuses_other_kinds():
    with pytest.raises(ShimArgumentError, match="not a STRING"):
        J.string_column_chars(J.from_longs([1]))


# --------------------------------------------------------- op entries


def seeded_specs(seed, rows=257):
    rng = np.random.default_rng(seed)
    return [D.host_column(rng, "int32", rows, nullable=True),
            D.host_column(rng, "int64", rows, nullable=False),
            D.host_strings(rng, rows, 20, nullable=True),
            D.host_column(rng, "float64", rows, nullable=True,
                          specials=False)]


@pytest.mark.parametrize("entry", ["murmur_hash3_32", "xx_hash_64",
                                   "hive_hash"])
def test_hash_entries_match_reference(entry):
    p, j = both(seeded_specs(3))
    args = (p,) if entry == "hive_hash" else (42, p)
    jargs = (j,) if entry == "hive_hash" else (42, j)
    assert host(getattr(J, entry)(*args)) == \
        jhost(getattr(JJ, entry)(*jargs))


@pytest.mark.parametrize("kinds", [
    ["int32", "int64", "float64", "int8"],
    ["int16", "string", "bool8", "string", "uint64"],
])
def test_row_entries_byte_equal_to_reference(kinds):
    rng = np.random.default_rng(len(kinds))
    specs = D.host_table(rng, 300, kinds, null_every=2, specials=False)
    p, j = both(specs)
    r, jr = J.convert_to_rows(p), JJ.convert_to_rows(j)
    rows, jrows = REGISTRY.get(r), JREG.get(jr)
    assert D.col_parts(rows) == D.col_parts(jrows)
    type_ids = [k for k in kinds]
    back = J.convert_from_rows(r, type_ids, [0] * len(kinds))
    jback = JJ.convert_from_rows(jr, type_ids, [0] * len(kinds))
    assert [host(h) for h in back] == [jhost(h) for h in jback] \
        == [host(h) for h in p]


def test_gather_matches_reference():
    p, j = both(seeded_specs(5, 40))
    idx = [3, 0, 39, 7, 7]
    for pc, jc in zip(p, j):
        assert host(J.gather(pc, J.from_ints(idx))) == \
            jhost(JJ.gather(jc, JJ.from_ints(idx)))


@pytest.mark.parametrize("case", ["integer", "float", "float_to_string"])
def test_cast_entries_match_reference(case):
    s = ["12", "x", None, "-7", " 3 ", "1e3", "2.5"]
    if case == "integer":
        got = J.string_to_integer(J.from_strings(s), "int32", False, True)
        want = JJ.string_to_integer(JJ.from_strings(s), "int32", False,
                                    True)
    elif case == "float":
        got = J.string_to_float(J.from_strings(s), "float64", False)
        want = JJ.string_to_float(JJ.from_strings(s), "float64", False)
    else:
        v = [0.5, None, -1.25, 1e21, 3.0]
        got = J.float_to_string(J.from_doubles(v))
        want = JJ.float_to_string(JJ.from_doubles(v))
    assert host(got) == jhost(want)


def test_json_entries_match_reference():
    docs = ['{"a": {"b": 5}}', '{"a": [1, 2]}', None, "nope"]
    assert host(J.get_json_object(J.from_strings(docs), "$.a.b")) == \
        jhost(JJ.get_json_object(JJ.from_strings(docs), "$.a.b")) == \
        ["5", None, None, None]
    outs = J.get_json_object_multiple_paths(J.from_strings(docs),
                                            ["$.a.b", "$.a", "$.x"],
                                            -1, -1)
    jouts = JJ.get_json_object_multiple_paths(JJ.from_strings(docs),
                                              ["$.a.b", "$.a", "$.x"],
                                              -1, -1)
    assert [host(h) for h in outs] == [jhost(h) for h in jouts]


URLS = ["https://h.co/p?a=1&b=2", "http://x.org", None, "bad uri",
        "ftp://u@h:21/d/f.txt?q=%20"]


@pytest.mark.parametrize("what", ["protocol", "host", "query", "path"])
def test_parse_uri_entries_match_reference(what):
    assert host(J.parse_uri(J.from_strings(URLS), what, False)) == \
        jhost(JJ.parse_uri(JJ.from_strings(URLS), what, False))


def test_parse_uri_query_with_key_matches_reference():
    assert host(J.parse_uri_query_with_key(J.from_strings(URLS), "a",
                                           False)) == \
        jhost(JJ.parse_uri_query_with_key(JJ.from_strings(URLS), "a",
                                          False))


def test_string_misc_entries_match_reference():
    gbk = ["中".encode("gbk"), b"ok", None]
    assert host(J.charset_decode_to_utf8(J.from_strings(gbk), "GBK",
                                         "REPLACE")) == \
        jhost(JJ.charset_decode_to_utf8(JJ.from_strings(gbk), "GBK",
                                        "REPLACE")) == ["中", "ok", None]
    nums = ["255", "-1", None, "zz"]
    assert host(J.number_converter_convert(J.from_strings(nums), 10,
                                           16)) == \
        jhost(JJ.number_converter_convert(JJ.from_strings(nums), 10, 16))
    s = ["ab1", "abx", None, "ab9z"]
    assert host(J.literal_range_pattern(J.from_strings(s), "ab", 1,
                                        ord("0"), ord("9"))) == \
        jhost(JJ.literal_range_pattern(JJ.from_strings(s), "ab", 1,
                                       ord("0"), ord("9")))


def timestamps(pkg_reg, device=None):
    vals = [1_600_000_000_000_000, -86_400_000_001, None, 0,
            1_700_000_123_456_789]
    if pkg_reg is REGISTRY:
        return REGISTRY.register(Column.from_pylist(
            vals, dtypes.TIMESTAMP_MICROS, "cpu"))
    from spark_rapids_tpu.columns import dtypes as jd
    from spark_rapids_tpu.columns.column import Column as JC
    return JREG.register(JC.from_pylist(vals, jd.TIMESTAMP_MICROS))


@pytest.mark.parametrize("component", ["YEAR", "MONTH", "DAY", "HOUR"])
def test_datetime_truncate_matches_reference(component):
    assert host(J.datetime_truncate(timestamps(REGISTRY), component)) == \
        jhost(JJ.datetime_truncate(timestamps(JREG), component))


@pytest.mark.parametrize("flag", [True, False])
def test_rebase_and_timezone_match_reference(flag):
    assert host(J.datetime_rebase(timestamps(REGISTRY), flag)) == \
        jhost(JJ.datetime_rebase(timestamps(JREG), flag))
    for zone in ("UTC", "America/Los_Angeles", "Asia/Kolkata"):
        assert host(J.timezone_convert(timestamps(REGISTRY), zone,
                                       flag)) == \
            jhost(JJ.timezone_convert(timestamps(JREG), zone, flag))


@pytest.mark.parametrize("op,call", [
    ("parse_uri_to_host",
     lambda: J.parse_uri(J.from_strings(URLS), "host", False)),
    ("parse_uri_to_query_with_key",
     lambda: J.parse_uri_query_with_key(J.from_strings(URLS), "a", False)),
    ("truncate",
     lambda: J.datetime_truncate(timestamps(REGISTRY), "YEAR")),
    ("rebase_gregorian_to_julian",
     lambda: J.datetime_rebase(timestamps(REGISTRY), True)),
    ("convert_timestamp_to_utc",
     lambda: J.timezone_convert(timestamps(REGISTRY), "UTC", True)),
    ("sort_map_column",
     lambda: J.map_sort(J.make_map_column([0, 1], ["a"], ["b"]), False)),
    ("string_to_float",
     lambda: J.string_to_float(J.from_strings(["1"]), "float64", False)),
    ("convert_to_rows", lambda: J.convert_to_rows([J.from_ints([1])])),
])
def test_op_entries_open_the_fault_bracket(op, call, tmp_path):
    """Every op entry opens maybe_inject (and an op_range) under its
    op's name: a rule on that name raises at the entry."""
    import json
    from spark_rapids_tpu_torch.memory import exceptions as MX
    from spark_rapids_tpu_torch.utils import fault_injection as fi
    cfg = tmp_path / "faults.json"
    cfg.write_text(json.dumps({"faults": [
        {"match": op, "repeat": 1, "exception": "CudfException"}]}))
    fi.install(str(cfg), watch=False)
    try:
        with pytest.raises(MX.CudfException, match=op):
            call()
        call()                     # the rule's one repeat is spent
    finally:
        fi.uninstall()


def test_join_and_agg64_entries_match_reference():
    lv, rv = [1, 2, 3, None, 2], [2, 3, 4, None]
    for nulls_equal in (True, False):
        got = J.sort_merge_inner_join([J.from_longs(lv)],
                                      [J.from_longs(rv)], nulls_equal)
        want = JJ.sort_merge_inner_join([JJ.from_longs(lv)],
                                        [JJ.from_longs(rv)], nulls_equal)
        assert sorted(zip(host(got[0]), host(got[1]))) == \
            sorted(zip(jhost(want[0]), jhost(want[1])))
    v = [1, -2, 2**40, None]
    lo = J.extract_chunk32_from_64bit(J.from_longs(v), "int64", 0)
    hi = J.extract_chunk32_from_64bit(J.from_longs(v), "int64", 1)
    jlo = JJ.extract_chunk32_from_64bit(JJ.from_longs(v), "int64", 0)
    jhi = JJ.extract_chunk32_from_64bit(JJ.from_longs(v), "int64", 1)
    assert (host(lo), host(hi)) == (jhost(jlo), jhost(jhi))
    got = [host(h) for h in J.assemble64_from_sum(lo, hi, "int64")]
    want = [jhost(h) for h in JJ.assemble64_from_sum(jlo, jhi, "int64")]
    assert got == want


def test_list_and_map_entries_match_reference():
    offs, vals = [0, 2, 2, 5], [1, 2, 3, 4, 5]
    lst = J.make_list_of_ints(offs, vals)
    jlst = JJ.make_list_of_ints(offs, vals)
    assert REGISTRY.get(lst).device.type == "cpu"
    assert host(lst) == jhost(jlst)
    for start, length in ((1, 2), (2, None), (-1, 1)):
        assert host(J.list_slice(lst, start, length, False, False,
                                 True)) == \
            jhost(JJ.list_slice(jlst, start, length, False, False, True))
    moffs, keys, vs = [0, 2, 3], ["b", "a", "c"], ["1", "2", "3"]
    m, jm = (J.make_map_column(moffs, keys, vs),
             JJ.make_map_column(moffs, keys, vs))
    assert host(m) == jhost(jm)
    for desc in (False, True):
        assert host(J.map_sort(m, desc)) == jhost(JJ.map_sort(jm, desc))
    assert J.map_is_valid(m, True) is JJ.map_is_valid(jm, True) is True
    assert host(J.map_from_entries_jni(m, True)) == \
        jhost(JJ.map_from_entries_jni(jm, True))
    m2, jm2 = (J.make_map_column([0, 1, 2], ["a", "c"], ["x", "y"]),
               JJ.make_map_column([0, 1, 2], ["a", "c"], ["x", "y"]))
    assert host(J.map_zip_jni(m, m2)) == jhost(JJ.map_zip_jni(jm, jm2))


@pytest.mark.parametrize("zone", ["UTC", "America/New_York",
                                  "Asia/Shanghai", "Europe/Berlin"])
def test_orc_timezone_packed_matches_reference(zone):
    assert J.orc_timezone_packed(zone) == JJ.orc_timezone_packed(zone)


def test_all_timezone_ids_match_reference():
    ids = J.all_timezone_ids()
    assert ids == JJ.all_timezone_ids()
    assert "America/Los_Angeles" in ids or not ids


def test_check_helpers_and_describe():
    a, b = J.from_ints([7, 8]), J.from_ints([7, 8])
    assert J.check_columns_equal(a, b) == JJ.check_columns_equal(
        JJ.from_ints([7, 8]), JJ.from_ints([7, 8])) == 1
    assert J.check_int_column(a, [7, 8]) == 1
    assert J.check_int_column(a, [7, 9]) == 0
    assert J.check_long_column(J.from_longs([2**40]), [2**40]) == 1
    assert J.check_string_column(J.from_strings(["x", None]),
                                 ["x", None]) == 1
    assert J.describe_column(a) == JJ.describe_column(JJ.from_ints([7, 8]))


# ------------------------------------------ ingest, platform, threads


def test_ingest_entries_match_reference(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    batch = pa.RecordBatch.from_pydict({
        "id": pa.array([1, None, 3], pa.int64()),
        "name": pa.array(["a", "bb", None]),
        "score": pa.array([0.5, 1.5, None], pa.float64())})
    got = [host(h) for h in J.arrow_ingest(batch)]
    assert got == [jhost(h) for h in JJ.arrow_ingest(batch)]
    path = tmp_path / "t.parquet"
    pq.write_table(pa.Table.from_batches([batch]), path)
    assert [host(h) for h in J.parquet_read_table(str(path), ["name"])] \
        == [jhost(h) for h in JJ.parquet_read_table(str(path), ["name"])] \
        == [["a", "bb", None]]
    raw = path.read_bytes()
    flen = struct.unpack("<I", raw[-8:-4])[0]
    footer = raw[-8 - flen:-8]
    assert J.parquet_footer_read_and_filter(footer, ["id"], True) == \
        JJ.parquet_footer_read_and_filter(footer, ["id"], True)


@pytest.mark.parametrize("version,want", [((0, 3, 2, 1), True),
                                          ((0, 3, 5, 0), False),
                                          ((1, 3, 2, 0), False)])
def test_version_is_vanilla_320(version, want):
    assert J.version_is_vanilla_320(*version) is \
        JJ.version_is_vanilla_320(*version) is want


def test_thread_registry_and_task_priority():
    J.registry_add_thread(31337)
    assert 31337 in J.registry_known_threads()
    J.registry_remove_thread(31337)
    assert 31337 not in J.registry_known_threads()
    # priorities come from a process-wide counter: compare their order
    ids = (2_000_003, 2_000_004, 2_000_003)
    got = [J.task_priority_get(a) for a in ids]
    want = [JJ.task_priority_get(a) for a in ids]
    assert got[0] == got[2] and want[0] == want[2]
    assert got[0] - got[1] == want[0] - want[1] > 0
    for a in ids[:2]:
        J.task_priority_done(a)
        JJ.task_priority_done(a)


# ------------------------------------------------ host tables and kudo


def test_host_table_round_trip_and_double_free():
    p, j = both(seeded_specs(9, 100))
    ht, jht = J.host_table_from_table(p), JJ.host_table_from_table(j)
    assert J.host_table_size_bytes(ht) > 0
    back = J.host_table_to_device(ht)
    jback = JJ.host_table_to_device(jht)
    assert [host(h) for h in back] == [jhost(h) for h in jback]
    assert all(REGISTRY.get(h).device.type == "cpu" for h in back)
    J.host_table_free(ht)
    with pytest.raises(ShimArgumentError, match="double free"):
        J.host_table_free(ht)


def kudo_specs(seed, rows=301):
    rng = np.random.default_rng(seed)
    return [D.host_column(rng, "int64", rows, nullable=True),
            D.host_strings(rng, rows, 12, nullable=True),
            D.host_column(rng, "float64", rows, nullable=False,
                          specials=False),
            D.host_column(rng, "int8", rows, nullable=True),
            D.host_column(rng, "decimal128", rows, nullable=True)]


SLICES = [(0, 301), (0, 100), (100, 100), (200, 101), (17, 0), (300, 1)]


def spec_bytes(handles, off, n):
    out = io.BytesIO()
    kudo.write_to_stream([REGISTRY.get(h) for h in handles], out, off, n)
    return out.getvalue()


@pytest.mark.parametrize("off,n", SLICES)
def test_kudo_write_bytes_equal_reference_and_spec(off, n):
    p, j = both(kudo_specs(1))
    got = J.kudo_write(p, off, n)
    assert got == JJ.kudo_write(j, off, n) == spec_bytes(p, off, n)


def test_kudo_memo_is_purged_on_free_and_capped():
    from spark_rapids_tpu_torch.shuffle import kudo_native
    if not kudo_native.available():
        pytest.skip("no g++: the native kudo engine (and its memo) is "
                    "unavailable")
    p, _ = both(kudo_specs(2, 50))
    J.kudo_write(p, 0, 10)
    assert tuple(p) in J._KUDO_WRITE_CACHE
    nt = J._KUDO_WRITE_CACHE[tuple(p)]
    J.kudo_write(p, 10, 10)
    assert J._KUDO_WRITE_CACHE[tuple(p)] is nt          # a hit
    J.free(p[1])
    assert tuple(p) not in J._KUDO_WRITE_CACHE
    tables = [[J.from_longs([i, i + 1])] for i in range(6)]
    for hs in tables:
        J.kudo_write(hs, 0, 2)
    assert len(J._KUDO_WRITE_CACHE) == J._KUDO_WRITE_CACHE_MAX == 4
    assert list(J._KUDO_WRITE_CACHE) == [tuple(hs) for hs in tables[2:]]


def test_kudo_write_after_free_memoizes_nothing():
    p, _ = both(kudo_specs(3, 20))
    with pytest.raises(ValueError):
        J.free(p[0])
        J.kudo_write(p, 0, 5)
    assert tuple(p) not in J._KUDO_WRITE_CACHE


def test_kudo_merge_matches_reference():
    p, j = both(kudo_specs(4))
    blob = b"".join(J.kudo_write(p, o, n) for o, n in SLICES[1:4])
    kinds = ["int64", "string", "float64", "int8", "decimal128"]
    scales = [0, 0, 0, 0, 0]
    got = [host(h) for h in J.kudo_merge(blob, kinds, scales)]
    assert got == [jhost(h) for h in JJ.kudo_merge(blob, kinds, scales)]
    assert got == [host(h) for h in p]


def test_kudo_crc_on_stays_on_the_spec_engine():
    p, j = both(kudo_specs(5, 64))
    assert J.kudo_crc_enabled() is JJ.kudo_crc_enabled() is False
    prev, jprev = J.kudo_set_crc_enabled(True), JJ.kudo_set_crc_enabled(True)
    try:
        blob = J.kudo_write(p, 0, 64)
        assert blob == JJ.kudo_write(j, 0, 64)
        assert kudo.stream_has_crc_trailers(blob)
        got = [host(h) for h in J.kudo_merge(
            blob, ["int64", "string", "float64", "int8", "decimal128"],
            [0] * 5)]
        assert got == [host(h) for h in p]
    finally:
        J.kudo_set_crc_enabled(prev)
        JJ.kudo_set_crc_enabled(jprev)
    # a peer's trailers are honoured with CRC off here
    assert [host(h) for h in J.kudo_merge(
        blob, ["int64", "string", "float64", "int8", "decimal128"],
        [0] * 5)] == [host(h) for h in p]


def nested_handles():
    child = Column.from_pylist([1, 2, 3, 4, 5], dtypes.INT32, "cpu")
    lst = Column.make_list(np.array([0, 2, 2, 5]), child,
                           validity=np.array([1, 0, 1]))
    st = Column.make_struct(3, [
        Column.from_pylist([7, None, 9], dtypes.INT64, "cpu"),
        Column.from_strings(["a", None, "cc"], "cpu"),
    ], validity=np.array([1, 1, 0]))
    dec = Column.from_pylist([10**20, None, -3], dtypes.decimal128(-1),
                             "cpu")
    return [REGISTRY.register(c) for c in (lst, st, dec)]


def test_export_import_kudo_host_nested_round_trip():
    handles = nested_handles()
    flat = J.export_kudo_host(handles)
    assert flat[0] == 3 and flat[1] == 6
    back = J.columns_from_kudo_host(flat[0], flat[2:])
    assert [host(h) for h in back] == [host(h) for h in handles]
    assert all(REGISTRY.get(h).device.type == "cpu" for h in back)


def test_export_kudo_host_matches_reference():
    p, j = both(kudo_specs(6, 33))
    assert J.export_kudo_host(p) == JJ.export_kudo_host(j)
    flat = J.export_kudo_host(p)
    assert [host(h) for h in J.columns_from_kudo_host(flat[0], flat[2:])] \
        == [jhost(h) for h in JJ.columns_from_kudo_host(flat[0], flat[2:])]


# ------------------------------------------------------------ RmmSpark


def test_rmm_lifecycle_and_exceptions():
    from spark_rapids_tpu_torch.memory.exceptions import (
        GpuRetryOOM, GpuSplitAndRetryOOM)
    J.rmm_set_event_handler(1 << 20)
    try:
        J.rmm_register_current_thread(11)
        tid = J.rmm_current_thread_id()
        assert J.rmm_get_state_of(tid) == "THREAD_RUNNING"
        J.rmm_force_retry_oom(tid, 1)
        with pytest.raises(GpuRetryOOM):
            J.rmm_alloc(64)
        J.rmm_block_thread_until_ready()
        J.rmm_alloc(64)
        J.rmm_dealloc(64)
        J.rmm_force_split_and_retry_oom(tid, 1)
        with pytest.raises(GpuSplitAndRetryOOM):
            J.rmm_alloc(64)
        J.rmm_block_thread_until_ready()
        J.rmm_task_done(11)
    finally:
        J.rmm_clear_event_handler()


def test_rmm_matches_reference_states():
    import threading

    def drive(E):
        out = []
        E.rmm_set_event_handler(1000)
        try:
            E.rmm_start_dedicated_task_thread(threading.get_ident(), 21)
            tid = E.rmm_current_thread_id()
            out.append(E.rmm_get_state_of(tid))
            E.rmm_alloc(600)
            out.append(E.rmm_get_state_of(tid))
            E.rmm_dealloc(600)

            def shuffle():
                E.rmm_shuffle_thread_working_on_tasks([21])
                me = E.rmm_current_thread_id()
                out.append(E.rmm_get_state_of(me))
                E.rmm_alloc(100)
                E.rmm_dealloc(100)
                E.rmm_pool_thread_finished_for_tasks([21])
                out.append(E.rmm_get_state_of(me))

            t = threading.Thread(target=shuffle)
            t.start()
            t.join(10)
            E.rmm_task_done(21)
            out.append(E.rmm_get_state_of(tid))
        finally:
            E.rmm_clear_event_handler()
        return out
    assert drive(J) == drive(JJ)


# ------------------------------------------- chip_smoke's jvm door phase


def test_jvm_door_phase_rehearsal_on_cpu():
    import chip_smoke as C
    fixed = C.make_table(1 << 10, 24, "cpu", seed=7)
    res = C.jvm_door_phase("cpu", rows=(1 << 10) + 3, ncols=31,
                           fixed=fixed, cpu_rows=1 << 9, partitions=8)
    assert res["launches"] == {"to_rows": 0, "from_rows": 0,
                               "to_rows_var": 0}
    assert res["max_abs_err"] == {"to_rows_var": 0, "to_rows": 0,
                                  "from_rows": 0}
    assert res["kudo"]["partitions"] == 8 and res["kudo"]["bytes"] > 0
    assert res["rmm"] == ["GpuRetryOOM", "GpuSplitAndRetryOOM",
                          "THREAD_RUNNING"]
    assert res["host_table_bytes"] >= sum(
        C.nbytes(c.data) for c in fixed.columns)
    assert set(res["so_build_s"]) == set(C.NATIVE_LIBRARIES)
    for entry in ("initialize", "arrow_ingest", "from_strings_bulk",
                  "convert_to_rows_var", "convert_from_rows_var",
                  "string_readback", "convert_to_rows_fixed",
                  "convert_from_rows_fixed", "kudo_write_miss",
                  "kudo_write_hit", "kudo_write_spec", "kudo_merge",
                  "export_kudo_host", "columns_from_kudo_host",
                  "host_table_from_table", "host_table_to_device", "rmm",
                  "shutdown"):
        assert res["entry_ms"][entry] >= 0, entry
    assert J.live_handles() == 0
