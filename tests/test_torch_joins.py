"""PyTorch port: the join layer (ROADMAP A7) against the JAX package on
the same seeded host tables, byte for byte.

Each of the router's four engines (host_rank, host_hash, device_sort,
device_hash), pinned through SPARK_RAPIDS_TPU_PATH_JOIN_INNER, against
the JAX package's host rank oracle under both null semantics, for
INT8-INT64, UINT8-UINT64, FLOAT32/FLOAT64 (NaN payloads, +-0.0),
DECIMAL128 and STRING keys (empty, bytes >= 0x80, and keys over 256
bytes, which route host_rank), multi-column nullable keys, duplicate-key
cross products, empty sides and INT64_MAX keys beside nulls;
`hash_join.key_hashes` word for word; both `host_hash_join` paths; the
device hash join's capacity doubling and learned capacity; the outer,
semi and anti transforms, `filter_join_pairs` and `get_matched_rows`;
`models.query.simple_star_join_agg`; the JNI door's
`sort_merge_inner_join`; and the calibrator's verdict cache, pin,
error and budget rules and its device keying.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columns import dtypes as jdt
from spark_rapids_tpu.ops import hash_join as JHJ
from spark_rapids_tpu.ops import joins as JJ
from spark_rapids_tpu.perf import calibrate as JCAL
from spark_rapids_tpu.models import query as JQ
from spark_rapids_tpu.shim import jni_api as JA
from spark_rapids_tpu_torch import ops as O
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.ops import hash_join as HJ
from spark_rapids_tpu_torch.ops import joins as J
from spark_rapids_tpu_torch.perf import calibrate as CAL
from spark_rapids_tpu_torch.perf import jit_cache
from spark_rapids_tpu_torch.models import query as Q
from spark_rapids_tpu_torch.shim import jni_api as A
from torch_port_data import jax_table, np_of, port_table

PIN = "SPARK_RAPIDS_TPU_PATH_JOIN_INNER"
NULLS = [J.NULL_EQUAL, J.NULL_UNEQUAL]
INT_KINDS = ["int8", "int16", "int32", "int64", "uint8", "uint16",
             "uint32", "uint64"]
KEY_KINDS = INT_KINDS + ["float32", "float64", "decimal128", "string",
                         "long_string"]
F64_KEYS = np.array([0x0000000000000000, 0x8000000000000000,
                     0x7FF8000000000000, 0x7FF8000000000001,
                     0xFFF8000000000000, 0x3FF8000000000000,
                     0x7FF0000000000000], np.uint64)
F32_KEYS = np.array([0x00000000, 0x80000000, 0x7FC00000, 0x7FC00001,
                     0xFFC00000, 0x40200000, 0xFF800000], np.uint32)
STR_KEYS = [b"", b"a", b"a\x00", b"ab", b"\xffz", b"\x80a", b"\xff",
            b"zzzzzzzzzzzz", b"zzzzzzzzzzzza", b"Q" * 20]
DEC_KEYS = [0, 1, -1, 2**64, -(2**64), 2**100, -(2**127), 2**127 - 1]


@pytest.fixture(autouse=True)
def _fresh_router(tmp_path, monkeypatch):
    """Every test starts unpinned, with a throwaway verdict file."""
    for env in (PIN, "SPARK_RAPIDS_TPU_FORCE_DEVICE_JOIN"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CALIB_CACHE",
                       str(tmp_path / "calib.json"))
    CAL.forget()
    JCAL.forget()


def strings(rows_bytes, validity=None):
    lens = np.array([len(b) for b in rows_bytes], np.int64)
    offs = np.zeros(len(rows_bytes) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = np.frombuffer(b"".join(rows_bytes), np.uint8).copy()
    return "string", chars, validity, offs.astype(np.int32)


def key_spec(rng, kind, n, nullable):
    """A low-cardinality key column (rows share keys across sides)."""
    validity = ((rng.random(n) < 0.8).astype(np.uint8) if nullable
                else None)
    if kind == "string":
        return strings([STR_KEYS[i] for i in rng.integers(0, 10, n)],
                       validity)
    if kind == "long_string":
        pool = [bytes(rng.integers(0, 256, m).astype(np.uint8))
                for m in (257, 300, 400)] + [b"short"]
        return strings([pool[i] for i in rng.integers(0, 4, n)], validity)
    if kind == "decimal128":
        vals = [DEC_KEYS[i] for i in rng.integers(0, len(DEC_KEYS), n)]
        limbs = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(4)]
                          for v in vals], np.uint32).reshape(n, 4)
        return kind, limbs.view(np.int32), validity
    if kind == "float64":
        return kind, rng.choice(F64_KEYS, n), validity
    if kind == "float32":
        return kind, rng.choice(F32_KEYS, n).view(np.float32), validity
    dt = np.dtype(dtypes.DType(kind).np_dtype)
    info = np.iinfo(dt)
    pool = np.array([info.min, info.max, 0, 1, 2, info.max // 2], dt)
    return kind, rng.choice(pool, n), validity


def oracle(lspecs, rspecs, nulls):
    li, ri = JJ._sort_merge_inner_join_host(jax_table(lspecs),
                                            jax_table(rspecs), nulls)
    return np.asarray(li), np.asarray(ri)


def same_pairs(got, want):
    for g, w in zip(got, want):
        g, w = np_of(g), np_of(w)
        assert g.dtype == np.int32 and g.shape == w.shape, (g.dtype, g.shape,
                                                            w.shape)
        assert g.tobytes() == w.tobytes()


def pinned_join(monkeypatch, engine, lspecs, rspecs, nulls):
    monkeypatch.setenv(PIN, engine)
    return J.sort_merge_inner_join(port_table(lspecs), port_table(rspecs),
                                   nulls)


@pytest.mark.parametrize("engine", J.JOIN_PATHS)
@pytest.mark.parametrize("kind", KEY_KINDS)
@pytest.mark.parametrize("nullable", [False, True])
def test_engine_matches_reference(monkeypatch, engine, kind, nullable):
    rng = np.random.default_rng(KEY_KINDS.index(kind) * 7 + nullable)
    lspecs = [key_spec(rng, kind, 61, nullable)]
    rspecs = [key_spec(rng, kind, 47, nullable)]
    for nulls in NULLS:
        same_pairs(pinned_join(monkeypatch, engine, lspecs, rspecs, nulls),
                   oracle(lspecs, rspecs, nulls))


@pytest.mark.parametrize("engine", J.JOIN_PATHS)
def test_multi_column_nullable_keys(monkeypatch, engine):
    rng = np.random.default_rng(3)
    kinds = ["int32", "string", "float64", "decimal128"]
    lspecs = [key_spec(rng, k, 90, True) for k in kinds]
    rspecs = [key_spec(rng, k, 70, i % 2 == 0) for i, k in enumerate(kinds)]
    # narrow the cardinality so multi-column keys still meet
    for specs in (lspecs, rspecs):
        specs[0] = ("int32", specs[0][1] % 2, specs[0][2])
    for nulls in NULLS:
        want = oracle(lspecs, rspecs, nulls)
        assert want[0].size > 0
        same_pairs(pinned_join(monkeypatch, engine, lspecs, rspecs, nulls),
                   want)


@pytest.mark.parametrize("engine", J.JOIN_PATHS)
def test_duplicate_keys_cross_product(monkeypatch, engine):
    lspecs = [("int64", np.array([5, 7, 5, 5, 9, 7], np.int64), None)]
    rspecs = [("int64", np.array([7, 5, 5, 3, 7, 5], np.int64), None)]
    got = pinned_join(monkeypatch, engine, lspecs, rspecs, J.NULL_EQUAL)
    want = oracle(lspecs, rspecs, J.NULL_EQUAL)
    assert want[0].size == 3 * 3 + 2 * 2
    same_pairs(got, want)


@pytest.mark.parametrize("engine", J.JOIN_PATHS)
@pytest.mark.parametrize("nl,nr", [(0, 5), (5, 0), (0, 0)])
def test_empty_sides(monkeypatch, engine, nl, nr):
    rng = np.random.default_rng(nl + 2 * nr)
    for kind in ("int32", "string"):
        lspecs = [key_spec(rng, kind, nl, True)]
        rspecs = [key_spec(rng, kind, nr, True)]
        for nulls in NULLS:
            got = pinned_join(monkeypatch, engine, lspecs, rspecs, nulls)
            same_pairs(got, oracle(lspecs, rspecs, nulls))


@pytest.mark.parametrize("engine", J.JOIN_PATHS)
def test_null_vs_extreme_keys(monkeypatch, engine):
    """A valid INT64_MAX / INT64_MIN key beside null rows: the null
    encoding has no sentinel, so neither merges with a null."""
    big, small = 2**63 - 1, -(2**63)
    cases = [([big, None, 3, big], [None, big, big, 3, None]),
             ([small], [None]), ([None], [None]), ([big], [None, None]),
             ([None, big], [big])]
    for lvals, rvals in cases:
        lspecs = [("int64", np.array([v or 0 for v in lvals], np.int64),
                   np.array([v is not None for v in lvals], np.uint8))]
        rspecs = [("int64", np.array([v or 0 for v in rvals], np.int64),
                   np.array([v is not None for v in rvals], np.uint8))]
        for nulls in NULLS:
            got = pinned_join(monkeypatch, engine, lspecs, rspecs, nulls)
            same_pairs(got, oracle(lspecs, rspecs, nulls))


@pytest.mark.parametrize("engine", J.JOIN_PATHS)
def test_int64_max_keys_all_valid(monkeypatch, engine):
    """INT64_MAX is also device_sort's sort sentinel for invalid rows."""
    lspecs = [("int64", np.array([2**63 - 1, 1, 2**63 - 1], np.int64),
               None)]
    rspecs = [("int64", np.array([2**63 - 1, 2**63 - 1, 1, 0], np.int64),
               None)]
    same_pairs(pinned_join(monkeypatch, engine, lspecs, rspecs,
                           J.NULL_UNEQUAL),
               oracle(lspecs, rspecs, J.NULL_UNEQUAL))


@pytest.mark.parametrize("seed", range(4))
def test_random_differential(monkeypatch, seed):
    """Random schemas and sizes: every engine equal to the reference."""
    rng = np.random.default_rng(100 + seed)
    kinds = list(rng.choice(["int8", "int32", "uint64", "float32",
                             "string", "decimal128"], rng.integers(1, 4)))
    nl, nr = (int(x) for x in rng.integers(1, 200, 2))
    lspecs = [key_spec(rng, k, nl, bool(rng.integers(0, 2))) for k in kinds]
    rspecs = [key_spec(rng, k, nr, bool(rng.integers(0, 2))) for k in kinds]
    for nulls in NULLS:
        want = oracle(lspecs, rspecs, nulls)
        for engine in J.JOIN_PATHS:
            same_pairs(pinned_join(monkeypatch, engine, lspecs, rspecs,
                                   nulls), want)


def test_long_strings_route_host_rank(monkeypatch):
    """Keys over DEVICE_STR_KEY_MAX_LEN take host_rank even when a device
    engine is pinned; shorter strings take the pin."""
    taken = []
    real = J._join_engines()
    monkeypatch.setattr(J, "_join_engines", lambda: {
        n: (lambda *a, n=n, f=f: taken.append(n) or f(*a))
        for n, f in real.items()})
    rng = np.random.default_rng(8)
    for kind in ("long_string", "string"):
        specs = [key_spec(rng, kind, 20, False)]
        pinned_join(monkeypatch, "device_hash", specs, specs, J.NULL_EQUAL)
    assert taken == ["host_rank", "device_hash"]


def test_small_joins_take_the_static_default(monkeypatch):
    taken = []
    real = J._join_engines()
    monkeypatch.setattr(J, "_join_engines", lambda: {
        n: (lambda *a, n=n, f=f: taken.append(n) or f(*a))
        for n, f in real.items()})
    t = port_table([("int32", np.arange(100, dtype=np.int32), None)])
    J.sort_merge_inner_join(t, t)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_JOIN", "1")
    J.sort_merge_inner_join(t, t)
    assert taken == ["host_rank", "device_sort"]


def test_router_calibrates_large_joins(tmp_path):
    """At JOIN_CALIBRATE_MIN_ROWS the router times the four engines,
    keys the verdict by the CPU's torch backend, and its pairs equal
    the reference's."""
    rng = np.random.default_rng(9)
    n = J.JOIN_CALIBRATE_MIN_ROWS
    lspecs = [("int32", rng.integers(0, n // 4, n).astype(np.int32), None)]
    rspecs = [("int32", rng.permutation(n // 2).astype(np.int32), None)]
    got = J.sort_merge_inner_join(port_table(lspecs), port_table(rspecs))
    same_pairs(got, oracle(lspecs, rspecs, J.NULL_EQUAL))
    verdicts = json.loads((tmp_path / "calib.json").read_text())
    (key, rec), = verdicts.items()
    assert key.startswith("join.inner:") and key.endswith("@torch-cpu")
    assert rec["verdict"] in J.JOIN_PATHS


def test_ops_exports():
    for name in ("sort_merge_inner_join", "hash_inner_join",
                 "filter_join_pairs", "make_left_outer", "make_full_outer",
                 "make_semi", "make_anti", "get_matched_rows"):
        assert getattr(O, name) is getattr(J, name)
    assert (O.NULL_EQUAL, O.NULL_UNEQUAL) == (JJ.NULL_EQUAL, JJ.NULL_UNEQUAL)


# ------------------------------------------------------------ hash_join


@pytest.mark.parametrize("k", [1, 4, 5])
def test_key_hashes_match_reference(k):
    rng = np.random.default_rng(k)
    words = [rng.integers(-2**63, 2**63 - 1, 300, dtype=np.int64,
                          endpoint=True) for _ in range(k)]
    words[0][:3] = [0, -1, -(2**63)]
    want = np.asarray(JHJ.key_hashes([jnp.asarray(w) for w in words]))
    got = HJ.key_hashes([torch.from_numpy(w) for w in words]).numpy()
    assert got.dtype == np.int64 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", ["direct_unique", "direct_unique_out_of_span",
                                  "direct_runs", "general", "wide_span",
                                  "right_invalid", "left_invalid"])
def test_host_hash_join_paths(case):
    rng = np.random.default_rng(len(case))
    nl, nr = 400, 300
    lk = rng.integers(1000, 1300, nl).astype(np.int64)
    rk = rng.permutation(np.arange(1000, 1000 + nr, dtype=np.int64))
    lwords, rwords = [lk], [rk]
    lvalid, rvalid = np.ones(nl, bool), np.ones(nr, bool)
    if case == "direct_unique_out_of_span":
        lk[::7] = -5
        lk[::11] = 10**6
    elif case == "direct_runs":
        rwords = [rng.integers(1000, 1050, nr).astype(np.int64)]
    elif case == "general":
        lwords = [lk % 17, lk]
        rwords = [rk % 17, rng.integers(1000, 1300, nr).astype(np.int64)]
    elif case == "wide_span":
        rwords = [rk * (1 << 40)]
        lwords = [np.where(np.arange(nl) % 2 == 0, lk * (1 << 40), lk)]
    elif case == "right_invalid":
        rvalid = rng.random(nr) < 0.7
    elif case == "left_invalid":
        lvalid = rng.random(nl) < 0.7
    want = JHJ.host_hash_join(lwords, rwords, lvalid, rvalid)
    got = HJ.host_hash_join(lwords, rwords, lvalid, rvalid)
    assert want[0].size > 0
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.tobytes() == w.tobytes()


def test_device_hash_join_doubles_then_learns():
    """All-equal keys: 64 x 80 pairs from a start of 2^7 slots takes six
    doublings; the second call starts from the learned capacity."""
    HJ._LEARNED_CAPACITY.clear()
    lspecs = [("int32", np.full(64, 3, np.int32), None)]
    rspecs = [("int32", np.full(80, 3, np.int32), None)]
    lwords, rwords, vl, vr, extra = HJ.join_key_words(
        port_table(lspecs), port_table(rspecs), J.NULL_EQUAL)
    want = oracle(lspecs, rspecs, J.NULL_EQUAL)
    got = HJ.device_hash_join(lwords, rwords, vl, vr, extra)
    same_pairs(got, want)
    assert HJ.LAST_CAPACITY == {"initial": 128, "used": 8192, "doublings": 6}
    got = HJ.device_hash_join(lwords, rwords, vl, vr, extra)
    same_pairs(got, want)
    assert HJ.LAST_CAPACITY == {"initial": 8192, "used": 8192,
                                "doublings": 0}


def test_device_hash_join_survives_collisions(monkeypatch):
    """With every hash equal, the verify alone decides the pairs, and a
    left row's candidates keep their order."""
    monkeypatch.setattr(HJ, "key_hashes",
                        lambda w: torch.zeros(w[0].shape[0],
                                              dtype=torch.int64))
    rng = np.random.default_rng(4)
    lspecs = [key_spec(rng, "int32", 50, True)]
    rspecs = [key_spec(rng, "int32", 40, True)]
    for nulls in NULLS:
        lw, rw, vl, vr, extra = HJ.join_key_words(
            port_table(lspecs), port_table(rspecs), nulls)
        same_pairs(HJ.device_hash_join(lw, rw, vl, vr, extra),
                   oracle(lspecs, rspecs, nulls))


def test_join_key_words_match_reference_shape():
    rng = np.random.default_rng(5)
    kinds = ["int32", "string", "decimal128"]
    lspecs = [key_spec(rng, k, 30, i == 1) for i, k in enumerate(kinds)]
    rspecs = [key_spec(rng, k, 20, False) for k in kinds]
    for nulls in NULLS:
        lw, rw, vl, vr, extra = HJ.join_key_words(
            port_table(lspecs), port_table(rspecs), nulls)
        jlw, jrw, jvl, jvr, jextra = JHJ.join_key_words(
            jax_table(lspecs), jax_table(rspecs), nulls)
        assert extra == jextra and len(lw) == len(jlw)
        assert np_of(vl).tolist() == np.asarray(jvl).tolist()
        assert np_of(vr).tolist() == np.asarray(jvr).tolist()


# ---------------------------------------------------------- transforms


def _pairs_and_sizes(seed):
    rng = np.random.default_rng(seed)
    lspecs = [key_spec(rng, "int16", 80, True)]
    rspecs = [key_spec(rng, "int16", 60, True)]
    li, ri = oracle(lspecs, rspecs, J.NULL_UNEQUAL)
    return li, ri, 80, 60


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_outer_semi_anti_match_reference(seed):
    li, ri, nl, nr = _pairs_and_sizes(seed)
    same_pairs(J.make_left_outer(_t(li), _t(ri), nl),
               JJ.make_left_outer(li, ri, nl))
    same_pairs(J.make_full_outer(_t(li), _t(ri), nl, nr),
               JJ.make_full_outer(li, ri, nl, nr))
    same_pairs([J.make_semi(_t(li), nl)], [JJ.make_semi(li, nl)])
    same_pairs([J.make_anti(_t(li), nl)], [JJ.make_anti(li, nl)])


def test_filter_and_matched_rows_match_reference():
    li, ri, nl, nr = _pairs_and_sizes(2)
    pred = (li + ri) % 3 == 0
    same_pairs(J.filter_join_pairs(_t(li), _t(ri), _t(pred)),
               JJ.filter_join_pairs(li, ri, pred))
    lo, ro = JJ.make_full_outer(li, ri, nl, nr)
    for idx, n in ((np.asarray(lo), nl), (np.asarray(ro), nr)):
        got = J.get_matched_rows(_t(idx), n)
        want = JJ.get_matched_rows(idx, n)
        assert got.dtype == dtypes.BOOL8 and got.length == n
        assert np_of(got.data).tobytes() == np.asarray(want.data).tobytes()


def test_transforms_of_an_empty_join():
    z = torch.zeros(0, dtype=torch.int32)
    li, ri = J.make_full_outer(z, z, 3, 2)
    assert li.tolist() == [0, 1, 2, -1, -1]
    assert ri.tolist() == [-1, -1, -1, 0, 1]
    assert J.make_anti(z, 2).tolist() == [0, 1]
    assert J.make_semi(z, 2).dtype == torch.int32


# ------------------------------------------------- star join, JNI door


def test_simple_star_join_agg_matches_reference():
    rng = np.random.default_rng(6)
    fact = [("int32", rng.integers(0, 60, 500).astype(np.int32), None),
            ("int64", rng.integers(-10**6, 10**6, 500), None)]
    dim = [("int32", rng.permutation(50).astype(np.int32), None),
           ("int32", rng.integers(0, 7, 50).astype(np.int32), None)]
    got = Q.simple_star_join_agg(port_table(fact), port_table(dim))
    want = JQ.simple_star_join_agg(jax_table(fact), jax_table(dim))
    assert got.num_rows == want.num_rows == 7
    for g, w in zip(got.columns, want.columns):
        assert g.dtype.kind == w.dtype.kind
        assert np_of(g.data).tobytes() == np.asarray(w.data).tobytes()


@pytest.mark.parametrize("equal", [True, False])
def test_jni_door_sort_merge_inner_join(equal):
    cols = [("int64", [1, None, 3, 1, 2**63 - 1], [None, 1, 1, 2**63 - 1]),
            ("string", ["a", "b", None, "a", ""], [None, "a", "a", ""])]
    ours, ref = [[], []], [[], []]
    for kind, lvals, rvals in cols:
        for side, vals in ((0, lvals), (1, rvals)):
            ours[side].append(A.make_column_from_host(
                vals, dtypes.DType(kind), device="cpu"))
            ref[side].append(JA.make_column_from_host(vals, jdt.DType(kind)))
    got = A.sort_merge_inner_join(ours[0], ours[1], equal)
    want = JA.sort_merge_inner_join(ref[0], ref[1], equal)
    assert [A.column_to_host(h) for h in got] == \
        [JA.column_to_host(h) for h in want]
    assert all(A.REGISTRY.get(h).dtype == dtypes.INT32 for h in got)
    for h in got + ours[0] + ours[1]:
        A.release_column(h)
    for h in want + ref[0] + ref[1]:
        JA.release_column(h)


# ---------------------------------------------------------- calibrator


def test_schema_digest_matches_reference():
    from spark_rapids_tpu.perf import jit_cache as JJC
    schema = [dtypes.INT32, dtypes.decimal128(-2), dtypes.STRING]
    jschema = [jdt.INT32, jdt.decimal128(-2), jdt.STRING]
    for nulls, extra in (((), ""), ((True, False, True), "join:EQUAL")):
        assert jit_cache.schema_digest(schema, nulls, extra) == \
            JJC.schema_digest(jschema, nulls, extra)


def test_calibrator_pick_cache_and_errors(tmp_path):
    calls = {"fast": 0, "slow": 0}

    def fast():
        calls["fast"] += 1

    def slow():
        calls["slow"] += 1
        time.sleep(0.02)

    def broken():
        raise RuntimeError("no engine")

    cands = {"fast": fast, "slow": slow, "broken": broken}
    assert CAL.pick_path("test.op", "d1", cands, "slow",
                         device="cpu") == "fast"
    n = calls["fast"]
    # process-cache hit: no re-timing
    assert CAL.pick_path("test.op", "d1", cands, "slow",
                         device="cpu") == "fast"
    assert calls["fast"] == n
    assert CAL.last_verdict("test.op", "d1", "cpu") == "fast"
    # the file cache survives a process-cache reset
    CAL.forget("test.op")
    assert CAL.pick_path("test.op", "d1", cands, "slow",
                         device="cpu") == "fast"
    assert calls["fast"] == n
    d = json.loads((tmp_path / "calib.json").read_text())
    assert d["test.op:d1@torch-cpu"]["verdict"] == "fast"


def test_calibrator_env_pin(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PATH_TEST_OP2", "pinned")
    assert CAL.pick_path("test.op2", "d", {"a": lambda: None}, "a",
                         device="cpu") == "pinned"


def test_calibrator_all_broken_falls_to_default():
    def boom():
        raise ValueError("x")

    assert CAL.pick_path("test.op3", "d", {"a": boom, "b": boom}, "b",
                         device="cpu") == "b"


def test_calibrator_budget(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CALIB_BUDGET_S", "0.05")

    def slow():
        time.sleep(0.1)

    # the slow candidate's warm call trips the budget and the default
    # never got a turn: the default wins
    assert CAL.pick_path("test.op4", "d", {"slow": slow,
                                           "fast": lambda: None},
                         "fast", device="cpu") == "fast"
    # a default measured before the budget tripped wins on its time
    assert CAL.pick_path("test.op5", "d", {"fast": lambda: None,
                                           "slow": slow, "late": slow},
                         "late", device="cpu") == "fast"


def test_calibrator_ignores_jax_verdicts(tmp_path):
    """A verdict the JAX package stored for the same op and digest is
    keyed by its own backend ("@cpu"): the port measures anew and keys
    its verdict by the torch device."""
    JCAL.store_verdict("test.op6:d@cpu", "slow")
    assert JCAL.cached_verdict("test.op6:d@cpu") == "slow"
    calls = []
    got = CAL.pick_path("test.op6", "d",
                        {"slow": lambda: calls.append("slow"),
                         "fast": lambda: calls.append("fast")},
                        "slow", device=torch.device("cpu"))
    assert "fast" in calls and got in ("slow", "fast")
    d = json.loads((tmp_path / "calib.json").read_text())
    assert set(d) == {"test.op6:d@cpu", "test.op6:d@torch-cpu"}


def test_calibrator_backend_names_the_device():
    assert CAL._backend("cpu") == "torch-cpu"
    assert CAL._backend(torch.device("cpu")) == "torch-cpu"
    # nothing to fence without a CUDA tensor
    out = (torch.zeros(2), [torch.ones(1)], 3)
    assert CAL._synced(out) is out and CAL._cuda_devices(out) == set()
