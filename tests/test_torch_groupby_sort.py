"""PyTorch port: GROUP BY, ORDER BY and the helpers under them (ROADMAP
A6) against the JAX package on the same seeded host tables, byte for
byte: `ops.groupby.groupby_aggregate` for every aggregate over every
fixed-width value kind and over INT8-INT64, UINT*, FLOAT32/64 (NaN
payloads, +-0.0, nulls), STRING and DECIMAL128 keys, on both group-id
branches; `ops.sorting.order_by` and `sort_table` with every ASC/DESC x
nulls-first/last pairing; `ops.aggregation64` at its +-2^63 edges; and
`ops.copying`'s gather, slice, split and concat.

Float SUM/MEAN are byte-equal here: on the CPU both packages add each
group's values in row order."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columns import dtypes as jdt
from spark_rapids_tpu.columns.table import Table as JTable
from spark_rapids_tpu.ops import aggregation64 as JA
from spark_rapids_tpu.ops import copying as JCP
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.ops import sorting as JS
from spark_rapids_tpu_torch.columns import dtypes, interop
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import aggregation64 as A
from spark_rapids_tpu_torch.ops import copying as CP
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import joins as J
from spark_rapids_tpu_torch.ops import sorting as S
from torch_port_data import (EXTRA, F64_SPECIAL, host_column, jax_table,
                             port_table)

INT_KINDS = ["int8", "int16", "int32", "int64"]
VALUE_KINDS = INT_KINDS + ["float32", "float64", "bool8",
                           "timestamp_micros"] + EXTRA
AGGS = ["sum", "count", "min", "max", "mean"]
F32_KEYS = np.array([0x00000000, 0x80000000, 0x7FC00000, 0x7F800001,
                     0xFFC00000, 0x40200000, 0xFF800000], np.uint32)
STR_KEYS = [b"", b"a", b"a\x00", b"ab", b"b", b"\xffz", b"\x80a",
            b"zzzzzzzzzzzz", b"zzzzzzzzzzzza", b"Q" * 20]
ASCII_KEYS = [s for s in STR_KEYS if max(s, default=0) < 0x80]
DEC_KEYS = [0, 1, -1, 2**64, -(2**64), 2**100, -(2**100), 2**32 - 1,
            2**31, -(2**127)]


def _strings(rows_bytes, validity=None):
    lens = np.array([len(b) for b in rows_bytes], np.int64)
    offs = np.zeros(len(rows_bytes) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = np.frombuffer(b"".join(rows_bytes) or b"", np.uint8).copy()
    return "string", chars, validity, offs.astype(np.int32)


def key_spec(rng, kind, n, nullable=True, pool=None):
    """A low-cardinality key column, so rows share groups."""
    validity = ((rng.random(n) < 0.8).astype(np.uint8) if nullable
                else None)
    if kind == "string":
        pool = STR_KEYS if pool is None else pool
        return _strings([pool[i] for i in rng.integers(0, len(pool), n)],
                        validity)
    if kind == "decimal128":
        vals = [DEC_KEYS[i] for i in rng.integers(0, len(DEC_KEYS), n)]
        limbs = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(4)]
                          for v in vals], np.uint32).reshape(n, 4)
        return kind, limbs.view(np.int32), validity
    if kind == "float64":
        return kind, rng.choice(F64_SPECIAL[:6], n), validity
    if kind == "float32":
        return kind, rng.choice(F32_KEYS, n).view(np.float32), validity
    dt = np.dtype(dtypes.DType(kind).np_dtype)
    info = np.iinfo(dt)
    pool = np.array([info.min, info.max, 0, 1, 2, info.max // 2], dt)
    return kind, rng.choice(pool, n), validity


def jax_host(table):
    """The JAX package's table as host tuples (FLOAT64 as its bits)."""
    out = []
    for c in table.columns:
        v = None if c.validity is None else np.asarray(c.validity)
        if c.dtype.kind == "string":
            out.append((c.dtype.kind, np.asarray(c.data), v,
                        np.asarray(c.offsets)))
        else:
            out.append((c.dtype.kind, np.asarray(c.data), v))
    return out


def same_tables(got, want):
    """Port table == JAX table: kinds, data bytes, validity, offsets."""
    g, w = interop.table_to_host(got), jax_host(want)
    assert len(g) == len(w)
    for i, (gc, wc) in enumerate(zip(g, w)):
        assert gc[0] == wc[0], i
        assert gc[1].tobytes() == wc[1].astype(gc[1].dtype).tobytes(), i
        if wc[2] is None:
            assert gc[2] is None, i
        else:
            np.testing.assert_array_equal(gc[2], wc[2], err_msg=str(i))
        if len(wc) == 4:
            np.testing.assert_array_equal(gc[3], wc[3], err_msg=str(i))


def _groupby(keys_specs, value_specs, aggs, branch, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_GROUPBY",
                       "1" if branch == "device" else "0")
    pk, pv = port_table(keys_specs), port_table(value_specs)
    jk, jv = jax_table(keys_specs), jax_table(value_specs)
    got = G.groupby_aggregate(pk, pv.columns, aggs)
    want = JG.groupby_aggregate(jk, jv.columns, aggs)
    return got, want


def _values(rng, n, kinds):
    return [host_column(rng, k, n, nullable=True) for k in kinds]


# ---------------------------------------------------------------- group by


@pytest.mark.parametrize("branch", ["host", "device"])
@pytest.mark.parametrize("key_kind", INT_KINDS + ["uint16", "uint64",
                                                  "float32", "float64"])
def test_groupby_fixed_width_keys_match_reference(key_kind, branch,
                                                  monkeypatch):
    rng = np.random.default_rng(len(key_kind) * 7 + (branch == "host"))
    n = 301
    keys = [key_spec(rng, key_kind, n), key_spec(rng, "int32", n)]
    vals = _values(rng, n, ["int64", "float64"] * 3)[:5]
    got, want = _groupby(keys, vals, AGGS, branch, monkeypatch)
    same_tables(got, want)


@pytest.mark.parametrize("branch", ["host", "device"])
@pytest.mark.parametrize("value_kind", VALUE_KINDS)
def test_groupby_every_aggregate_over_every_value_kind(value_kind, branch,
                                                       monkeypatch):
    rng = np.random.default_rng(sum(map(ord, value_kind)))
    n = 257
    keys = [key_spec(rng, "int16", n)]
    vals = [host_column(rng, value_kind, n, nullable=True)] * len(AGGS)
    got, want = _groupby(keys, vals, AGGS, branch, monkeypatch)
    same_tables(got, want)


@pytest.mark.parametrize("branch", ["host", "device"])
def test_groupby_float_values_keep_nan_payloads_and_signed_zeros(
        branch, monkeypatch):
    """MIN/MAX return an input's exact bits: the largest NaN payload,
    -0.0 below 0.0; an all-null group is null."""
    bits = np.array([0x7FF8000000000001, 0x7FF0000000000002, 0x0,
                     0x8000000000000000, 0x8000000000000000, 0x0,
                     0x3FF0000000000000, 0xFFF8000000000000],
                    np.uint64)
    keys = [("int32", np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32), None)]
    vals = [("float64", bits,
             np.array([1, 1, 1, 1, 1, 1, 0, 0], np.uint8))] * 4
    got, want = _groupby(keys, vals, ["min", "max", "sum", "count"],
                         branch, monkeypatch)
    same_tables(got, want)
    mn = interop.table_to_host(got)[1][1]
    assert mn[1] == 0x8000000000000000 and mn[2] == 0x8000000000000000


@pytest.mark.parametrize("branch", ["host", "device"])
def test_groupby_float64_keys_nan_zero_null_mix(branch, monkeypatch):
    """The JAX package's differential case: FLOAT64 keys mixing NaN,
    0.0, -0.0 and nulls with a nullable INT64 second key."""
    rng = np.random.default_rng(31)
    for trial in range(4):
        n = int(rng.integers(1, 200))
        f = np.array([0.0, -0.0, 2.5, np.nan])[rng.integers(0, 4, n)]
        keys = [("float64", f.view(np.uint64),
                 (rng.random(n) >= 0.2).astype(np.uint8)),
                ("int64", rng.integers(-3, 3, n),
                 (rng.random(n) >= 0.2).astype(np.uint8))]
        vals = [("float64", rng.random(n).view(np.uint64),
                 (rng.random(n) >= 0.1).astype(np.uint8))] * 2
        got, want = _groupby(keys, vals, ["sum", "count"], branch,
                             monkeypatch)
        same_tables(got, want)


@pytest.mark.parametrize("branch", ["host", "device"])
@pytest.mark.parametrize("nullable", [False, True])
def test_groupby_string_keys_match_reference(branch, nullable,
                                             monkeypatch):
    """ASCII keys: the JAX package's two branches order them alike."""
    rng = np.random.default_rng(5 + nullable)
    n = 400
    keys = [key_spec(rng, "string", n, nullable, pool=ASCII_KEYS),
            key_spec(rng, "int8", n, nullable)]
    vals = _values(rng, n, ["int32", "float32", "int64"])
    got, want = _groupby(keys, vals, ["sum", "min", "mean"], branch,
                         monkeypatch)
    same_tables(got, want)


@pytest.mark.parametrize("key_kind", ["string", "decimal128"])
def test_branches_agree_on_high_bytes_and_decimal128(key_kind,
                                                     monkeypatch):
    """Strings with bytes >= 0x80 and DECIMAL128 keys: the port's device
    branch gives its host branch's rows in the same order, and both
    equal the JAX package's host branch (whose device branch orders
    these keys by signed words instead)."""
    rng = np.random.default_rng(9)
    n = 500
    keys = [key_spec(rng, key_kind, n), key_spec(rng, "bool8", n)]
    vals = _values(rng, n, ["int64", "float64"])
    host, want = _groupby(keys, vals, ["sum", "max"], "host", monkeypatch)
    same_tables(host, want)
    dev, _ = _groupby(keys, vals, ["sum", "max"], "device", monkeypatch)
    same_tables(dev, want)


def test_long_string_keys_take_the_host_branch(monkeypatch):
    """Keys longer than DEVICE_STR_KEY_MAX_LEN take the host rank path
    even when the device branch is forced."""
    rng = np.random.default_rng(3)
    pool = [bytes(rng.integers(65, 91, 300, dtype=np.uint8)) + bytes([c])
            for c in range(65, 71)] + [b"short"]
    keys = [key_spec(rng, "string", 120, pool=pool)]
    assert not J._device_key_kind_ok(port_table(keys).columns[0])
    vals = _values(rng, 120, ["int64"])
    calls = []
    monkeypatch.setattr(G, "_group_ids_device",
                        lambda k: calls.append(k) or None)
    got, want = _groupby(keys, vals, ["sum"], "device", monkeypatch)
    same_tables(got, want)
    assert not calls


def test_string_ranks_over_budget_take_the_exact_path(monkeypatch):
    """Dense ranks in unsigned byte order, a shorter prefix first, on
    the packed-word path and on the per-row path past its budget."""
    rng = np.random.default_rng(4)
    _k, chars, _v, offs = key_spec(rng, "string", 300, nullable=False)
    rows = [chars[offs[i]:offs[i + 1]].tobytes() for i in range(300)]
    want = np.array([sorted(set(rows)).index(r) for r in rows])
    np.testing.assert_array_equal(J._string_ranks(chars, offs), want)
    monkeypatch.setattr(J, "_STRING_RANK_WORDS_BUDGET", 8)
    np.testing.assert_array_equal(J._string_ranks(chars, offs), want)


def test_empty_and_keyless_groupby():
    keys = port_table([("int32", np.zeros(0, np.int32), None)])
    vals = port_table([("float64", np.zeros(0, np.uint64), None)])
    out = G.groupby_aggregate(keys, vals.columns, ["sum"])
    assert out.num_rows == 0 and out.num_columns == 2
    assert G.groupby_aggregate(Table([]), [], []).num_columns == 0
    with pytest.raises(ValueError):
        G.groupby_aggregate(keys, vals.columns, [])
    with pytest.raises(ValueError):
        G.groupby_aggregate(keys, vals.columns, ["median"])


def test_device_branch_on_cpu_only_when_forced(monkeypatch):
    keys = port_table([("int32", np.array([3, 1, 3], np.int32), None)])
    seen = []
    real = G._group_ids_device
    monkeypatch.setattr(G, "_group_ids_device",
                        lambda k: seen.append(1) or real(k))
    monkeypatch.delenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_GROUPBY",
                       raising=False)
    G._group_ids(keys)
    assert not seen
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_GROUPBY", "1")
    ids, first, n = G._group_ids(keys)
    assert seen and n == 2 and ids.tolist() == [1, 0, 1]
    assert first.tolist() == [1, 0]


# ---------------------------------------------------------------- order by

PAIRINGS = [(a, f) for a in (True, False) for f in (True, False)]


@pytest.mark.parametrize("kind", INT_KINDS + ["uint32", "uint64", "bool8",
                                              "float32", "float64",
                                              "string", "decimal128"])
@pytest.mark.parametrize("asc,nulls_first", PAIRINGS)
def test_order_by_matches_reference(kind, asc, nulls_first):
    rng = np.random.default_rng(len(kind) + 10 * asc + nulls_first)
    n = 211
    specs = [key_spec(rng, kind, n), key_spec(rng, "int8", n)]
    got = S.order_by(port_table(specs), [asc, not asc],
                     [nulls_first, not nulls_first])
    want = JS.order_by(jax_table(specs), [asc, not asc],
                       [nulls_first, not nulls_first])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["int64", "float64", "string"])
def test_order_by_spark_defaults_and_errors(kind):
    rng = np.random.default_rng(2)
    specs = [key_spec(rng, kind, 150), key_spec(rng, "int32", 150)]
    for asc in (None, [False, True], [True, True]):
        got = S.order_by(port_table(specs), asc)
        want = JS.order_by(jax_table(specs), asc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        S.order_by(port_table(specs), [True])
    assert S.order_by(Table([])).numel() == 0


@pytest.mark.parametrize("kind", ["string", "decimal128"])
def test_order_by_sorts_device_words_not_host_ranks(kind, monkeypatch):
    """Strings past DEVICE_STR_KEY_MAX_LEN, short strings with bytes
    >= 0x80 and DECIMAL128 keys sort by the device key words: no host
    rank is made, and the order is the JAX package's."""
    rng = np.random.default_rng(21)
    pool = None
    if kind == "string":
        pool = [bytes(rng.integers(0, 256, 300, dtype=np.uint8))
                + bytes([c]) for c in (0, 1, 0x80, 0xFF)]
        pool += [pool[0][:300], pool[0][:299] + b"\xff"] + STR_KEYS
    specs = [key_spec(rng, kind, 180, pool=pool), key_spec(rng, "int16", 180)]
    monkeypatch.setattr(J, "_column_rank_host", None)
    for asc, nf in PAIRINGS:
        got = S.order_by(port_table(specs), [asc, asc], [nf, not nf])
        want = JS.order_by(jax_table(specs), [asc, asc], [nf, not nf])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_order_by_nested_keys_name_roadmap_a1():
    from spark_rapids_tpu_torch.columns.column import Column
    lst = Column.make_list_from_parts(torch.tensor([0, 1], dtype=torch.int32),
                                      torch.zeros(1, dtype=torch.uint8))
    with pytest.raises(NotImplementedError, match="A1"):
        S.order_by(Table([lst]))


def test_sort_table_matches_reference():
    rng = np.random.default_rng(12)
    n = 199
    specs = ([key_spec(rng, "float64", n), key_spec(rng, "string", n)]
             + [host_column(rng, k, n, nullable=True)
                for k in ("int64", "decimal128", "string", "float32")])
    for key_idx, asc in (([0, 1], [False, True]), ([1], None),
                         ([3, 0], [True, False])):
        got = S.sort_table(port_table(specs), key_idx, asc)
        want = JS.sort_table(jax_table(specs), key_idx, asc)
        same_tables(got, want)


# ------------------------------------------------------------ aggregation64

EDGES = np.array([0, 1, -1, 2**31, 2**32 - 1, 2**32, -2**32,
                  2**63 - 1, -2**63, -2**63 + 1, 2**62, -2**62],
                 np.int64)


@pytest.mark.parametrize("out_kind", ["uint32", "int32", "int64"])
@pytest.mark.parametrize("chunk", [0, 1])
def test_extract_chunk32_matches_reference(out_kind, chunk):
    rng = np.random.default_rng(chunk)
    data = np.concatenate([EDGES, rng.integers(-2**63, 2**63 - 1, 50)])
    v = (rng.random(len(data)) < 0.9).astype(np.uint8)
    for spec in (("int64", data, v), ("uint64", data.view(np.uint64), None)):
        got = A.extract_chunk32_from_64bit(
            port_table([spec]).columns[0], dtypes.DType(out_kind), chunk)
        want = JA.extract_chunk32_from_64bit(
            jax_table([spec]).columns[0], jdt.DType(out_kind), chunk)
        same_tables(Table([got]), JTable([want]))


def test_assemble64_matches_reference_at_the_edges():
    """Chunk sums whose totals land on, just inside and just past
    +-2^63, with and without validity."""
    lows, highs = [], []
    for total in (2**63 - 1, 2**63, -2**63, -2**63 - 1, 0, -1, 2**64,
                  3 * 2**62, -(3 * 2**62), 12345):
        for low in (0, 2**32 - 1, 2**33 + 5, -(2**33), 2**40):
            lows.append(low)
            highs.append((total - low) >> 32)   # low carries the rest
    low = np.array(lows, np.int64)
    high = np.array(highs, object)
    high = np.array([int(h) for h in high], np.int64)
    v = np.tile(np.array([1, 0, 1], np.uint8), len(low))[:len(low)]
    for lv, hv in ((None, None), (v, None), (v, v[::-1].copy())):
        specs = [("int64", low, lv), ("int64", high, hv)]
        pt, jt = port_table(specs), jax_table(specs)
        for out in ("int64", "uint64"):
            got = A.assemble64_from_sum(*pt.columns, dtypes.DType(out))
            want = JA.assemble64_from_sum(*jt.columns, jdt.DType(out))
            same_tables(Table(list(got)), JTable(list(want)))
    ovf = A.assemble64_from_sum(*port_table(
        [("int64", low, None), ("int64", high, None)]).columns)[0]
    totals = [int(lo) + (int(hi) << 32) for lo, hi in zip(low, high)]
    assert ovf.data.tolist() == [int(not -2**63 <= t < 2**63)
                                 for t in totals]


# ---------------------------------------------------------------- copying

COPY_KINDS = ["int32", "float64", "decimal128", "string", "bool8",
              "uint64", "float32", "string"]


def _copy_specs(rng, n):
    return [host_column(rng, k, n, nullable=i % 2 == 0)
            for i, k in enumerate(COPY_KINDS)]


def test_gather_matches_reference():
    rng = np.random.default_rng(21)
    specs = _copy_specs(rng, 97)
    idx = np.concatenate([rng.integers(0, 97, 60), [0, 96]])
    got = CP.gather_table(port_table(specs), torch.from_numpy(idx))
    want = JCP.gather_table(jax_table(specs), idx.astype(np.int32))
    same_tables(got, want)
    # fixed-width gathers wrap a negative index, then clamp
    fixed = [s for s in specs if s[0] != "string"]
    wild = np.array([-1, -97, -200, 500, 3, -98], np.int64)
    same_tables(CP.gather_table(port_table(fixed), torch.from_numpy(wild)),
                JCP.gather_table(jax_table(fixed), wild.astype(np.int32)))
    with pytest.raises(IndexError):
        CP.gather(port_table(specs).columns[3], torch.tensor([97]))


@pytest.mark.parametrize("start,end", [(0, 0), (0, 97), (13, 57),
                                       (96, 97)])
def test_slice_matches_reference(start, end):
    rng = np.random.default_rng(start * 100 + end)
    specs = _copy_specs(rng, 97)
    same_tables(CP.slice_table(port_table(specs), start, end),
                JCP.slice_table(jax_table(specs), start, end))


def test_split_and_concat_match_reference():
    rng = np.random.default_rng(22)
    specs = _copy_specs(rng, 120)
    parts = CP.split_table(port_table(specs), [0, 17, 17, 90])
    jparts = JCP.split_table(jax_table(specs), [0, 17, 17, 90])
    assert [p.num_rows for p in parts] == [0, 17, 0, 73, 30]
    for p, jp in zip(parts, jparts):
        same_tables(p, jp)
    same_tables(CP.concat_tables(parts), JCP.concat_tables(jparts))
    same_tables(CP.concat_tables(parts), jax_table(specs))
    other = _copy_specs(np.random.default_rng(23), 40)
    mixed = [port_table(specs), port_table(other)]
    same_tables(CP.concat_tables(mixed), JCP.concat_tables(
        [jax_table(specs), jax_table(other)]))
    with pytest.raises(ValueError):
        CP.concat_tables([])


def test_concat_rebases_sliced_string_offsets():
    rng = np.random.default_rng(24)
    specs = [host_column(rng, "string", 50)]
    t = port_table(specs)
    a, b = CP.slice_table(t, 5, 20), CP.slice_table(t, 30, 50)
    a.columns[0].offsets = a.columns[0].offsets + 3     # not from 0
    a.columns[0].data = torch.cat([torch.zeros(3, dtype=torch.uint8),
                                   a.columns[0].data])
    got = CP.concat_columns([a.columns[0], b.columns[0]])
    assert got.to_pylist() == (t.columns[0].to_pylist()[5:20]
                               + t.columns[0].to_pylist()[30:50])
    assert int(got.offsets[0]) == 0


def test_nested_columns_name_roadmap_a1():
    from spark_rapids_tpu_torch.columns.column import Column
    lst = Column.make_list_from_parts(torch.tensor([0, 1], dtype=torch.int32),
                                      torch.zeros(1, dtype=torch.uint8))
    for fn in (lambda: CP.gather(lst, torch.tensor([0])),
               lambda: CP.slice_column(lst, 0, 1),
               lambda: CP.concat_columns([lst])):
        with pytest.raises(NotImplementedError, match="A1"):
            fn()
