"""PyTorch port on the card: each CUDA kernel byte for byte against its
plain version (with chip_smoke.py's tables and comparisons), launch
counts, the wrappers' input checks, the flagship step and the JNI-door
entries against the CPU, the TPC-DS stage path (q5, q72, q3, q9, q67,
CUBE, q89) in both engines and the named catalog against their CPU
runs, GROUP BY / ORDER BY / copying on the card against the CPU
(the device group-id branch also against the host branch on the same
card data), and the join layer: each join engine on the card against
host_rank, the router, the device hash join's learned capacity, the
outer/semi/anti transforms, the star join and the JNI door's join
against the CPU; and the kudo shuffle: the device split byte-equal to
the host writer, the device assemble and the merger on the card giving
the table back, the CRC trailer, the router, and the nested hashes on
the card against the CPU; and the memory runtime: a spill freeing card
memory and restoring onto the card, the out-of-core join and group-by
on the card against the in-memory calls, a CPU batch restored on the
CPU, the task threads under a limit and q5 over spilled partitions; and
the string casts and parse_url: string_to_float, float_to_string and
string_to_integer on card columns against their CPU runs, returning card
columns, parse_url on the card against the CPU, and the rows the host
decides written back into card columns; and the JSON family: each
get_json_object engine (the device scan replayed as CUDA graphs) and
each from_json engine on the card against its CPU run over the seeded
corpus, and chip_smoke.py's json phase at a small size; and ingest: the
parquet reader and the Arrow door onto the card against their CPU
reads, the file-backed queries on the card against the CPU and their
in-memory twins, the datetime ops on the card against the CPU, and
chip_smoke.py's ingest phase at a small size; and the rest of the op
breadth: the decimal limbs on the card (routed there by the columns'
device) against the CPU's limbs and host loop, SHA-256/512, the bloom
filter, HLL++ and z-order on the card against the CPU, and
chip_smoke.py's ops phase at a small size; and protobuf and the process
harness: the decoder's engine on card columns (flat, and nested with
repeated fields) against the host oracle and the CPU engine, q5 with
two ranks in one process on the card, and two worker processes sharing
the card; and the observability core: device telemetry and the Monitor's
HBM samples against torch.cuda's counters, the kudo hooks on card
columns (KTRX bytes, counters) against the same calls on CPU columns,
a fused stage's compile span and fusion record, and chip_smoke.py's
observability phase at a small size; and the rest of observability and
the caches: the stage cache's hit on the card giving the first run's
bytes, ``data_digest`` of a card tensor equal to its CPU copy's,
``pad_axis0`` keeping a tensor on its device, and chip_smoke.py's
observability_plane phase at a small size; and the query server: q9 on
the card served from pool threads against the main thread's rows, the
flagship step registered as a query and launching the fixed-width
to-rows kernel from two pool threads at once, a hung worker's task
force-released so a card query queued behind it finishes, and
chip_smoke.py's server phase at a small size; and the op layer's
sidecars: the profiler's op ranges around the flagship step on the card
(one each for the two hashes and the to-rows kernel's call, whose
launch count is unchanged), a seeded fault on convert_to_rows around
the to-rows kernel (raised before it launches, the next call byte-equal
to the plain version), and chip_smoke.py's tools phase at a small size;
and the rest of the JVM door (shim/jni_entry): convert_to_rows and
convert_from_rows through the entries on the card, byte-equal to the
same entries on the CPU with B1, B2 and B3 each launched once, the bulk
string ingest and readback on the card, device_attr_is_integrated
false on the card, and chip_smoke.py's jvm_door phase at a small size;
and the mesh programs: the JVM door's mesh entries at one rank over
NCCL against the single-device queries, and two rank processes sharing
the card over gloo (the exchange and the distributed join against one
process's, the aggregate, q5 op by op and fused, q72), chip_smoke.py's
step 23 at a small size.
Float SUM/MEAN on the card add with atomics in a varying order, so they
are held to chip_smoke.close_float_sums's bound; every other output is
byte-equal.

Marked `gpu`; each test skips without a CUDA device (decided in the
`cuda` fixture, never at import).  The file imports no JAX, so on a GPU
host without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import json

import numpy as np
import pytest
import torch

from chip_smoke import (EXTRACTORS, FLOAT_EDGES, INT_EDGES, KERNEL_CASES,
                        VAR_KERNEL_CASES, card_and_cpu, cast_values,
                        close_float_sums, compare_kernels,
                        compare_var_kernel, env, extract, int_strings,
                        join_route_log, make_table, nested_batch,
                        nested_hashes, on_cpu, same_column, same_nested,
                        shuffle_cell, store_sales_batch, string_host_specs,
                        string_key_column, url_column, with_edges)
from spark_rapids_tpu_torch import models as TM
from spark_rapids_tpu_torch.columns import dtypes, interop
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.models import flagship as F
from spark_rapids_tpu_torch.models import query as Q
from spark_rapids_tpu_torch.models import tpcds as TT
from spark_rapids_tpu_torch.ops import cast_string as CS
from spark_rapids_tpu_torch.ops import copying as CP
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import hash_join as HJ
from spark_rapids_tpu_torch.ops import joins as J
from spark_rapids_tpu_torch.ops import parse_uri as U
from spark_rapids_tpu_torch.ops import parse_uri_device as UD
from spark_rapids_tpu_torch.ops import sorting as S
from spark_rapids_tpu_torch.ops import stod_device as SD
from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA
from spark_rapids_tpu_torch.ops import row_conversion as RC
from spark_rapids_tpu_torch.perf import calibrate as CAL
from spark_rapids_tpu_torch.plan import catalog as TC
from spark_rapids_tpu_torch.shim import jni_api


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,ncols,nullable_every,dec128_every,view_offset",
    KERNEL_CASES + [(300, 5, 3, 2, 0), (300, 5, 3, 2, 3)])
def test_kernels_match_plain_versions(cuda, rows, ncols, nullable_every,
                                      dec128_every, view_offset):
    t = make_table(rows, ncols, "cuda", seed=rows + ncols,
                   nullable_every=nullable_every, dec128_every=dec128_every,
                   view_offset=view_offset)
    RA.reset_launches()
    assert compare_kernels(t) == (0, 0)
    assert RA.LAUNCHES == {"to_rows": 1, "from_rows": 1, "to_rows_var": 0}


@pytest.mark.gpu
def test_flagship_step_on_card_matches_cpu(cuda):
    got = F.flagship_step(*F.example_inputs(4097, device=cuda))
    want = F.flagship_step(*F.example_inputs(4097, device="cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_kernel_wrappers_check_their_inputs(cuda):
    t = make_table(16, 2, "cuda", seed=18)
    starts, voff, _ = RC.compute_layout([c.dtype for c in t.columns])
    strided = torch.zeros(32, dtype=torch.int64, device=cuda)[::2]
    bad = Column(dtypes.INT64, 16, data=strided)
    with pytest.raises(ValueError):
        RA.assemble_rows([bad, t.columns[1]], starts, voff, 16)
    with pytest.raises(ValueError):
        RA.disassemble_rows(torch.zeros(20, dtype=torch.uint8, device=cuda),
                            [dtypes.INT64], [0], 8, 16)


@pytest.mark.gpu
def test_to_rows_takes_columns_off_16_byte_alignment(cuda):
    """A column whose base is aligned to its width but not to 16 bytes (a
    view into a longer buffer) is taken, not refused."""
    t = make_table(37, 9, "cuda", seed=4, nullable_every=2, dec128_every=4,
                   view_offset=1)
    assert any(c.data.data_ptr() % 16 for c in t.columns)
    schema = [c.dtype for c in t.columns]
    starts, voff, _ = RC.compute_layout(schema)
    row_size = RC.row_size_of(schema)
    RA.reset_launches()
    got = RA.assemble_rows(t.columns, starts, voff, row_size)
    assert RA.LAUNCHES["to_rows"] == 1
    want = RA.assemble_rows_plain(t.columns, starts, voff, row_size)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,ncols,first,nullable_every,dec128_every,skew,max_len",
    VAR_KERNEL_CASES + [(0, 12, 0, 3, 0, 0, 32), (513, 4, 6, 2, 3, 9, 32)])
def test_var_kernel_matches_plain_version(cuda, rows, ncols, first,
                                          nullable_every, dec128_every,
                                          skew, max_len):
    t = interop.table_from_host(string_host_specs(
        rows, ncols, seed=rows + ncols, first=first,
        nullable_every=nullable_every, dec128_every=dec128_every,
        skew=skew, max_len=max_len), device=cuda)
    RA.reset_launches()
    assert compare_var_kernel(t) == 0
    assert RA.LAUNCHES["to_rows_var"] == (1 if rows else 0)


@pytest.mark.gpu
def test_jni_door_on_card_matches_cpu(cuda):
    specs = string_host_specs(999, 23, seed=5, dec128_every=7, skew=2)
    kinds = [s[0] for s in specs]
    scales = [0] * len(specs)
    out = {}
    for dev in (cuda, "cpu"):
        hs = [jni_api.REGISTRY.register(c) for c in
              interop.table_from_host(specs, device=dev).columns]
        mm = jni_api.murmur_hash3_32(42, hs[:7])
        xx = jni_api.xx_hash_64(42, hs[:7])
        rows = jni_api.convert_to_rows(hs)
        back = jni_api.convert_from_rows(rows, kinds, scales)
        out[str(dev)] = [jni_api.column_to_host(h)
                         for h in [mm, xx, rows] + back]
        for h in hs + [mm, xx, rows] + back:
            jni_api.release_column(h)
    assert out["cuda"] == out["cpu"]


@pytest.mark.gpu
def test_var_wrapper_checks_its_inputs(cuda):
    t = interop.table_from_host(string_host_specs(16, 7, seed=3), cuda)
    cols = t.columns
    starts, voff, fixed = RC.compute_layout([c.dtype for c in cols])
    offsets, total = RC.var_row_offsets(cols, fixed)
    s = cols[6]
    bad_cols = [
        Column(dtypes.STRING, 16, data=s.data,
               offsets=s.offsets.to(torch.int64)),        # offsets type
        Column(dtypes.STRING, 16, data=s.data,
               offsets=s.offsets[:-1]),                    # offsets shape
        Column(dtypes.STRING, 16, data=s.data.view(torch.int8),
               offsets=s.offsets),                         # chars type
        Column(dtypes.STRING, 16, data=s.data.cpu(),
               offsets=s.offsets),                         # chars device
    ]
    for bad in bad_cols:
        with pytest.raises(ValueError):
            RA.assemble_var_rows(cols[:6] + [bad], starts, voff, fixed,
                                 offsets, total)
    with pytest.raises(ValueError):
        RA.assemble_var_rows(cols, starts, voff, fixed,
                             offsets.to(torch.int64), total)


@pytest.mark.gpu
@pytest.mark.parametrize("fusion", ["1", "0"])
def test_stage_path_on_card_matches_cpu(cuda, fusion, monkeypatch):
    """q5 and q72 at the CPU tests' sizes (tests/test_torch_tpcds.py):
    on the card, fused or op by op, byte-equal to the op-by-op run on the
    CPU."""
    week0 = 11_000 // 7

    def q5(device):
        d = TT.gen_q5(rows=4000, stores=16, days=60, device=device)
        return TC.run_q5(d, 16, 1 << 13)

    def q72(device):
        d = TT.gen_q72(cs_rows=3000, inv_rows=3000, items=64, days=35,
                       device=device)
        return TC.run_q72(d, 64, 16, 1 << 18, week0=week0)

    for query in (q5, q72):
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
        want = query("cpu")
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", fusion)
        got = query(cuda)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("fusion", ["1", "0"])
def test_catalog_stages_on_card_match_cpu(cuda, fusion, monkeypatch):
    """q3, q9, q67, CUBE and q89 at 3001 rows: on the card, fused or op
    by op, byte-equal to the op-by-op run on the CPU."""
    queries = (
        lambda dev: TC.run_q3(TT.gen_q3(rows=3001, items=64, brands=8,
                                        device=dev), 10_957, 3, 8, 2),
        lambda dev: TC.run_q9(*TT.gen_q9(rows=3001, device=dev)),
        lambda dev: TC.run_q67(TT.gen_q67(rows=3001, ncat=6, ncls=5,
                                          device=dev), 6, 5),
        lambda dev: TC.run_cube(TT.gen_q67(rows=3001, ncat=4, ncls=3,
                                           device=dev), 4, 3),
        lambda dev: TC.run_q89(TT.gen_q89(rows=3001, stores=9, items=400,
                                          device=dev), 9, 400))
    for query in queries:
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
        want = query("cpu")
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", fusion)
        got = query(cuda)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_catalog_names_on_card_match_cpu(cuda, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    for name in TM.catalog_queries():
        for params in ({}, {"rows": 3001, "seed": 2}):
            assert TM.run_catalog_query(name, dict(params, device="cuda")) \
                == TM.run_catalog_query(name, dict(params, device="cpu"))


def _check_groupby(keys, values, aggs, counts_at, floats_at):
    """groupby_aggregate on the card == on the CPU (floats within the
    bound); the device ids == the host ids on the card data."""
    got = G.groupby_aggregate(keys, values, aggs)
    want = G.groupby_aggregate(Table([on_cpu(c) for c in keys.columns]),
                               [on_cpu(c) for c in values], aggs)
    for i, (g, w) in enumerate(zip(got.columns, want.columns)):
        if i in floats_at:
            close_float_sums(g, w, want.columns[counts_at].data,
                             floats_at[i], f"column {i}")
        else:
            same_column(g, w, f"column {i}")
    d, h = G._group_ids_device(keys), G._group_ids_host(keys)
    assert d[2] == h[2] and torch.equal(d[0], h[0]) and torch.equal(d[1],
                                                                    h[1])


@pytest.mark.gpu
def test_groupby_on_card_matches_cpu(cuda):
    t = store_sales_batch(1 << 16, seed=3)
    c = t.columns
    keys = Table([Column(dtypes.INT32, c[0].length,
                         data=c[0].data % 7, validity=c[2].validity),
                  c[1]])
    _check_groupby(keys, [c[2], c[4], c[3], c[3], c[4], c[4], c[4], c[4]],
                   ["sum", "count", "min", "max", "sum", "mean", "min",
                    "max"], 3, {6: False, 7: True})
    brand = string_key_column(1 << 15, 300, 0, 40, seed=4)
    s = store_sales_batch(1 << 15, seed=5).columns
    _check_groupby(Table([brand, s[0]]), [s[2], s[4], s[4]],
                   ["sum", "count", "sum"], 3, {4: False})


@pytest.mark.gpu
def test_groupby_float_and_decimal_keys_on_card(cuda):
    import numpy as np
    rng = np.random.default_rng(8)
    n = 5000
    bits = np.array([0, 0x8000000000000000, 0x7FF8000000000000,
                     0x7FF0000000000001, 0xFFF0000000000000,
                     0x4004000000000000], np.uint64)[rng.integers(0, 6, n)]
    limbs = rng.integers(-3, 3, (n, 4)).astype(np.int32)
    keys = interop.table_from_host(
        [("float64", bits, (rng.random(n) < 0.8).astype(np.uint8)),
         ("decimal128", limbs, None)], device="cuda")
    vals = interop.table_from_host(
        [("float64", rng.normal(size=n).view(np.uint64), None)],
        device="cuda").columns * 3
    got = G.groupby_aggregate(keys, vals, ["min", "max", "count"])
    want = G.groupby_aggregate(Table([on_cpu(c) for c in keys.columns]),
                               [on_cpu(c) for c in vals],
                               ["min", "max", "count"])
    for i, (g, w) in enumerate(zip(got.columns, want.columns)):
        same_column(g, w, f"column {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("asc,nulls_first", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_order_by_on_card_matches_cpu(cuda, asc, nulls_first):
    t = store_sales_batch(1 << 15, seed=6)
    brand = string_key_column(1 << 15, 100, 0, 20, seed=7)
    for cols in ([t.columns[4], t.columns[0]], [brand, t.columns[3]],
                 [t.columns[2]]):
        keys = Table(cols)
        a = [asc] * len(cols)
        f = [nulls_first] * len(cols)
        got = S.order_by(keys, a, f)
        want = S.order_by(Table([on_cpu(c) for c in cols]), a, f)
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)
    sorted_t = S.sort_table(t, [0, 3], [True, False])
    want_t = S.sort_table(Table([on_cpu(c) for c in t.columns]), [0, 3],
                          [True, False])
    for i, (g, w) in enumerate(zip(sorted_t.columns, want_t.columns)):
        same_column(g, w, f"sort_table column {i}")


@pytest.mark.gpu
def test_copying_on_card_matches_cpu(cuda):
    brand = string_key_column(4000, 50, 0, 30, seed=9)
    t = Table([brand, *store_sales_batch(4000, seed=10).columns])
    cpu = Table([on_cpu(c) for c in t.columns])
    idx = torch.randint(0, 4000, (3000,), device="cuda")
    pairs = [(CP.gather_table(t, idx), CP.gather_table(cpu, idx.cpu())),
             (CP.slice_table(t, 17, 2900), CP.slice_table(cpu, 17, 2900)),
             (CP.concat_tables(CP.split_table(t, [5, 1000])),
              CP.concat_tables(CP.split_table(cpu, [5, 1000])))]
    for got, want in pairs:
        for i, (g, w) in enumerate(zip(got.columns, want.columns)):
            same_column(g, w, f"column {i}")


# ----------------------------------------------------------------- joins

JOIN_KINDS = ("int32", "int64", "uint64", "float64", "decimal128", "string")
F64_KEYS = np.array([0, 1 << 63, 0x7FF8000000000000, 0x7FF8000000000001,
                     0x3FF8000000000000], np.uint64)


def join_key_spec(rng, kind, n, nullable):
    """A low-cardinality host key column (interop's layout)."""
    validity = ((rng.random(n) < 0.8).astype(np.uint8) if nullable
                else None)
    if kind == "string":
        pool = [b"", b"a", b"a\x00", b"\xffz", b"brand #7", b"Q" * 40]
        rows = [pool[i] for i in rng.integers(0, len(pool), n)]
        offs = np.zeros(n + 1, np.int64)
        np.cumsum([len(b) for b in rows], out=offs[1:])
        return ("string", np.frombuffer(b"".join(rows) or b"\0",
                                        np.uint8)[:offs[-1]].copy(),
                validity, offs.astype(np.int32))
    if kind == "decimal128":
        return kind, rng.integers(-2, 2, (n, 4)).astype(np.int32), validity
    if kind == "float64":
        return kind, rng.choice(F64_KEYS, n), validity
    dt = np.dtype(dtypes.DType(kind).np_dtype)
    pool = np.array([np.iinfo(dt).max, 0, 1, 2], dt)
    return kind, rng.choice(pool, n), validity


def join_tables(seed, kind, nullable, nl=3000, nr=2000, device="cuda"):
    rng = np.random.default_rng(seed)
    return (interop.table_from_host([join_key_spec(rng, kind, nl, nullable)],
                                    device=device),
            interop.table_from_host([join_key_spec(rng, kind, nr, nullable)],
                                    device=device))


def same_pairs(got, want):
    assert all(t.is_cuda and t.dtype == torch.int32 for t in got)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["host_hash", "device_sort",
                                    "device_hash"])
def test_join_engines_on_card_match_host_rank(cuda, engine):
    engines = J._join_engines()
    for i, kind in enumerate(JOIN_KINDS):
        for nullable in (False, True):
            left, right = join_tables(i, kind, nullable)
            for nulls in (J.NULL_EQUAL, J.NULL_UNEQUAL):
                same_pairs(engines[engine](left, right, nulls),
                           engines["host_rank"](left, right, nulls))


@pytest.mark.gpu
def test_join_router_on_card(cuda, tmp_path, monkeypatch):
    """Small joins take device_sort on the card; a large one calibrates
    and keys its verdict by the card's name."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CALIB_CACHE",
                       str(tmp_path / "calib.json"))
    monkeypatch.delenv("SPARK_RAPIDS_TPU_PATH_JOIN_INNER", raising=False)
    CAL.forget()
    left, right = join_tables(7, "int64", True)
    with join_route_log() as log:
        got = J.sort_merge_inner_join(left, right, J.NULL_UNEQUAL)
    assert log["engines"] == ["device_sort"] and log["verdict"] is None
    same_pairs(got, J._sort_merge_inner_join_host(left, right,
                                                  J.NULL_UNEQUAL))
    left, right = join_tables(8, "int32", False,
                              nl=J.JOIN_CALIBRATE_MIN_ROWS, nr=20)
    with join_route_log() as log:
        got = J.sort_merge_inner_join(left, right)
    assert log["verdict"] in J.JOIN_PATHS
    same_pairs(got, J._sort_merge_inner_join_host(left, right))
    (key,) = json.loads((tmp_path / "calib.json").read_text())
    assert key.endswith("@torch-cuda:" + torch.cuda.get_device_name(0))


@pytest.mark.gpu
def test_device_hash_join_learns_capacity_on_card(cuda):
    HJ._LEARNED_CAPACITY.clear()
    left, right = join_tables(9, "int32", False, nl=500, nr=400)
    words = HJ.join_key_words(left, right, J.NULL_EQUAL)
    want = J._sort_merge_inner_join_host(left, right)
    same_pairs(HJ.device_hash_join(*words), want)
    assert HJ.LAST_CAPACITY["doublings"] > 0
    same_pairs(HJ.device_hash_join(*words), want)
    assert HJ.LAST_CAPACITY["doublings"] == 0


@pytest.mark.gpu
def test_join_transforms_on_card_match_cpu(cuda):
    left, right = join_tables(10, "int32", True)
    li, ri = J.sort_merge_inner_join(left, right, J.NULL_UNEQUAL)
    nl, nr = left.num_rows, right.num_rows
    pred = (li + ri) % 3 == 0
    pairs = [(J.make_left_outer(li, ri, nl),
              J.make_left_outer(li.cpu(), ri.cpu(), nl)),
             (J.make_full_outer(li, ri, nl, nr),
              J.make_full_outer(li.cpu(), ri.cpu(), nl, nr)),
             ((J.make_semi(li, nl), J.make_anti(li, nl)),
              (J.make_semi(li.cpu(), nl), J.make_anti(li.cpu(), nl))),
             (J.filter_join_pairs(li, ri, pred),
              J.filter_join_pairs(li.cpu(), ri.cpu(), pred.cpu()))]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)
    lo = J.make_left_outer(li, ri, nl)[1]
    m = J.get_matched_rows(lo, nr)
    assert m.data.is_cuda and torch.equal(
        m.data.cpu(), J.get_matched_rows(lo.cpu(), nr).data)


@pytest.mark.gpu
def test_star_join_and_jni_join_on_card_match_cpu(cuda):
    rng = np.random.default_rng(11)
    fact = [("int32", rng.integers(0, 600, 5000).astype(np.int32), None),
            ("int64", rng.integers(-10**6, 10**6, 5000), None)]
    dim = [("int32", rng.permutation(500).astype(np.int32), None),
           ("int32", rng.integers(0, 40, 500).astype(np.int32), None)]
    out = {}
    for dev in (cuda, "cpu"):
        got = Q.simple_star_join_agg(interop.table_from_host(fact, dev),
                                     interop.table_from_host(dim, dev))
        out[str(dev)] = [c.to_pylist() for c in got.columns]
        left, right = join_tables(12, "string", True, device=dev)
        lh = jni_api.REGISTRY.register(left.columns[0])
        rh = jni_api.REGISTRY.register(right.columns[0])
        hs = jni_api.sort_merge_inner_join([lh], [rh], False)
        out[str(dev)] += [jni_api.column_to_host(h) for h in hs]
        for h in [lh, rh] + hs:
            jni_api.release_column(h)
    assert out["cuda"] == out["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", ["flat", "nested"])
def test_shuffle_split_assemble_merge_on_card(cuda, batch):
    """chip_smoke's shuffle checks at a small size: 200 partitions by
    Spark's hash, the blob == the host writer's bytes, the assembled and
    merged tables == the partition-ordered table, CRC catches a flip."""
    if batch == "flat":
        t = store_sales_batch(5000, seed=3)
        keys = [t.columns[1]]
    else:
        t = nested_batch(3000, seed=4)
        keys = [t.columns[0], t.columns[3]]
    ordered, res = shuffle_cell(batch, t, keys)
    assert ordered.device.type == "cuda" and res["blob_bytes"] > 0


@pytest.mark.gpu
def test_nested_hashes_on_card_match_cpu(cuda):
    nested_hashes(nested_batch(3000, seed=5))


@pytest.mark.gpu
def test_shuffle_router_on_card(cuda, monkeypatch):
    """Columns and blobs on the card take the device path, bytes given
    for "cuda" too; a slot of two tables takes the host merger."""
    from spark_rapids_tpu_torch.shuffle import device_split as DS
    from spark_rapids_tpu_torch.shuffle import split_assemble as SA
    from spark_rapids_tpu_torch.shuffle.schema import schema_of_table

    monkeypatch.delenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_SHUFFLE",
                       raising=False)
    t = nested_batch(2000, seed=6)
    cpu = Table([on_cpu(c) for c in t.columns])
    fields = schema_of_table(t)
    buf, offs = SA.shuffle_split(t, [500, 500, 1700])
    host, host_offs = SA.shuffle_split(cpu, [500, 500, 1700])
    assert buf == host and list(offs) == list(host_offs)
    blob = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(cuda)
    for got in (SA.shuffle_assemble(fields, blob, offs),
                SA.shuffle_assemble(fields, buf, offs, device="cuda")):
        assert got.device.type == "cuda"
        for a, b in zip(got.columns, DS.device_shuffle_assemble(
                fields, blob, offs).columns):
            same_nested(a, b, "routed assemble")
    two = buf + buf[:int(offs[1])]
    got = SA.shuffle_assemble(fields, two, [0, len(buf), len(two)])
    assert got.num_rows == 2500 and got.device.type == "cuda"


@pytest.mark.gpu
def test_spill_frees_card_memory_and_restores_on_card(cuda, tmp_path,
                                                      monkeypatch):
    """Spilling a registered card batch that nothing else references
    lowers memory_allocated by at least 90% of its bytes; restore gives
    it back on the card byte for byte; corrupt disk files recompute or
    raise with the file named."""
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    res = C.spill_frees_memory("cuda", rows=1 << 20, corrupt_rows=1 << 16)
    assert res["freed_bytes"] >= 0.9 * res["device_bytes"]
    assert res["corrupt"]["recomputes"] == 1


@pytest.mark.gpu
def test_out_of_core_join_on_card_matches_in_memory(cuda, tmp_path,
                                                    monkeypatch):
    """J2's shape out of core on the card (8 partitions, host tier and
    disk) against the in-memory join and the numpy oracle; the group-by
    out of core against the in-memory call (float bound)."""
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CALIB_CACHE",
                       str(tmp_path / "calib.json"))
    res = C.ooc_join_cell("cuda", rows=1 << 20, returns=1 << 17, iters=1)
    assert res["host"]["restores"] == res["disk"]["spills_disk"] == 8
    g = C.ooc_groupby_cell("cuda", rows=1 << 20, budget=1 << 24, iters=1)
    assert g["partitions"] == 4


@pytest.mark.gpu
def test_restored_cpu_batch_stays_on_cpu(cuda, tmp_path):
    """A CPU batch spilled beside a card batch comes back on the CPU,
    the card batch on the card: restore lands on the handle's device."""
    from spark_rapids_tpu_torch.memory.spill import SpillStore
    store = SpillStore(spill_dir=str(tmp_path), host_limit_bytes=0)
    card = store_sales_batch(5000, seed=3)
    cpu = Table([on_cpu(c) for c in card.columns])
    hc = store.register(card.columns, name="card")
    hh = store.register(cpu.columns, name="cpu")
    hc.spill()
    hh.spill()
    got_card, got_cpu = hc.get(), hh.get()
    assert all(c.device.type == "cuda" for c in got_card)
    assert all(c.device.type == "cpu" for c in got_cpu)
    for a, b in zip(got_card, got_cpu):
        same_column(a, b, "restored card batch == restored CPU batch")
    store.close()


@pytest.mark.gpu
def test_task_threads_and_q5_spilled_on_card(cuda, tmp_path, monkeypatch):
    """chip_smoke's task threads under a limit of three batches and q5
    over spilled partitions, at small sizes on the card."""
    import chip_smoke as C
    from spark_rapids_tpu_torch.memory.spill import SpillStore
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    res = C.task_threads("cuda", rows=1 << 16)
    assert res["limited"]["spills_host"] >= 1
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    q5 = C.q5_spilled(dict(rows=1 << 16, stores=402, days=60, seed=5),
                      1 << 15, 4, "cuda",
                      SpillStore(spill_dir=str(tmp_path)), iters=1)
    assert q5["partitions"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["float64", "float32"])
def test_float_casts_on_card_match_cpu(cuda, kind):
    net, net32, _, _, g = cast_values("cuda", 1 << 16, seed=3)
    col = net if kind == "float64" else net32
    dt = dtypes.DType(kind)
    with env(SPARK_RAPIDS_TPU_FTOS="device", SPARK_RAPIDS_TPU_STOD="device"):
        text = card_and_cpu(CS.float_to_string, [col], "float_to_string")
        mixed, _ = with_edges(text, FLOAT_EDGES, g)
        back = card_and_cpu(lambda c: CS.string_to_float(c, dt), [mixed],
                            "string_to_float")
    assert text.data.is_cuda and back.data.is_cuda


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int64", "int32", "int8"])
def test_string_to_integer_on_card_matches_cpu(cuda, kind):
    _, _, ints, valid, g = cast_values("cuda", 1 << 16, seed=4)
    mixed, _ = with_edges(int_strings(ints, valid), INT_EDGES, g)
    out = card_and_cpu(
        lambda c: CS.string_to_integer(c, dtypes.DType(kind)), [mixed],
        "string_to_integer")
    assert out.data.is_cuda


@pytest.mark.gpu
def test_parse_url_on_card_matches_cpu(cuda):
    col = url_column(1 << 15, seed=5, device="cuda")
    for what in EXTRACTORS + ("query_key",):
        out = card_and_cpu(lambda c: extract(c, what, "q"), [col], what)
        assert out.data.is_cuda


@pytest.mark.gpu
def test_host_decided_rows_patched_on_card(cuda):
    """Rows the device engines flag (a 25-digit mantissa, a subnormal; an
    IPv6 host, a non-ASCII host) come back from the host parse into the
    card column, equal to the CPU run."""
    vals = ["1.5", "1234567890123456789012345", "4.9e-324", "2.75"] * 10
    col = Column.from_strings(vals, "cuda")
    with env(SPARK_RAPIDS_TPU_STOD="device"):
        CS.string_to_float(on_cpu(col), dtypes.FLOAT64)
        flagged = SD.LAST_CALL["fallback_rows"]
        out = CS.string_to_float(col, dtypes.FLOAT64)
    assert SD.LAST_CALL["fallback_rows"] == flagged >= 20
    assert out.data.is_cuda
    want = np.array([float(v) for v in vals]).view(np.int64)
    assert (out.data.view(torch.int64).cpu().numpy() == want).all()
    urls = ["http://h.com/p", "http://[::1]:80/x", "http://h\u00e9.com/p",
            "https://u@[2001:db8::7]/q?a=1"] * 200
    col = Column.from_strings(urls, "cuda")
    for what in EXTRACTORS:
        UD.reset_stats()
        got = extract(col, what)
        assert UD.STATS["fallback_rows"] == 600 and got.data.is_cuda
        with env(SPARK_RAPIDS_TPU_FORCE_DEVICE_PARSE_URI=None,
                 SPARK_RAPIDS_TPU_PARSE_URI_DEVICE_MIN=str(10 * len(urls))):
            same_nested(got, extract(on_cpu(col), what), what)


# ------------------------------------------------------------------ JSON


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["host", "device_scan", "tokenizer"])
def test_json_engines_on_card_match_cpu(cuda, engine):
    """Each get_json_object engine on the card == its CPU run on the
    seeded corpus (edge vocabulary and invalid UTF-8 included), with as
    many host rows; the outputs live on the card."""
    from torch_port_data import json_event_docs
    from spark_rapids_tpu_torch.ops import json_path as JP

    col = Column.from_strings(json_event_docs(11, 3000, edge_every=6),
                              "cuda")
    paths = ["$.event", "$.user.id", "$.user.name", "$.items[0]",
             "$.ctx.a.b.c"] + (["$.items[*].sku"]
                               if engine != "tokenizer" else [])
    with env(SPARK_RAPIDS_TPU_PATH_JSON_GET_OBJECT=engine,
             SPARK_RAPIDS_TPU_JSON="host" if engine == "host" else None):
        for path in paths:
            out = card_and_cpu(lambda c: JP.get_json_object(c, path), [col],
                               f"{engine} {path}")
            assert out.data.is_cuda


@pytest.mark.gpu
def test_json_phase_functions_on_card(cuda):
    """chip_smoke's json phase at a small size: the card against the
    CPU for every engine, the from_json family and the map ops."""
    import chip_smoke as C
    res = C.json_phase("cuda", rows=1 << 13, chunk_rows=1 << 12,
                       cpu_rows=1 << 11, map_rows=1 << 10, iters=1)
    assert res["rows"] == 1 << 13


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["raw_map", "structs", "nested"])
def test_from_json_engines_on_card_match_cpu(cuda, which):
    from torch_port_data import json_event_docs
    from spark_rapids_tpu_torch.ops import json_utils as JU

    col = Column.from_strings(json_event_docs(13, 2000, edge_every=6),
                              "cuda")
    fields = [("event", dtypes.STRING), ("ts", dtypes.INT64)]
    schema = ("struct", [("user", ("struct", [
        ("id", dtypes.INT64), ("name", dtypes.STRING),
        ("tags", ("list", dtypes.STRING))])), ("items", ("list", (
            "struct", [("sku", dtypes.STRING), ("qty", dtypes.INT32),
                       ("price", dtypes.FLOAT64)])))])
    fn = {"raw_map": JU.from_json_to_raw_map,
          "structs": lambda c: JU.from_json_to_structs(c, fields),
          "nested": lambda c: JU.from_json_to_structs_nested(c, schema)}[
        which]
    op = "RAW_MAP" if which == "raw_map" else "FROM_JSON"
    for engine in ("host", "device_scan", "tokenizer"):
        if which == "nested" and engine == "tokenizer":
            continue
        with env(**{f"SPARK_RAPIDS_TPU_PATH_JSON_{op}": engine}):
            card_and_cpu(fn, [col], f"{which} {engine}")


# ----------------------------------------------------------------- ingest

INGEST_SMALL = dict(
    files_kw=dict(rows=1 << 15, str_rows=1 << 13, cut_rows=1 << 13,
                  row_group=1 << 13),
    queries={"tpcds_q3_file": dict(rows=1 << 14, seed=3),
             "tpcds_q7_file": {}, "tpcds_q9_file": dict(rows=1 << 14)},
    dt_kw=dict(rows=1 << 15, cpu_rows=1 << 13, iters=1))


def _mixed_parquet(path, rows=3000):
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(13)
    nulls = rng.random(rows) < 0.04
    pq.write_table(pa.table({
        "i64": pa.array(rng.integers(-2**62, 2**62, rows), mask=nulls),
        "i32": pa.array(rng.integers(-2**31, 2**31, rows).astype(np.int32)),
        "f64": pa.array(rng.normal(size=rows), mask=nulls),
        "b": pa.array(rng.integers(0, 2, rows).astype(bool), mask=nulls),
        "s": pa.array([None if n else f"s{i % 97}" for i, n in
                       enumerate(nulls)]),
        "d": pa.array(rng.integers(-200000, 50000, rows).astype(np.int32),
                      pa.date32()),
        "ts": pa.array(rng.integers(-2**55, 2**55, rows),
                       pa.timestamp("us"), mask=nulls)}),
        str(path), row_group_size=1000, data_page_version="2.0")


@pytest.mark.gpu
def test_read_table_on_card_matches_cpu(cuda, tmp_path):
    from spark_rapids_tpu_torch.io import parquet_reader as PR
    path = tmp_path / "t.parquet"
    _mixed_parquet(path)
    stats = {}
    got = PR.read_table(str(path), device="cuda", stats=stats)
    assert stats["upload_ns"] > 0
    want = PR.read_table(str(path), device="cpu")
    assert got.names == want.names
    for g, w, n in zip(got.columns, want.columns, got.names):
        assert g.data.is_cuda, n
        same_column(g, w, n)
    assert got["f64"].data.dtype == torch.float64


@pytest.mark.gpu
def test_arrow_ingest_on_card(cuda):
    import pyarrow as pa
    from spark_rapids_tpu_torch.io import arrow_cabi as A
    from spark_rapids_tpu_torch.shim import jni_api as JA
    batch = pa.record_batch({
        "x": pa.array(np.arange(5000, dtype=np.int64)),
        "f": pa.array([None if i % 7 == 0 else i * 0.5
                       for i in range(5000)]),
        "s": pa.array([None if i % 3 == 0 else f"r{i}"
                       for i in range(5000)]),
        "dec": pa.array(list(range(5000)), pa.int64()).cast(
            pa.decimal128(20, 0))}).slice(17, 4000)
    cols, names = A.ingest(batch)
    cpu, _ = A.ingest(batch, device="cpu")
    for g, w, n in zip(cols, cpu, names):
        assert g.device.type == "cuda", n
        same_column(g, w, n)
    before = JA.REGISTRY.live_count()
    handles = JA.arrow_ingest(batch)
    assert [JA.column_to_host(h) for h in handles] == \
        [c.to_pylist() for c in cpu]
    for h in handles:
        JA.release_column(h)
    assert JA.REGISTRY.live_count() == before


@pytest.mark.gpu
def test_file_queries_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    from spark_rapids_tpu_torch.models import filesource as FS
    monkeypatch.setenv("SPARK_RAPIDS_TPU_INGEST_DIR", str(tmp_path))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    FS.reset_dir()
    try:
        for name in ("tpcds_q3_file", "tpcds_q7_file", "tpcds_q9_file"):
            for params in ({}, {"rows": 3001, "seed": 2}):
                got = TM.run_catalog_query(name, dict(params, device="cuda"))
                assert got == TM.run_catalog_query(
                    name, dict(params, device="cpu"))
                assert got == TM.run_catalog_query(
                    name[:-len("_file")], dict(params, device="cuda"))
    finally:
        FS.reset_dir()


@pytest.mark.gpu
def test_datetime_ops_on_card_match_cpu(cuda):
    import chip_smoke as C
    rng = np.random.default_rng(5)
    rows = 5000
    valid = torch.from_numpy((rng.random(rows) >= 0.04).astype(np.uint8))
    d = Column(dtypes.TIMESTAMP_DAYS, rows, validity=valid,
               data=torch.from_numpy(rng.integers(-171000, 47000, rows)
                                     .astype(np.int32)))
    ts = Column(dtypes.TIMESTAMP_MICROS, rows, validity=valid,
                data=torch.from_numpy(rng.integers(*C.DT_US_RANGE, rows)))
    comp = C.component_column(rows, 3, "cuda")
    want = dict(C.datetime_calls(d, ts, C.on_cpu(comp)))

    def card(c):
        return Column(c.dtype, rows, data=c.data.cuda(),
                      validity=c.validity.cuda())

    for name, call in C.datetime_calls(card(d), card(ts), comp):
        out = call()
        assert out.data.is_cuda, name
        same_column(out, want[name](), name)


@pytest.mark.gpu
def test_ingest_phase_functions_on_card(cuda, tmp_path, monkeypatch):
    """chip_smoke's ingest phase at a small size: every read on the card
    against its source and the CPU read, the JNI door, the file queries
    against their twins and the datetime ops against the CPU."""
    import chip_smoke as C
    monkeypatch.setattr(C, "ingest_dir", lambda: str(tmp_path / "ingest"))
    res = C.ingest_phase("cuda", **INGEST_SMALL)
    assert res["files"]["store_sales_dict"]["whole"]["peak_mib"] > 0
    assert set(res["queries"]) >= {"tpcds_q3_file", "tpcds_q9_file"}


# ------------------------------------------------- the rest of the ops


OPS_SMALL = dict(rows=1 << 14, dec_rows=1 << 14, str_rows=1 << 13,
                 url_rows=1 << 12, ts_rows=1 << 13, bin_rows=1 << 13,
                 uuid_rows=1 << 13, cpu_rows=1 << 11, wide_cpu_rows=1 << 12,
                 host_rows=1 << 11, customers=20_000, iters=1)


def _dec_pair(rows, seed):
    import chip_smoke as C
    batch = store_sales_batch(rows, seed, "cuda")
    return C.decimal_columns(batch["ss_net_paid"], rows, seed, "cuda",
                             edge_every=8)


@pytest.mark.gpu
@pytest.mark.parametrize("op,scales", [
    ("multiply", (-2, -2, -4)), ("add", (-2, -2, -2)),
    ("sub", (-2, -2, -3)), ("divide", (-4, -4, -20)),
    ("integer_divide", (-2, -2, 0)), ("remainder", (-2, -2, -2))])
def test_decimal_limbs_on_card_match_cpu(cuda, op, scales, monkeypatch):
    """The router sends card columns to the limbs; their bytes equal the
    CPU limbs', their flags and non-overflow values the host loop's."""
    import chip_smoke as C
    from spark_rapids_tpu_torch.ops import decimal_device as DD
    from spark_rapids_tpu_torch.ops import decimal_utils as DU
    monkeypatch.delenv(C.FORCE_DEC, raising=False)
    a, b = _dec_pair(5000, len(op))
    sa, sb, out_scale = scales
    a = Column(dtypes.decimal128(sa), a.length, data=a.data,
               validity=a.validity)
    b = Column(dtypes.decimal128(sb), b.length, data=b.data,
               validity=b.validity)
    fn = getattr(DU, f"{op}_decimal128")
    calls = []
    for name in ("multiply128_device", "add128_device", "sub128_device",
                 "divide128_device", "remainder128_device"):
        real = getattr(DD, name)
        monkeypatch.setattr(DD, name, lambda *x, real=real, name=name:
                            calls.append(name) or real(*x))
    got = fn(a, b, out_scale)
    assert calls and got[1].data.is_cuda
    assert C.same_decimal(got, lambda x, y: fn(x, y, out_scale), (a, b),
                          5000, op) >= 0


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [224, 256, 384, 512])
def test_sha_on_card_matches_cpu(cuda, bits):
    import chip_smoke as C
    from spark_rapids_tpu_torch.ops import sha as SHA
    fn = getattr(SHA, f"sha{bits}_nulls_preserved")
    keys = string_key_column(3000, 100, 0, 130, 3, "cuda")
    price = store_sales_batch(3000, 4, "cuda")["ss_sales_price"]
    for col in (keys, price):
        got = card_and_cpu(fn, [col], f"sha{bits}")
        assert got.data.is_cuda
        assert got.to_pylist() == C.hashlib_rows(col, bits, 3000)


@pytest.mark.gpu
def test_bloom_and_hllpp_on_card_match_cpu(cuda):
    import chip_smoke as C
    from spark_rapids_tpu_torch.ops import bloom_filter as BF
    from spark_rapids_tpu_torch.ops import hllpp as HLL
    cust, dim = C.customer_keys(1 << 16, "cuda", 5, customers=30_000)
    bits = C.bloom_num_bits(dim.length, C.BLOOM_FPP)
    k = C.bloom_num_hashes(dim.length, bits)
    card = BF.put(BF.create(k, (bits + 63) // 64, 2, 3, "cuda"), dim)
    cpu = BF.put(BF.create(k, (bits + 63) // 64, 2, 3, "cpu"), on_cpu(dim))
    assert card.words.is_cuda and BF.serialize(card) == BF.serialize(cpu)
    assert bool(BF.probe(card, dim).data.all())
    same_nested(BF.probe(card, cust), BF.probe(cpu, on_cpu(cust)), "probe")
    for p in (9, 12):
        sk = card_and_cpu(lambda c: HLL.reduce_hllpp(c, p), [cust], "hll")
        est = card_and_cpu(lambda s: HLL.estimate_from_hll_sketches(s, p),
                           [sk], "estimate")
        exact = int(torch.unique(cust.data[cust.valid_mask()]).shape[0])
        assert abs(int(est.data[0]) - exact) / exact < C.HLL_MAX_ERR
    gids = torch.randint(0, 402, (cust.length,), device="cuda")
    got = HLL.group_hllpp(cust, gids, 402, 9)
    want = HLL.group_hllpp(on_cpu(cust), gids.cpu(), 402, 9)
    same_nested(got, want, "grouped sketches")


@pytest.mark.gpu
def test_zorder_on_card_matches_cpu(cuda):
    from spark_rapids_tpu_torch.ops import zorder as Z
    b = store_sales_batch(5000, 6, "cuda")
    cols = [b["ss_item_sk"], b["ss_quantity"]]
    card_and_cpu(lambda *c: Z.interleave_bits(list(c)), cols, "interleave")
    card_and_cpu(lambda *c: Z.hilbert_index(18, list(c)), cols, "hilbert")
    net = [b["ss_net_paid"], b["ss_net_paid"]]
    card_and_cpu(lambda *c: Z.interleave_bits(list(c)), net, "f64 bits")


@pytest.mark.gpu
def test_ops_phase_functions_on_card(cuda):
    """chip_smoke's ops phase at a small size: every call on the card
    against the CPU (and the decimals against the host loop)."""
    import chip_smoke as C
    res = C.ops_phase("cuda", **OPS_SMALL)
    assert res["dec_divide_q49"]["route"] == "device limbs"
    assert res["dec_divide_q49"]["kernels"] > 0
    assert res["sha512_int64"]["peak_added_mb"] > 0


# ------------------------------------------- protobuf and distribution


@pytest.mark.gpu
@pytest.mark.parametrize("schema", ["flat", "nested_repeated"])
def test_protobuf_engine_on_card_matches_cpu(cuda, schema):
    """The field-step engine on a card column (routed there by its
    device, replayed as CUDA graphs) equal to the host oracle on a CPU
    copy in canonical form, and to the engine on CPU tensors byte for
    byte; only the fallback-free device route is taken."""
    import chip_smoke as C
    from spark_rapids_tpu_torch.ops import protobuf as PBF
    from spark_rapids_tpu_torch.ops import protobuf_device as PD
    fields = C.pb_fields()
    if schema == "flat":
        fields = [f for f in fields if not f.is_message and not f.repeated]
    col = C.protobuf_events(3000, 5, "cuda", edge_every=8)
    got = PBF.decode_protobuf_to_struct(col, fields)
    assert PD.LAST_CALL["route"] == "device" and not PD.LAST_CALL["fallback"]
    assert got.device.type == "cuda"
    want = PBF.decode_protobuf_host(on_cpu(col), fields)
    same_nested(on_cpu(C.pb_canonical(got)), C.pb_canonical(want), schema)
    engine_cpu = PD.decode_protobuf_to_struct_device(on_cpu(col), fields)
    same_nested(on_cpu(got), engine_cpu, f"{schema}: card == CPU engine")


@pytest.mark.gpu
def test_protobuf_small_card_column_takes_the_engine(cuda):
    """A card column of a few rows goes to the engine (the router reads
    the column's device alone), equal to the oracle on a CPU copy."""
    import chip_smoke as C
    from spark_rapids_tpu_torch.ops import protobuf as PBF
    from spark_rapids_tpu_torch.ops import protobuf_device as PD
    fields = C.pb_fields()
    col = C.protobuf_events(3, 7, "cuda", edge_every=2)
    got = PBF.decode_protobuf_to_struct(col, fields)
    assert PD.LAST_CALL["route"] == "device" and not PD.LAST_CALL["fallback"]
    want = PBF.decode_protobuf_host(on_cpu(col), fields)
    same_nested(on_cpu(C.pb_canonical(got)), C.pb_canonical(want), "3 rows")


@pytest.mark.gpu
def test_dist_q5_two_ranks_in_process_on_card(cuda, tmp_path):
    """q5 with two ranks in one process over unix sockets, data and
    stages on the card, byte-equal to single_q5 on the card."""
    import os
    import threading
    from spark_rapids_tpu_torch.distributed import runner as R
    from spark_rapids_tpu_torch.distributed.service import ShuffleService
    from spark_rapids_tpu_torch.shuffle import kudo
    prior = kudo.set_crc_enabled(True)
    addrs = [f"unix:{os.path.join(str(tmp_path), f'g{r}.sock')}"
             for r in range(2)]
    svcs = [ShuffleService(r, 2, addrs).start() for r in range(2)]
    params = dict(rows=1 << 16, stores=402, join_capacity=1 << 16)
    outs = [None, None]
    try:
        ts = [threading.Thread(target=lambda r=r: outs.__setitem__(
            r, R.run_dist_q5(params, transport=svcs[r], device="cuda")))
            for r in range(2)]
        [t.start() for t in ts]
        [t.join(300) for t in ts]
    finally:
        for s in svcs:
            s.stop()
        kudo.set_crc_enabled(prior)
    want = R.single_q5(dict(params, world=2), device="cuda")
    for r in range(2):
        for k in ("key", "sales", "rets", "profit", "overflow"):
            assert outs[r][k].tobytes() == want[k].tobytes(), (r, k)


@pytest.mark.gpu
def test_launch_two_workers_on_card(cuda, tmp_path):
    """Two worker processes sharing the card: q5 and q72 byte-equal to
    the single-process runs, each worker on cuda, in harness mode."""
    import os
    from spark_rapids_tpu_torch.distributed import launcher as DL
    from spark_rapids_tpu_torch.distributed import runner as R
    params = {"q5": dict(rows=1 << 16, stores=402,
                         join_capacity=1 << 16),
              "q72": dict(cs_rows=1 << 12, inv_rows=1 << 10, items=512,
                          join_capacity=1 << 18)}
    torch.cuda.empty_cache()
    res = DL.launch(2, str(tmp_path), ops=("q5", "q72"), params=params,
                    device="cuda", timeout_s=300.0)
    want = {"q5": R.single_q5(dict(params["q5"], world=2), "cuda"),
            "q72": R.single_q72(dict(params["q72"], world=2), "cuda")}
    for r in range(2):
        s = res["summaries"][r]
        assert s["device"] == "cuda" and s["mesh"]["mode"] == "harness"
        assert s["peak_mib"] > 0
        for op in ("q5", "q72"):
            got = dict(np.load(os.path.join(str(tmp_path),
                                            f"result_{op}_rank{r}.npz")))
            for k, v in want[op].items():
                assert got[k].tobytes() == v.tobytes(), (r, op, k)


# ------------------------------------------------------- observability


@pytest.fixture
def obs_on():
    from spark_rapids_tpu_torch import observability as obs
    prior = (obs.is_enabled(), obs.is_tracing_enabled())
    obs.enable()
    obs.enable_tracing()
    obs.reset()
    yield obs
    obs.reset()
    (obs.enable if prior[0] else obs.disable)()
    (obs.enable_tracing if prior[1] else obs.disable_tracing)()


@pytest.mark.gpu
def test_telemetry_reads_the_card(cuda):
    from spark_rapids_tpu_torch.shim import jni_entry as JE
    from spark_rapids_tpu_torch.utils import telemetry as T
    held = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    assert T.get_device_count() == torch.cuda.device_count()
    info = T.get_device_info(0)
    now = torch.cuda.memory_allocated(0)
    assert info.platform == "gpu"
    assert info.kind == torch.cuda.get_device_name(0)
    assert info.memory_stats["bytes_in_use"] == now
    total = torch.cuda.get_device_properties(0).total_memory
    assert info.memory_stats["bytes_limit"] == total
    mem = T.get_memory_info(0)
    assert mem["free"] == mem["total"] - mem["used"]
    assert 0.0 < T.get_device_utilization(0) < 1.0
    for fn in (T.get_power_usage_watts, T.get_clock_mhz):
        with pytest.raises(T.TelemetryNotSupported):
            fn(0)
    assert JE.telemetry_device_name(0) == f"gpu:{info.kind}"
    packed = JE.telemetry_snapshot_packed(0)
    assert packed[0] == total and packed[1] >= held.numel()
    assert packed[4:] == [-1, -1, -1]
    del held


@pytest.mark.gpu
def test_monitor_hbm_samples_match_memory_allocated(cuda, obs_on):
    import time as _time
    from spark_rapids_tpu_torch.utils import telemetry as T
    held = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    samples = []
    m = T.Monitor(50, lambda infos: samples.append(
        (infos[0].memory_stats["bytes_in_use"],
         torch.cuda.memory_allocated(0))))
    m.start()
    _time.sleep(0.4)
    m.stop()
    assert len(samples) >= 3
    for got, want in samples:
        assert abs(got - want) <= 0.01 * want
    text = obs_on.expose_text()
    assert 'srt_hbm_bytes_in_use{device="0"}' in text
    del held


@pytest.mark.gpu
def test_kudo_hooks_on_card_columns_match_cpu(cuda, obs_on):
    import io

    from spark_rapids_tpu_torch.shuffle import kudo as K
    from spark_rapids_tpu_torch.shuffle.schema import schema_of_table
    card = store_sales_batch(1 << 16, seed=21)
    cpu = Table([on_cpu(c) for c in card.columns])
    ctx = obs_on.SpanContext(0x0102030405060708, 0x1112131415161718)
    streams, counts = [], []
    for t in (card, cpu):
        obs_on.reset()
        # under one activated context the KTRX prefix names it; the
        # metered writer's prefix names its own kudo_write span (a
        # random id), so its stream is compared by length
        buf, metered = io.BytesIO(), io.BytesIO()
        with obs_on.TRACER.activate(ctx):
            for lo in range(0, t.num_rows, 1 << 14):
                K.write_to_stream(t.columns, buf, lo, 1 << 14)
                K.write_to_stream_with_metrics(t.columns, metered, lo,
                                               1 << 14)
        streams.append(buf.getvalue())
        assert len(metered.getvalue()) == len(streams[-1])
        merged, _m = K.merge_to_table_with_metrics(
            K.read_tables(io.BytesIO(metered.getvalue())),
            schema_of_table(t), t.columns[0].data.device)
        assert merged.columns[0].data.device == t.columns[0].data.device
        for a, b in zip(merged.columns, t.columns):
            same_nested(a, b, "merged")
        snap = obs_on.METRICS.snapshot()
        counts.append([snap[f]["series"][0]["value"] for f in (
            "srt_shuffle_write_bytes_total",
            "srt_shuffle_merge_rows_total")])
    assert streams[0] == streams[1]
    assert streams[0].startswith(K.TRACE_MAGIC)
    assert counts[0] == counts[1] == [len(streams[0]), 1 << 16]


@pytest.mark.gpu
def test_fused_stage_compile_span_and_record(cuda, obs_on, monkeypatch):
    from spark_rapids_tpu_torch.plan import compiler as C
    from spark_rapids_tpu_torch.plan import ir as IR
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    plan = IR.StagePlan(
        "gpu_obs_double", inputs=(IR.ScanBind("t", (IR.ColSpec("x"),)),),
        nodes=(IR.Project("y", IR.Bin("mul", IR.Col("x"), IR.Lit(3))),),
        outputs=("y",))
    st = C.compile_stage(plan)
    for _ in range(2):
        out = st.run({"t": (torch.arange(1000, device=cuda),)})
    # a fused stage's outputs keep the input's row bucket (1024 rows)
    assert out[0].shape[0] == 1024
    assert torch.equal(out[0][:1000].cpu(), torch.arange(1000) * 3)
    text = obs_on.expose_text()
    assert 'srt_stage_fusion_total{stage="gpu_obs_double",' \
        'outcome="fused"} 2' in text
    assert 'srt_stage_fusion_total{stage="gpu_obs_double",' \
        'outcome="compile"} 1' in text
    spans = [r for r in obs_on.TRACER.records()
             if r["name"] == "stage_compile"]
    assert len(spans) == 1 and spans[0]["attrs"]["stage"] == \
        "gpu_obs_double"


@pytest.mark.gpu
def test_observability_phase_on_card_small(cuda, tmp_path, monkeypatch):
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    res = C.observability_phase("cuda", flagship_rows=1 << 16,
                                shuffle_rows=1 << 16, task_rows=1 << 14,
                                iters=1)
    assert res["on"]["merged_rows"] == 1 << 16
    assert res["hbm_worst_rel_diff"] <= 0.01 and res["quiet_samples"] > 0



@pytest.mark.gpu
def test_stage_cache_hit_gives_the_same_bytes_on_the_card(cuda,
                                                          monkeypatch):
    from spark_rapids_tpu_torch.models import tpcds as TT
    from spark_rapids_tpu_torch.perf import result_cache as RC
    from spark_rapids_tpu_torch.plan import catalog as TC
    from spark_rapids_tpu_torch.plan import compiler as C
    monkeypatch.setenv("SPARK_RAPIDS_TPU_RESULT_CACHE", "1")
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    RC.CACHE.clear(reset_stats=True)
    d = TT.gen_q5(rows=1 << 16, stores=32, days=60, seed=3, device=cuda)
    pipe = C.compile_pipeline(TC.q5_pipeline(32, 1 << 16))
    args = {"s": (d.s_date, d.s_store, d.s_price, d.s_profit),
            "r": (d.r_date, d.r_store, d.r_amt, d.r_loss),
            "d": (d.d_date,), "dims": (d.st_id,)}
    try:
        first = pipe.run(args)
        hits = RC.CACHE.stats()["hits"]
        second = pipe.run(args)
        assert RC.CACHE.stats()["hits"] == hits + 2
        for a, b in zip(first, second):
            assert b.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b)
    finally:
        RC.CACHE.clear(reset_stats=True)


@pytest.mark.gpu
def test_data_digest_of_a_card_tensor_equals_its_cpu_copy(cuda):
    from spark_rapids_tpu_torch.perf.result_cache import data_digest
    g = torch.Generator(device=cuda).manual_seed(5)
    ts = [torch.randint(-9, 9, (4097,), generator=g, device=cuda),
          torch.rand(513, generator=g, dtype=torch.float64, device=cuda),
          torch.tensor([-0.0, float("nan")], dtype=torch.float64,
                       device=cuda),
          torch.ones(7, dtype=torch.bool, device=cuda)]
    assert data_digest(ts) == data_digest([t.cpu() for t in ts])


@pytest.mark.gpu
def test_pad_axis0_keeps_the_tensor_on_its_device(cuda):
    from spark_rapids_tpu_torch.perf.jit_cache import pad_axis0
    t = torch.arange(10, dtype=torch.int32, device=cuda)
    p = pad_axis0(t, 16)
    assert p.device == t.device and p.shape == (16,)
    assert torch.equal(p.cpu(), torch.cat([torch.arange(10),
                                           torch.zeros(6)]).int())
    assert pad_axis0(t, 10) is t


@pytest.mark.gpu
def test_observability_plane_phase_on_card_small(cuda, tmp_path,
                                                 monkeypatch):
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    res = C.observability_plane_phase(
        "cuda", q5=dict(rows=1 << 16, stores=32, join_capacity=1 << 16),
        flagship_rows=1 << 16)
    assert res["stage_cache"]["hit_counts"]["hits"] == 2
    assert res["stage_cache"]["incremental_folds"] == 2
    assert res["incidents"]["kinds"] == ["kudo_corrupt",
                                         "retry_exhausted"]


def card_server(**kw):
    from spark_rapids_tpu_torch import server as srv
    return srv.QueryServer(srv.ServerConfig(**dict(
        dict(max_concurrency=2, max_queue=16, stall_ms=0,
             quarantine_failures=0), **kw))).start()


@pytest.mark.gpu
def test_server_runs_q9_on_card_from_pool_threads(cuda):
    from spark_rapids_tpu_torch import models as TM
    reqs = [{"rows": 1 << 16, "seed": s, "device": "cuda"}
            for s in range(4)]
    want = [TM.run_catalog_query("tpcds_q9", dict(p)) for p in reqs]
    s = card_server()
    try:
        ids = [s.submit(f"t{i % 2}", "tpcds_q9", dict(p))
               for i, p in enumerate(reqs)]
        got = [s.wait(qid, 120) for qid in ids]
    finally:
        s.stop()
    assert [g["state"] for g in got] == ["done"] * len(reqs)
    assert [g["result"] for g in got] == want
    assert want == [TM.run_catalog_query(
        "tpcds_q9", dict(p, device="cpu")) for p in reqs]


@pytest.mark.gpu
def test_flagship_query_launches_to_rows_from_two_pool_threads(cuda):
    import threading

    from spark_rapids_tpu_torch import models as TM
    from spark_rapids_tpu_torch.models import flagship as F
    from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA
    inputs = F.example_inputs(1 << 18, device="cuda")
    want = F.flagship_step(*inputs)[2]
    barrier = threading.Barrier(2)
    kept = {}

    def run(params, ctx):
        barrier.wait(60)          # both pool threads launch at once
        kept[ctx.query_id] = F.flagship_step(*inputs)[2]
        torch.cuda.synchronize()
        return None

    TM.register_query("t_gpu_flagship", run)
    s = card_server()
    try:
        before = RA.LAUNCHES["to_rows"]
        ids = [s.submit(t, "t_gpu_flagship") for t in ("a", "b")]
        assert [s.wait(q, 120)["state"] for q in ids] == ["done"] * 2
        assert RA.LAUNCHES["to_rows"] - before == 2
        for qid in ids:
            assert torch.equal(kept[qid], want)
    finally:
        s.stop()
        TM.unregister_query("t_gpu_flagship")


@pytest.mark.gpu
def test_force_release_unblocks_a_card_query_behind_a_hung_one(cuda):
    import threading

    from spark_rapids_tpu_torch import models as TM
    from spark_rapids_tpu_torch.memory import rmm_spark
    rmm_spark.clear_event_handler()
    adaptor = rmm_spark.set_event_handler(1 << 40)
    release, held = threading.Event(), threading.Event()

    def hog(params, ctx):
        adaptor.allocate(1 << 20)
        keep = torch.ones(1 << 18, device="cuda")   # card-resident
        held.set()
        release.wait(60)          # silent: no heartbeat, no cancel poll
        return [int(keep.sum())]

    TM.register_query("t_gpu_hog", hog)
    p9 = {"rows": 1 << 16, "seed": 3, "device": "cuda"}
    want = TM.run_catalog_query("tpcds_q9", dict(p9))
    s = card_server(max_concurrency=1, hang_s=0.5,
                    watchdog_interval_s=0.02)
    try:
        hung = s.submit("piggy", "t_gpu_hog")
        assert held.wait(60)
        neighbour = s.submit("polite", "tpcds_q9", dict(p9))
        assert s.wait(hung, 60)["outcome"] == "hung"
        nb = s.wait(neighbour, 60)
        assert nb["state"] == "done" and nb["result"] == want
        assert not any(t["pool_tasks"]
                       for t in adaptor.thread_state_dump())
        assert any("FORCE_RELEASE" in row for row in adaptor.get_log())
    finally:
        release.set()
        s.stop()
        TM.unregister_query("t_gpu_hog")
        rmm_spark.clear_event_handler()


@pytest.mark.gpu
def test_server_phase_on_card_small(cuda, tmp_path, monkeypatch):
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    res = C.server_phase(
        "cuda", params=C.SERVER_SMALL, flagship_rows=1 << 16,
        q9_rows=1 << 12,
        deadline_q5=dict(C.SERVER_SMALL_DEADLINE_Q5, rows=1 << 24))
    assert res["flagship"]["to_rows_launches"] == 2
    assert res["lifeguard"]["incidents"] == ["admission_stall",
                                             "query_hang"]
    assert res["dynamo_graphs_added"] == 0


@pytest.mark.gpu
def test_op_ranges_around_the_flagship_step_on_card(cuda):
    from spark_rapids_tpu_torch.utils import profiler as PROF
    inputs = F.example_inputs(1 << 16, device="cuda")
    blobs = []
    p = PROF.Profiler.init(blobs.append, PROF.Config(write_buffer_size=1))
    try:
        p.start()
        RA.reset_launches()
        out = F.flagship_step(*inputs)
        torch.cuda.synchronize()
        launches = dict(RA.LAUNCHES)["to_rows"]
        p.stop()
    finally:
        PROF.Profiler.shutdown()
    names = [r["name"] for b in blobs for r in PROF.iter_records(b)
             if r["kind"] == "op_range"]
    assert names == ["murmur3_32", "xxhash64", "convert_to_rows"]
    assert launches == 1
    ref = F.flagship_step(*F.example_inputs(1 << 16, device="cpu"))
    for got, want in zip(out, ref):
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_injected_fault_around_the_to_rows_kernel_on_card(cuda, tmp_path):
    from spark_rapids_tpu_torch.memory import exceptions as EXC
    from spark_rapids_tpu_torch.utils import fault_injection as FI
    table = make_table(1000, 20, "cuda", seed=21, nullable_every=3)
    cfg = tmp_path / "faults.json"
    cfg.write_text(json.dumps({"seed": 21, "faults": [
        {"match": "convert_to_rows", "repeat": 1,
         "exception": "GpuRetryOOM"}]}))
    FI.install(str(cfg), watch=False)
    try:
        RA.reset_launches()
        with pytest.raises(EXC.GpuRetryOOM):
            RC.convert_to_rows(table)
        assert dict(RA.LAUNCHES)["to_rows"] == 0
        rows = RC.convert_to_rows(table)
        assert dict(RA.LAUNCHES)["to_rows"] == 1
    finally:
        FI.uninstall()
    e_to, e_from = compare_kernels(table)
    assert e_to == 0 and e_from == 0
    back = RC.convert_from_rows(rows, [c.dtype for c in table.columns])
    for a, b in zip(table.columns, back.columns):
        assert torch.equal(a.data, b.data)


@pytest.mark.gpu
def test_tools_phase_on_card_small(cuda, tmp_path, monkeypatch):
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    C.server_phase(
        "cuda", params=C.SERVER_SMALL, flagship_rows=1 << 16,
        q9_rows=1 << 12,
        deadline_q5=dict(C.SERVER_SMALL_DEADLINE_Q5, rows=1 << 24))
    for r in range(2):
        C.keep_json_for_tools({
            "profile_version": 1, "query_id": f"q5-rank{r}",
            "query": "dist_q5", "tenant": "", "rank": r, "world": 2,
            "trace_id": "t0", "t_unix_ms": 1000 + r,
            "wall_ns": 1_000_000,
            "stages": [{"stage": "q5_partials", "digest": "d",
                        "engine": "fused", "compiled": r == 0,
                        "wall_ns": 1_000_000, "calls": 1,
                        "dispatches": 1, "nodes_total": 3, "nodes": [],
                        "inputs": []}],
            "hot_stage": "q5_partials", "ops": {}, "tasks": {},
            "events": {}, "retries": {"episodes": 0, "attempts": 0},
            "oom": {"retry": 0, "split_retry": 0, "blocked_ns": 0},
            "kernel_paths": {}, "jit": {},
            "shuffle_links": {"bytes": {}}, "spans": {}},
            "dist", f"profile_q5_rank{r}.json")
    C.keep_json_for_tools({"rank": 0, "epoch": 0, "windows": [
        {"window": 0, "t_unix_ms": 0, "dur_s": 1.0,
         "counters": {"srt_x_total": {"": 1}}, "gauges": {},
         "histograms": {}}]}, "plane", "timeseries_rank0.json")
    res = C.tools_phase("cuda", flagship_rows=1 << 16)
    assert res["sidecars"]["launches"] == {
        k: C.TOOLS_ITERS for k in ("off", "bracket", "profiler", "tracing")}
    assert res["faults"]["doctor_first"]["kind"] == "fault_injection"


@pytest.fixture
def card_entries(cuda):
    """shim/jni_entry initialized on the card, shut down after."""
    from spark_rapids_tpu_torch.shim import jni_entry as JE
    from spark_rapids_tpu_torch.utils import platform
    JE._INITIALIZED = False
    platform.set_entry_device("cuda")
    JE.initialize()
    yield JE
    JE.shutdown()
    JE._INITIALIZED = False


@pytest.mark.gpu
def test_jni_entry_row_entries_on_card_match_cpu(card_entries):
    JE = card_entries
    specs = string_host_specs(2049, 31, seed=9, dec128_every=7)
    kinds = [s[0] for s in specs]
    fixed = make_table(4099, 40, "cuda", seed=3, nullable_every=3)
    out = {}
    for dev in ("cuda", "cpu"):
        hs = [jni_api.REGISTRY.register(c) for c in
              interop.table_from_host(specs, device=dev).columns]
        fs = [jni_api.REGISTRY.register(Column(
            c.dtype, c.length, data=c.data.to(dev),
            validity=None if c.validity is None else c.validity.to(dev)))
            for c in fixed.columns]
        RA.reset_launches()
        rows = JE.convert_to_rows(hs)
        back = JE.convert_from_rows(rows, kinds, [0] * len(kinds))
        frows = JE.convert_to_rows(fs)
        fback = JE.convert_from_rows(
            frows, [c.dtype.kind for c in fixed.columns],
            [c.dtype.scale for c in fixed.columns])
        torch.cuda.synchronize()
        launched = dict(RA.LAUNCHES)
        assert launched == ({"to_rows": 1, "from_rows": 1,
                             "to_rows_var": 1} if dev == "cuda" else
                            {"to_rows": 0, "from_rows": 0,
                             "to_rows_var": 0})
        assert all(jni_api.REGISTRY.get(h).device.type == dev
                   for h in [rows, frows] + back + fback)
        out[dev] = [(jni_api.REGISTRY.get(h).offsets.cpu(),
                     jni_api.REGISTRY.get(h).children[0].data.cpu())
                    for h in (rows, frows)]
        out[dev + "_back"] = [JE.column_to_host(h) for h in back + fback]
    for (ao, ad), (bo, bd) in zip(out["cuda"], out["cpu"]):
        assert torch.equal(ao, bo) and torch.equal(ad, bd)
    assert out["cuda_back"] == out["cpu_back"]


@pytest.mark.gpu
def test_from_strings_bulk_round_trip_on_card(card_entries):
    JE = card_entries
    _kind, chars, valid, offs = string_host_specs(5000, 7, seed=4)[6]
    packed = np.packbits(valid != 0, bitorder="little").tobytes() \
        if valid is not None else None
    h = JE.from_strings_bulk(chars.tobytes(), offs.tobytes(), packed)
    col = jni_api.REGISTRY.get(h)
    assert col.device.type == "cuda"
    assert JE.string_column_chars(h) == chars.tobytes()
    assert JE.string_column_offsets(h) == offs.astype("<i4").tobytes()
    cpu = JE.from_strings_bulk(chars.tobytes(), offs.tobytes(), packed,
                               device="cpu")
    assert JE.column_to_host(h) == JE.column_to_host(cpu)


@pytest.mark.gpu
def test_device_attr_is_integrated_false_on_card(card_entries):
    assert card_entries.device_attr_is_integrated() is False


@pytest.mark.gpu
def test_jvm_door_phase_on_card_small(cuda):
    import chip_smoke as C
    from spark_rapids_tpu_torch.shim import jni_entry as JE
    JE._INITIALIZED = False
    fixed = make_table(1 << 14, 212, "cuda", seed=7)
    res = C.jvm_door_phase("cuda", rows=1 << 14, ncols=155, fixed=fixed,
                           cpu_rows=1 << 12, partitions=16)
    assert res["launches"] == {"to_rows": 1, "from_rows": 1,
                               "to_rows_var": 1}
    assert res["max_abs_err"] == {"to_rows_var": 0, "to_rows": 0,
                                  "from_rows": 0}
    assert JE.live_handles() == 0


@pytest.mark.gpu
def test_mesh_entry_world_one_over_nccl(cuda):
    """The JVM door's mesh entries at one rank over NCCL on the card,
    each list equal to the single-device q5 / q72 on the same data, a
    second call on the started rank, and the refusal past the card
    count (chip_smoke.mesh_m1's checks at a small size)."""
    import chip_smoke as C
    from spark_rapids_tpu_torch.shim import jni_entry as JE
    from spark_rapids_tpu_torch.shim import jni_mesh
    JE._INITIALIZED = False
    res = C.mesh_m1("cuda", C.MESH_M1_SMALL)
    assert res["backend"] == "nccl" and not jni_mesh._POOLS
    assert res["q5"]["ranks"][0]["doublings"] >= 1
    assert res["q5"]["warm_ranks"][0]["doublings"] == 0


@pytest.mark.gpu
def test_two_ranks_share_the_card_over_gloo(cuda):
    """Two rank processes on one card over gloo (gloo moves the CUDA
    tensors through the host itself): the exchange and the distributed join against
    one process's, the aggregate, and q5 (op by op and fused) and q72
    against the single-process queries (chip_smoke.mesh_m2's checks at
    a small size)."""
    import chip_smoke as C
    res = C.mesh_m2("cuda", C.MESH_M2_SMALL)
    for r in res["ranks"]:
        assert r["backend"] == "gloo" and r["device"].startswith("cuda")
        assert r["join"]["doublings"] >= 1
        assert r["exchange"]["all_to_all"] == 3
        assert r["q5_fused"]["graphs"] == 1
