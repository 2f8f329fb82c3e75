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
against the CPU.  Float SUM/MEAN on the card add with atomics in a varying
order, so they are held to chip_smoke.close_float_sums's bound; every
other output is byte-equal.

Marked `gpu`; each test skips without a CUDA device (decided in the
`cuda` fixture, never at import).  The file imports no JAX, so on a GPU
host without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import json

import numpy as np
import pytest
import torch

from chip_smoke import (KERNEL_CASES, VAR_KERNEL_CASES, close_float_sums,
                        compare_kernels, compare_var_kernel, join_route_log,
                        make_table, on_cpu, same_column, store_sales_batch,
                        string_host_specs, string_key_column)
from spark_rapids_tpu_torch import models as TM
from spark_rapids_tpu_torch.columns import dtypes, interop
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.models import flagship as F
from spark_rapids_tpu_torch.models import query as Q
from spark_rapids_tpu_torch.models import tpcds as TT
from spark_rapids_tpu_torch.ops import copying as CP
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import hash_join as HJ
from spark_rapids_tpu_torch.ops import joins as J
from spark_rapids_tpu_torch.ops import sorting as S
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
