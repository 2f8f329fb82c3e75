"""PyTorch port: the TPC-DS catalog's q3, q7, q9, q67, cube and q89 —
seeded generators, hand pipelines (q3, q7, q9), the stage plans op
by op, and the vectorised oracles — against the JAX
package's on the same data.  Exact bytes everywhere (q7's and q9's
averages are float64 divisions of exact int64 sums, the same IEEE
operation on both sides).  The fused engine's runs are in
tests/test_torch_catalog_fused.py, the plans' digests in
tests/test_torch_plan.py."""

import numpy as np
import pytest

from spark_rapids_tpu.models import tpcds as JT
from spark_rapids_tpu.plan import catalog as JC
from spark_rapids_tpu_torch.models import tpcds as TT
from spark_rapids_tpu_torch.plan import catalog as TC
from torch_port_data import CATALOG_CASES, np_of, same_outputs

GEN_CASES = [
    ("gen_q3", dict()),
    ("gen_q3", dict(rows=3001, items=64, days=730, brands=8, seed=11)),
    ("gen_q7", dict()),
    ("gen_q7", dict(rows=3001, items=64, demos=256, promos=32)),
    ("gen_q9", dict()),
    ("gen_q9", dict(rows=3001, seed=2)),
    ("gen_q67", dict()),
    ("gen_q67", dict(rows=3001, ncat=10, ncls=16, seed=1)),
    ("gen_q89", dict()),
    ("gen_q89", dict(rows=3001, stores=402, items=2040, seed=5)),
]


def _data(name):
    gen, kw, _run = CATALOG_CASES[name]
    return getattr(JT, gen)(**kw), getattr(TT, gen)(device="cpu", **kw)


def _same_rows(got, want):
    """Equal lists of tuples, element types included."""
    assert got == want
    for g, w in zip(got, want):
        assert [type(x) for x in g] == [type(x) for x in w]


@pytest.mark.parametrize("gen,kw", GEN_CASES)
def test_generators_draw_the_references_arrays(gen, kw):
    ref = getattr(JT, gen)(**kw)
    ours = getattr(TT, gen)(device="cpu", **kw)
    if hasattr(ref, "_fields"):
        assert ref._fields == ours._fields
    same_outputs(ours, ref)


@pytest.mark.parametrize("rows", [3001, 4096, 50])
def test_hand_q3_matches_reference(rows):
    kw = dict(rows=rows, items=64, days=730, brands=8)
    ref, ours = JT.gen_q3(**kw), TT.gen_q3(device="cpu", **kw)
    for years, manufact, limit in ((3, 2, 100), (2, 5, 7)):
        same_outputs(TT.make_q3(10_957, years, 8, manufact,
                                limit=limit)(ours),
                     JT.make_q3(10_957, years, 8, manufact,
                                limit=limit)(ref))


@pytest.mark.parametrize("rows", [3001, 4096])
def test_hand_q9_matches_reference(rows):
    ref, ours = JT.gen_q9(rows=rows), TT.gen_q9(rows=rows, device="cpu")
    same_outputs(TT.run_q9(*ours), JT.run_q9(*ref))


@pytest.mark.parametrize("rows,items,limit", [(3001, 64, 100),
                                              (300, 128, 100),
                                              (4096, 64, 10)])
def test_hand_q7_matches_reference(rows, items, limit):
    kw = dict(rows=rows, items=items, demos=256, promos=32)
    ref, ours = JT.gen_q7(**kw), TT.gen_q7(device="cpu", **kw)
    same_outputs(TT.make_q7(items, limit)(ours),
                 JT.make_q7(items, limit)(ref))


@pytest.mark.parametrize("name", sorted(CATALOG_CASES))
def test_stage_op_by_op_matches_reference(name, monkeypatch):
    run = CATALOG_CASES[name][2]
    ref, ours = _data(name)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    want = run(JC, ref)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    same_outputs(run(TC, ours), want)


def test_stage_q3_and_q9_match_the_hand_pipelines(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    _ref, d = _data("q3")
    same_outputs(TC.run_q3(d, 10_957, years=3, brands=8, manufact=2),
                 TT.make_q3(10_957, 3, 8, 2)(d))
    _ref, q = _data("q9")
    same_outputs(TC.run_q9(*q), TT.run_q9(*q))


def test_q3_oracle_matches_reference(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    ref, ours = _data("q3")
    for manufact, limit in ((2, 100), (5, 3)):
        got = TT.oracle_q3(ours, 10_957, 8, manufact, limit=limit)
        _same_rows(got, JT.oracle_q3(ref, 10_957, 8, manufact,
                                     limit=limit))
    # and the stage's live rows
    year, brand, sums, _total = TC.run_q3(ours, 10_957, years=3, brands=8,
                                          manufact=2)
    live = np_of(year) != 2**31 - 1
    assert TT.oracle_q3(ours, 10_957, 8, 2) == [
        (int(y), int(b), int(s)) for y, b, s in zip(
            np_of(year)[live], np_of(brand)[live], np_of(sums)[live])]


def test_q7_oracle_matches_reference():
    for kw, items in ((dict(rows=3001, items=64, demos=256, promos=32), 64),
                      (dict(rows=200, items=128), 128)):
        ref, ours = JT.gen_q7(**kw), TT.gen_q7(device="cpu", **kw)
        for limit in (100, 5):
            _same_rows(TT.oracle_q7(ours, items, limit),
                       JT.oracle_q7(ref, items, limit))


def test_q9_oracle_matches_reference():
    ref, ours = _data("q9")
    _same_rows(TT.oracle_q9(*ours), JT.oracle_q9(*ref))


@pytest.mark.parametrize("name", ["q67", "q67_sparse"])
def test_q67_and_cube_oracles_match_reference(name):
    ref, ours = _data(name)
    kw = CATALOG_CASES[name][1]
    ncat, ncls = kw["ncat"], kw["ncls"]
    rows, sum1, total = TT.oracle_q67(ours, ncat, ncls)
    r_rows, r_sum1, r_total = JT.oracle_q67(ref, ncat, ncls)
    _same_rows(rows, r_rows)
    assert sum1 == r_sum1 and total == r_total
    assert all(type(x) is int for x in sum1 + [total])
    got, want = TT.oracle_cube(ours, ncat, ncls), JT.oracle_cube(ref, ncat,
                                                                 ncls)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        else:
            assert g == w


def test_q89_oracle_matches_reference():
    ref, ours = _data("q89")
    _same_rows(TT.oracle_q89(ours, 9, 400), JT.oracle_q89(ref, 9, 400))
