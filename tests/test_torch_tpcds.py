"""PyTorch port: TPC-DS q5 and q72 — the seeded generators, the hand
pipelines, and the stage pipelines in both engines — against the JAX
package's `make_q*`, `run_q*` (fused) and `oracle_q*` on the same data,
at the sizes of tests/test_stage_fusion.py.  Exact bytes everywhere:
every output is int32, int64 or bool."""

import os

os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from spark_rapids_tpu.models import tpcds as JT  # noqa: E402
from spark_rapids_tpu.plan import catalog as JC  # noqa: E402
from spark_rapids_tpu_torch.models import tpcds as TT  # noqa: E402
from spark_rapids_tpu_torch.plan import catalog as TC  # noqa: E402

STORES = 16
ITEMS = 64
MAX_WEEK = 16
WEEK0 = 11_000 // 7


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bytes_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert g.tobytes() == w.tobytes(), i


def _q72_rows(outs):
    item, week, cnt, _of = (_np(o) for o in outs)
    return [(int(i), int(w), int(c))
            for i, w, c in zip(item, week, cnt) if c > 0]


@pytest.fixture(scope="module")
def q5():
    ref = JT.gen_q5(rows=4000, stores=STORES, days=60)
    ours = TT.gen_q5(rows=4000, stores=STORES, days=60, device="cpu")
    return ref, ours, JT.make_q5(STORES, join_capacity=1 << 13)(ref)


@pytest.fixture(scope="module")
def q72():
    ref = JT.gen_q72(cs_rows=3000, inv_rows=3000, items=ITEMS, days=35)
    ours = TT.gen_q72(cs_rows=3000, inv_rows=3000, items=ITEMS, days=35,
                      device="cpu")
    want = JT.make_q72(ITEMS, MAX_WEEK, join_capacity=1 << 18,
                       week0=WEEK0)(ref)
    return ref, ours, want


@pytest.mark.parametrize("gen,kw", [
    ("gen_q5", dict(rows=4000, stores=STORES, days=60)),
    ("gen_q5", dict(rows=777, stores=402, days=60, seed=3)),
    ("gen_q72", dict(cs_rows=3000, inv_rows=1500, items=ITEMS, days=35)),
    ("gen_q72", dict(cs_rows=100, inv_rows=50, items=2040, days=35,
                     seed=9)),
])
def test_generators_draw_the_references_arrays(gen, kw):
    ref = getattr(JT, gen)(**kw)
    ours = getattr(TT, gen)(device="cpu", **kw)
    assert ref._fields == ours._fields
    _bytes_equal(ours, ref)


def test_hand_q5_matches_reference(q5):
    _ref, ours, want = q5
    _bytes_equal(TT.make_q5(STORES, join_capacity=1 << 13)(ours), want)


def test_hand_q72_matches_reference(q72):
    _ref, ours, want = q72
    _bytes_equal(TT.make_q72(ITEMS, MAX_WEEK, join_capacity=1 << 18,
                             week0=WEEK0)(ours), want)


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_stage_q5_matches_reference(q5, fusion, monkeypatch):
    ref, ours, want = q5
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    _bytes_equal(want, JC.run_q5(ref, STORES, 1 << 13))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", fusion)
    _bytes_equal(TC.run_q5(ours, STORES, 1 << 13), want)


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_stage_q72_matches_reference(q72, fusion, monkeypatch):
    ref, ours, want = q72
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    _bytes_equal(want, JC.run_q72(ref, ITEMS, MAX_WEEK, 1 << 18,
                                  week0=WEEK0))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", fusion)
    _bytes_equal(TC.run_q72(ours, ITEMS, MAX_WEEK, 1 << 18, week0=WEEK0),
                 want)


def test_oracles_match_reference(q5, q72):
    ref5, ours5, want5 = q5
    rows5 = TT.oracle_q5(ours5, STORES)
    assert rows5 == JT.oracle_q5(ref5, STORES)
    key, sales, rets, profit, _of = (np.asarray(x) for x in want5)
    live = key != 2**31 - 1
    assert rows5 == [tuple(int(v) for v in r) for r in zip(
        key[live], sales[live], rets[live], profit[live])]
    ref72, ours72, want72 = q72
    rows72 = TT.oracle_q72(ours72, ITEMS, MAX_WEEK, week0=WEEK0)
    assert rows72 == JT.oracle_q72(ref72, ITEMS, MAX_WEEK, week0=WEEK0)
    assert rows72 == _q72_rows(want72)


def test_q72_capacity_retry_doubles(monkeypatch):
    """A join budget far too small doubles through the capacity retry
    until the stage's overflow flag clears, as in the reference."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    ref = JT.gen_q72(cs_rows=1200, inv_rows=1200, items=4, days=35)
    ours = TT.gen_q72(cs_rows=1200, inv_rows=1200, items=4, days=35,
                      device="cpu")
    (counts, of), cap = TC.run_q72_partials(ours, 4, MAX_WEEK, 1 << 12,
                                            WEEK0)
    (_c, _o), ref_cap = JC.run_q72_partials(ref, 4, MAX_WEEK, 1 << 12,
                                            WEEK0)
    assert cap == ref_cap > 1 << 12 and not bool(of)
    outs = TC.run_q72(ours, 4, MAX_WEEK, 1 << 12, week0=WEEK0)
    assert not bool(outs[-1])
    assert _q72_rows(outs) == JT.oracle_q72(ref, 4, MAX_WEEK, week0=WEEK0)
    hand, hand_cap = TT.run_with_capacity_retry(
        lambda c: TT.make_q72(4, MAX_WEEK, c, week0=WEEK0), [ours], 1 << 12)
    assert hand_cap == cap
    _bytes_equal(hand, outs)
