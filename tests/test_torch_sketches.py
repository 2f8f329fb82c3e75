"""PyTorch port: the bloom filter (v1 and v2), HLL++ and the histogram
against the JAX package on the same seeded values: serialized filter
bytes and sketches byte for byte, estimates and percentiles equal, with
the cases of tests/test_ops_batch1.py's bloom half and
tests/test_sketches.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import bloom_filter as JBF
from spark_rapids_tpu.ops import histogram as JHG
from spark_rapids_tpu.ops import hllpp as JHL
from spark_rapids_tpu.ops.exceptions import ExceptionWithRowIndex as JErr
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import bloom_filter as BF
from spark_rapids_tpu_torch.ops import histogram as HG
from spark_rapids_tpu_torch.ops import hllpp as HL
from spark_rapids_tpu_torch.ops.exceptions import ExceptionWithRowIndex
from torch_port_data import col_parts, jax_column, port_column, values_spec


def both(spec):
    return port_column(spec), jax_column(spec)


def longs(vals):
    return Column.from_pylist(vals, dtypes.INT64, "cpu")


def seeded_keys(seed, n, null_every=0):
    rng = np.random.default_rng(seed)
    vals = [int(x) for x in rng.integers(-2**63, 2**63 - 1, n)]
    vals[:4] = [0, -1, 2**63 - 1, -2**63]
    if null_every:
        vals = [None if i % null_every == 1 else v
                for i, v in enumerate(vals)]
    return vals


# ----------------------------------------------------------- bloom filter


@pytest.mark.parametrize("version", [1, 2])
def test_bloom_build_and_probe(version):
    """BloomFilterTest.testBuildAndProbe: 3 hashes, 4M bits."""
    f = BF.create(3, 4 * 1024 * 1024 // 64, version=version, device="cpu")
    f = BF.put(f, longs([20, 80, 100, 99, 47, -9, 234000000]))
    probe = longs([20, 80, 100, 99, 47, -9, 234000000, -10, 1, 2, 3])
    assert BF.probe(f, probe).to_pylist() == [True] * 7 + [False] * 4


@pytest.mark.parametrize("version", [1, 2])
def test_bloom_nulls(version):
    f = BF.create(3, 4 * 1024 * 1024 // 64, version=version, device="cpu")
    f = BF.put(f, longs([None, 80, 100, None, 47, -9, 234000000]))
    probe = longs([20, 80, 100, 99, 47, -9, 234000000, -10, 1, 2, 3])
    assert BF.probe(f, probe).to_pylist() == \
        [False, True, True, False, True, True, True, False, False, False,
         False]
    assert BF.probe(f, longs([None, 80, None, 2])).to_pylist() == \
        [None, True, None, False]


@pytest.mark.parametrize("version,hashes,num_longs,seed", [
    (1, 3, 1024, 0), (2, 3, 1024, 7), (2, 5, 4567, -3), (1, 7, 33, 0),
    (2, 1, 64, 2**31 - 1)])
def test_bloom_bytes_match_reference(version, hashes, num_longs, seed):
    """Seeded keys with nulls (and many collisions in the small
    filters): the serialized sketch, every probe and every merge equal
    the JAX package's."""
    keys = seeded_keys(version * 100 + hashes, 3000, null_every=25)
    probe_keys = keys[::3] + seeded_keys(99, 1000)
    pk, jk = both(values_spec("int64", keys))
    pp, jp = both(values_spec("int64", probe_keys))
    f = BF.put(BF.create(hashes, num_longs, version, seed, "cpu"), pk)
    jf = JBF.put(JBF.create(hashes, num_longs, version, seed), jk)
    assert BF.serialize(f) == JBF.serialize(jf)
    assert col_parts(BF.probe(f, pp)) == col_parts(JBF.probe(jf, jp))
    g = BF.put(BF.create(hashes, num_longs, version, seed, "cpu"), pp)
    jg = JBF.put(JBF.create(hashes, num_longs, version, seed), jp)
    assert BF.serialize(BF.merge([f, g])) == \
        JBF.serialize(JBF.merge([jf, jg]))
    back = BF.deserialize(JBF.serialize(jf), "cpu")
    assert BF.serialize(back) == BF.serialize(f)
    assert (back.version, back.num_hashes, back.seed) == \
        (version, hashes, seed if version == 2 else 0)


@pytest.mark.parametrize("version", [1, 2])
def test_bloom_merge_and_serde(version):
    f1 = BF.put(BF.create(3, 1024, version, 7, "cpu"), longs([1, 2, 3]))
    f2 = BF.put(BF.create(3, 1024, version, 7, "cpu"), longs([100, 200]))
    m = BF.merge([f1, f2])
    probe = longs([1, 2, 3, 100, 200, 999])
    out = BF.probe(m, probe).to_pylist()
    assert out[:5] == [True] * 5
    raw = BF.serialize(m)
    assert BF.probe(BF.deserialize(raw, "cpu"), probe).to_pylist() == out
    assert raw[:4] == version.to_bytes(4, "big")


def test_bloom_refusals_and_empty():
    with pytest.raises(ValueError):
        BF.merge([BF.create(3, 64, 2, 1, "cpu"),
                  BF.create(3, 64, 2, 2, "cpu")])
    with pytest.raises(ValueError):
        BF.create(3, 64, 3, device="cpu")
    with pytest.raises(ValueError):
        BF.deserialize(b"\x00\x00\x00\x05" + bytes(12), "cpu")
    f = BF.create(3, 64, 2, device="cpu")
    assert BF.put(f, longs([])) is f
    assert BF.probe(f, longs([])).length == 0


# ------------------------------------------------------------------ HLL++


@pytest.mark.parametrize("precision,n,distinct", [(9, 50_000, 5000),
                                                  (4, 3000, 3000),
                                                  (12, 20_000, 300),
                                                  (13, 2000, 2000)])
def test_hllpp_sketches_match_reference(precision, n, distinct):
    rng = np.random.default_rng(precision)
    pool = np.asarray(seeded_keys(precision, distinct), np.int64)
    vals = [int(pool[i]) for i in rng.integers(0, distinct, n)]
    vals[5] = None
    p, j = both(values_spec("int64", vals))
    sk = HL.reduce_hllpp(p, precision)
    jsk = JHL.reduce_hllpp(j, precision)
    assert col_parts(sk) == col_parts(jsk)
    est = HL.estimate_from_hll_sketches(sk, precision)
    assert col_parts(est) == col_parts(
        JHL.estimate_from_hll_sketches(jsk, precision))
    if precision == 9:                     # ~4% expected at p = 9
        true = len(set(v for v in vals if v is not None))
        assert abs(est.to_pylist()[0] - true) / true < 0.1


def test_hllpp_group_and_merge_match_reference():
    vals = seeded_keys(3, 4000, null_every=17)
    p, j = both(values_spec("int64", vals))
    gids = np.random.default_rng(4).integers(0, 9, 4000).astype(np.int32)
    sk = HL.group_hllpp(p, torch.from_numpy(gids), 9, 9)
    jsk = JHL.group_hllpp(j, jnp.asarray(gids), 9, 9)
    assert col_parts(sk) == col_parts(jsk)
    mg = np.array([0, 1, 0, 2, 2, 1, 0, 1, 2], np.int32)
    merged = HL.merge_sketches(sk, torch.from_numpy(mg), 3, 9)
    jmerged = JHL.merge_sketches(jsk, jnp.asarray(mg), 3, 9)
    assert col_parts(merged) == col_parts(jmerged)
    assert col_parts(HL.reduce_merge_hllpp(sk, 9)) == \
        col_parts(JHL.reduce_merge_hllpp(jsk, 9))
    assert col_parts(HL.estimate_from_hll_sketches(merged, 9)) == \
        col_parts(JHL.estimate_from_hll_sketches(jmerged, 9))


def test_hllpp_goldens():
    c = longs([1, 2, 3, 1, 2, 100, 200, 300, 400])
    gids = torch.tensor([0, 0, 0, 0, 0, 1, 1, 1, 1], dtype=torch.int32)
    sk = HL.group_hllpp(c, gids, 2, 9)
    assert HL.estimate_from_hll_sketches(sk, 9).to_pylist() == [3, 4]
    merged = HL.reduce_merge_hllpp(sk, 9)
    assert HL.estimate_from_hll_sketches(merged, 9).to_pylist() == [7]
    nulls = HL.reduce_hllpp(longs([1, None, 2, None]), 9)
    assert HL.estimate_from_hll_sketches(nulls, 9).to_pylist() == [2]
    sk1 = HL.reduce_hllpp(longs([42]), 9)
    assert len(sk1.children) == 52          # 2^9/10 + 1 longs
    assert all(ch.dtype.kind == "int64" for ch in sk1.children)
    with pytest.raises(ValueError, match="precision"):
        HL.reduce_hllpp(longs([1]), 3)
    with pytest.raises(ValueError, match="long columns"):
        HL.merge_sketches(sk1, torch.zeros(1, dtype=torch.int32), 1, 10)


@pytest.mark.parametrize("p,n", [(8, 30), (11, 200), (14, 1000), (11, 4000)])
def test_hllpp_estimate_ranges_match_reference(p, n):
    """The linear-counting, mid (bias-corrected) and large ranges:
    estimates equal the JAX package's."""
    rng = np.random.default_rng(7 * p + n)
    vals = [int(v) for v in np.unique(
        rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64))]
    pc, jc = both(values_spec("int64", vals))
    sk, jsk = HL.reduce_hllpp(pc, p), JHL.reduce_hllpp(jc, p)
    assert HL.estimate_from_hll_sketches(sk, p).to_pylist() == \
        JHL.estimate_from_hll_sketches(jsk, p).to_pylist()


# -------------------------------------------------------------- histogram


@pytest.mark.parametrize("kind", ["float64", "int32", "int64"])
def test_histogram_create_matches_reference(kind):
    rng = np.random.default_rng(len(kind))
    n = 300
    if kind == "float64":
        vals = list(rng.normal(size=n))
    else:
        vals = [int(x) for x in rng.integers(-1000, 1000, n)]
    vals[3] = None
    freqs = [int(x) for x in rng.integers(0, 5, n)]
    pv, jv = both(values_spec(kind, vals))
    pf, jf = both(values_spec("int64", freqs))
    for lists in (True, False):
        got = HG.create_histogram_if_valid(pv, pf, lists)
        want = JHG.create_histogram_if_valid(jv, jf, lists)
        assert col_parts(got) == col_parts(want)
        assert got.to_pylist() == want.to_pylist()


def test_histogram_percentiles_match_reference():
    rng = np.random.default_rng(11)
    rows, per = 40, 25
    vals = list(rng.integers(1, 101, rows * per).astype(np.float64))
    freqs = [int(x) for x in rng.integers(1, 9, rows * per)]
    pv, jv = both(values_spec("float64", vals))
    pf, jf = both(values_spec("int64", freqs))
    st = Column.make_struct(rows * per, [pv, pf])
    jst = jax_column(("struct", None, None, None,
                      (values_spec("float64", vals),
                       values_spec("int64", freqs))))
    lens = rng.integers(0, per + 1, rows)
    lens[-1] = rows * per - lens[:-1].sum() if lens[:-1].sum() < rows * per \
        else 0
    offs = np.zeros(rows + 1, np.int32)
    offs[1:] = np.minimum(np.cumsum(lens), rows * per)
    valid = (rng.random(rows) > 0.1).astype(np.uint8)
    hist = Column(dtypes.LIST, rows, offsets=torch.from_numpy(offs),
                  validity=torch.from_numpy(valid), children=(st,))
    from spark_rapids_tpu.columns import dtypes as jdtypes
    from spark_rapids_tpu.columns.column import Column as JColumn
    jhist = JColumn(jdtypes.LIST, rows, offsets=jnp.asarray(offs),
                    validity=jnp.asarray(valid), children=(jst,))
    pcts = [0.0, 0.25, 0.5, 0.75, 0.99, 1.0]
    for as_list in (True, False):
        got = HG.percentile_from_histogram(hist, pcts, as_list)
        want = JHG.percentile_from_histogram(jhist, pcts, as_list)
        assert col_parts(got) == col_parts(want)


def test_histogram_goldens_and_validation():
    vals = Column.from_pylist([10.0, 20.0, 30.0], dtypes.FLOAT64, "cpu")
    freqs = longs([1, 1, 2])
    h = HG.create_histogram_if_valid(vals, freqs)
    st = h.children[0]
    merged = Column(dtypes.LIST, 1,
                    offsets=torch.tensor([0, st.length], dtype=torch.int32),
                    children=(st,))
    assert HG.percentile_from_histogram(merged, [0.0, 0.5, 1.0]
                                        ).to_pylist() == [[10.0, 25.0, 30.0]]
    v2 = Column.from_pylist([1.0, 2.0, None, 4.0], dtypes.FLOAT64, "cpu")
    h2 = HG.create_histogram_if_valid(v2, longs([1, 0, 3, 2]))
    assert h2.to_pylist() == [[(1.0, 1)], [], [], [(4.0, 2)]]
    assert HG.create_histogram_if_valid(
        v2, longs([1, 0, 3, 2]), False).to_pylist()[1] is None
    with pytest.raises(ExceptionWithRowIndex) as ei:
        HG.create_histogram_if_valid(
            Column.from_pylist([1.0, 2.0], dtypes.FLOAT64, "cpu"),
            longs([1, -5]))
    assert ei.value.row_index == 1
    with pytest.raises(ExceptionWithRowIndex, match="null"):
        HG.create_histogram_if_valid(
            Column.from_pylist([1.0], dtypes.FLOAT64, "cpu"), longs([None]))
