"""PyTorch port: decimal128 arithmetic (ops/decimal_utils' host big-int
loop, ops/decimal_device's limbs) and ops/arithmetic, against the JAX
package on the same seeded values.  The cases and goldens are those of
tests/test_decimal_datetime.py's decimal half, tests/test_decimal_device.py
and tests/test_ops_batch1.py's arithmetic.

Every comparison is byte for byte: the port's host loop against the JAX
host loop, and the port's limbs (on CPU tensors, through
SPARK_RAPIDS_TPU_FORCE_DEVICE_DECIMAL=1) against the JAX limbs, every
row's bytes including an overflow row's unspecified value, since both
run the same limb algorithm.  Between the two engines of one package
the overflow flags and every non-overflow value must agree, as the
reference's device tests hold them."""

import random

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columns import dtypes as jdtypes
from spark_rapids_tpu.columns.column import Column as JColumn
from spark_rapids_tpu.ops import arithmetic as JAR
from spark_rapids_tpu.ops import decimal_device as JDD
from spark_rapids_tpu.ops import decimal_utils as JDU
from spark_rapids_tpu.ops.exceptions import ExceptionWithRowIndex as \
    JExceptionWithRowIndex
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import decimal_device as DD
from spark_rapids_tpu_torch.ops import decimal_utils as DU
from spark_rapids_tpu_torch.ops.exceptions import ExceptionWithRowIndex
from torch_port_data import col_parts, jax_column, port_column

FORCE = "SPARK_RAPIDS_TPU_FORCE_DEVICE_DECIMAL"


@pytest.fixture
def engine(request, monkeypatch):
    """Pins the port's decimal router: "host" (the CPU default) or
    "limbs" (the card's engine, on CPU tensors)."""
    monkeypatch.setenv(FORCE, "1" if request.param == "limbs" else "0")
    return request.param


def dec(vals, scale):
    return Column.from_pylist(vals, dtypes.decimal128(scale), "cpu")


def jdec(vals, scale):
    return JColumn.from_pylist(vals, jdtypes.decimal128(scale))


def _values(rng, n, max_bytes=15):
    return [None if rng.random() < 0.1 else int.from_bytes(
        rng.randbytes(rng.randint(1, max_bytes)), "little", signed=True)
        for _ in range(n)]


def _same_result(got, want):
    """Equal (overflow, result) pairs, byte for byte."""
    assert col_parts(got[0]) == col_parts(want[0])
    assert col_parts(got[1]) == col_parts(want[1])


def _same_valid_rows(a, b):
    """Equal overflow flags and equal non-overflow values (an overflow
    row's value is unspecified between engines)."""
    assert a[0].to_pylist() == b[0].to_pylist()
    for x, y, o in zip(a[1].to_pylist(), b[1].to_pylist(),
                       a[0].to_pylist()):
        if o is not True:
            assert x == y


# ------------------------------------------------- reference goldens


@pytest.mark.parametrize("engine", ["host", "limbs"], indirect=True)
def test_multiply_goldens(engine):
    # 1.23 * 4.5 = 5.535 at scale -3
    ovf, res = DU.multiply_decimal128(dec([123, -123, None], -2),
                                      dec([450, 450, 1], -2), -3)
    assert res.to_pylist() == [5535, -5535, None]
    assert ovf.to_pylist() == [False, False, None]
    big = dec([10**37], 0)
    assert DU.multiply_decimal128(big, big, 0)[0].to_pylist() == [True]


@pytest.mark.parametrize("engine", ["host", "limbs"], indirect=True)
def test_interim_cast_stays_on_the_host_loop(engine, monkeypatch):
    """SPARK-40129's legacy interim rounding runs the host loop whatever
    the router says (the limbs would be called with no interim cast)."""
    monkeypatch.setattr(DD, "multiply128_device", None)
    a = dec([10**19 + 1], -19)   # 1.0000000000000000001
    ovf, res = DU.multiply_decimal128(a, a, -19, cast_interim_result=True)
    assert ovf.to_pylist() == [False]
    assert res.to_pylist() == [10**19 + 2]


@pytest.mark.parametrize("engine", ["host", "limbs"], indirect=True)
def test_divide_remainder_goldens(engine):
    a, b = dec([100], -2), dec([300], -2)
    ovf, res = DU.divide_decimal128(a, b, -6)
    assert res.to_pylist() == [333333] and ovf.to_pylist() == [False]
    assert DU.divide_decimal128(a, dec([0], -2), -6)[0].to_pylist() == \
        [True]
    assert DU.remainder_decimal128(dec([700], -2), dec([400], -2),
                                   -2)[1].to_pylist() == [300]
    # truncated-division remainder: the dividend's sign
    assert DU.remainder_decimal128(dec([-700], -2), dec([400], -2),
                                   -2)[1].to_pylist() == [-300]


@pytest.mark.parametrize("engine", ["host", "limbs"], indirect=True)
def test_add_sub_goldens(engine):
    a, b = dec([123], -2), dec([4567], -3)
    assert DU.add_decimal128(a, b, -3)[1].to_pylist() == [5797]
    assert DU.sub_decimal128(b, a, -3)[1].to_pylist() == [3337]
    # HALF_UP on the rescale: 1.23 + 4.567 at scale -2 -> 5.80
    assert DU.add_decimal128(a, b, -2)[1].to_pylist() == [580]


@pytest.mark.parametrize("engine", ["host", "limbs"], indirect=True)
def test_integer_divide_goldens(engine):
    a, b = dec([700], -2), dec([300], -2)
    assert DU.integer_divide_decimal128(a, b, 0)[1].to_pylist() == [2]
    # truncation happens AT the target scale: 2.33, not 2.00
    assert DU.integer_divide_decimal128(a, b, -2)[1].to_pylist() == [233]


def test_float_to_decimal_matches_reference():
    vals = [1.5, -2.25, float("inf"), None, 0.125, -0.125, 1e20,
            float("nan"), 123456.789, -5e-3]
    got, first = DU.floating_point_to_decimal(
        Column.from_pylist(vals, dtypes.FLOAT64, "cpu"), -2, 9)
    want, jfirst = JDU.floating_point_to_decimal(
        JColumn.from_pylist(vals, jdtypes.FLOAT64), -2, 9)
    assert first == jfirst == 2
    assert col_parts(got) == col_parts(want)
    assert got.to_pylist()[:5] == [150, -225, None, None, 13]  # HALF_UP


def test_router_follows_the_device(monkeypatch):
    """CPU columns take the host loop unless forced; the override sends
    them to the limbs."""
    monkeypatch.delenv(FORCE, raising=False)
    calls = []
    real = DD.add128_device
    monkeypatch.setattr(DD, "add128_device",
                        lambda *a: calls.append(1) or real(*a))
    a = dec([1, 2], 0)
    DU.add_decimal128(a, a, 0)
    assert calls == []
    monkeypatch.setenv(FORCE, "1")
    ovf, res = DU.add_decimal128(a, a, 0)
    assert calls == [1] and res.to_pylist() == [2, 4]


# ---------------------------------------- parity with the JAX package


MUL_TRIPLES = [(-2, -3, -4), (0, 0, 0), (-10, 10, -2), (-38, 0, -38),
               (3, -5, 1), (-2, -2, -4)]


@pytest.mark.parametrize("sa,sb,ps", MUL_TRIPLES)
def test_multiply_add_sub_match_reference(sa, sb, ps, monkeypatch):
    rng = random.Random(sa * 100 + sb * 10 + ps)
    av, bv = _values(rng, 200, 8), _values(rng, 200, 8)
    a, b, ja, jb = dec(av, sa), dec(bv, sb), jdec(av, sa), jdec(bv, sb)
    for op, jop, dop, jdop in (
            (DU.multiply_decimal128, JDU.multiply_decimal128,
             DD.multiply128_device, JDD.multiply128_device),
            (DU.add_decimal128, JDU.add_decimal128,
             DD.add128_device, JDD.add128_device),
            (DU.sub_decimal128, JDU.sub_decimal128,
             DD.sub128_device, JDD.sub128_device)):
        monkeypatch.setenv(FORCE, "0")
        host = op(a, b, ps)
        _same_result(host, jop(ja, jb, ps))
        monkeypatch.setenv(FORCE, "1")
        limbs = op(a, b, ps)
        _same_result(limbs, jdop(ja, jb, ps))
        _same_result(dop(a, b, ps), limbs)
        _same_valid_rows(host, limbs)


DIV_TRIPLES = [(-2, -3, -6), (0, 0, 0), (-10, 4, -2), (3, -5, -1),
               (-4, -4, -20)]   # the last: TPC-DS q49's decimal(35,20)


@pytest.mark.parametrize("sa,sb,qs", DIV_TRIPLES)
def test_divide_remainder_match_reference(sa, sb, qs, monkeypatch):
    rng = random.Random(sa * 37 + sb * 7 + qs)
    av, bv = _values(rng, 150), _values(rng, 150)
    bv[:4] = [0, 0, -1, 1]                   # zero divisors, unit ones
    av[:4] = [5, -5, -(10**38 - 1), 10**38 - 1]
    a, b, ja, jb = dec(av, sa), dec(bv, sb), jdec(av, sa), jdec(bv, sb)
    for op, jop, jdop in (
            (DU.divide_decimal128, JDU.divide_decimal128,
             JDD.divide128_device),
            (DU.integer_divide_decimal128, JDU.integer_divide_decimal128,
             JDD.integer_divide128_device),
            (DU.remainder_decimal128, JDU.remainder_decimal128,
             JDD.remainder128_device)):
        monkeypatch.setenv(FORCE, "0")
        host = op(a, b, qs)
        _same_result(host, jop(ja, jb, qs))
        monkeypatch.setenv(FORCE, "1")
        limbs = op(a, b, qs)
        _same_result(limbs, jdop(ja, jb, qs))
        _same_valid_rows(host, limbs)


def test_edges_match_reference(monkeypatch):
    monkeypatch.setenv(FORCE, "1")
    cases = [
        # MAX_38 boundary, INT128_MIN-adjacent, zeros, -1
        ([10**38 - 1, -(10**38 - 1), 0, -1, 1, -(2**126)], 0,
         [1] * 6, 0, "multiply", 0),
        ([10**38 - 1, -(10**38 - 1), 0, -1, 1, -(2**126)], 0,
         [1] * 6, 0, "add", 0),
        # HALF_UP at the .5 boundary, both signs
        ([5, -5, 15, -15, 4, -4], -1, [10] * 6, -1, "multiply", 0),
        # 0 * 10^38: the host pre-check flags it, so the limbs must too
        ([0, 1, 5], 0, [1, 1, 1], 0, "multiply", -38),
        # division by zero, HALF_UP at exactly .5, int64 bounds
        ([10, 0, None, 5], 0, [0, 0, 0, 2], 0, "divide", 0),
        ([1, -1, 3, -3], 0, [2, 2, 2, 2], 0, "divide", 0),
        ([2**63, -(2**63), 2**63 - 1, -(2**63) - 1], 0, [1] * 4, 0,
         "integer_divide", 0),
        ([7, -7, 7, -7], 0, [3, 3, -3, -3], 0, "remainder", 0),
    ]
    ops = {"multiply": (DU.multiply_decimal128, JDD.multiply128_device,
                        JDU.multiply_decimal128),
           "add": (DU.add_decimal128, JDD.add128_device,
                   JDU.add_decimal128),
           "divide": (DU.divide_decimal128, JDD.divide128_device,
                      JDU.divide_decimal128),
           "integer_divide": (DU.integer_divide_decimal128,
                              JDD.integer_divide128_device,
                              JDU.integer_divide_decimal128),
           "remainder": (DU.remainder_decimal128,
                         JDD.remainder128_device,
                         JDU.remainder_decimal128)}
    for av, sa, bv, sb, op, scale in cases:
        fn, jdev, jhost = ops[op]
        got = fn(dec(av, sa), dec(bv, sb), scale)
        _same_result(got, jdev(jdec(av, sa), jdec(bv, sb), scale))
        _same_valid_rows(got, jhost(jdec(av, sa), jdec(bv, sb), scale))
    _, r = DU.divide_decimal128(dec([1, -1, 3, -3], 0), dec([2] * 4, 0), 0)
    assert r.to_pylist() == [1, -1, 2, -2]          # away from zero
    _, r = DU.remainder_decimal128(dec([7, -7, 7, -7], 0),
                                   dec([3, 3, -3, -3], 0), 0)
    assert r.to_pylist() == [1, -1, 1, -1]
    ovf, _ = DU.multiply_decimal128(dec([0, 1, 5], 0), dec([1] * 3, 0), -38)
    assert ovf.to_pylist() == [True] * 3
    _, out = DU.multiply_decimal128(dec([0, 1, 5], 0), dec([1] * 3, 0), 0)
    assert out.validity is None


def test_limb_type_errors():
    a = Column.from_pylist([1], dtypes.INT64, "cpu")
    d = dec([1], 0)
    with pytest.raises(ValueError):
        DD.multiply128_device(a, d, 0)
    with pytest.raises(ValueError):
        DD.add128_device(d, dec([1, 2], 0), 0)
    with pytest.raises(ValueError):
        DU.divide_decimal128(d, a, 0)


def test_long_divide_matches_python_integers():
    """The whole-matrix restoring division (carry-lookahead borrows)
    against Python's divmod on wide seeded operands, including
    divisors wider than the numerator and a numerator of all ones."""
    rng = random.Random(5)
    n, L = 300, 7
    nums = [rng.getrandbits(rng.randint(1, 32 * L)) for _ in range(n)]
    dens = [rng.getrandbits(rng.randint(1, 32 * L)) or 1 for _ in range(n)]
    nums[0], dens[0] = (1 << (32 * L)) - 1, 3
    nums[1], dens[1] = 5, (1 << 200) + 7

    def limbs(vals):
        return torch.tensor([[(v >> (32 * k)) & 0xFFFFFFFF
                              for k in range(L)] for v in vals],
                            dtype=torch.int64)

    def ints(t):
        return [sum(int(x) << (32 * k) for k, x in enumerate(row))
                for row in t.tolist()]

    q, r = DD._long_divide(limbs(nums), limbs(dens))
    assert ints(q) == [a // b for a, b in zip(nums, dens)]
    assert ints(r) == [a % b for a, b in zip(nums, dens)]
    # a remainder kept only as wide as the divisor's bound
    small = [d >> max(0, d.bit_length() - 70) for d in dens]
    q, r = DD._long_divide(limbs(nums), limbs(small), den_bits=70)
    assert ints(q) == [a // b for a, b in zip(nums, small)]
    assert ints(r) == [a % b for a, b in zip(nums, small)]


# ------------------------------------------------------------ arithmetic


def _pair(kind, values):
    spec = (kind, np.array([0 if v is None else v for v in values],
                           jdtypes.DType(kind).np_dtype),
            np.array([v is not None for v in values], np.uint8))
    if kind == "float64":
        spec = (kind, spec[1].view(np.uint64), spec[2])
    return port_column(spec), jax_column(spec)


INT_EDGES = {"int8": (-128, 127), "int16": (-2**15, 2**15 - 1),
             "int32": (-2**31, 2**31 - 1), "int64": (-2**63, 2**63 - 1)}


@pytest.mark.parametrize("kind", ["int8", "int16", "int32", "int64",
                                  "float32", "float64"])
def test_multiply_matches_reference(kind):
    rng = np.random.default_rng(len(kind))
    n = 400
    if kind.startswith("float"):
        a = list(rng.normal(size=n) * 1e3)
        b = list(rng.normal(size=n) * 1e3)
        a[:4] = [float("nan"), float("inf"), -0.0, 3e38]
        b[:4] = [1.0, -2.0, 3.0, 1e10]   # 3e38 * 1e10 overflows
    else:
        lo, hi = INT_EDGES[kind]
        a = [int(x) for x in rng.integers(lo, hi, n, endpoint=True)]
        b = [int(x) for x in rng.integers(-50, 50, n)]
        a[:6] = [lo, lo, -1, hi, 0, -7]
        b[:6] = [-1, 1, lo, 2, lo, -3]
        # small operands: most products fit, negatives both ways
        a[6:200] = [int(x) for x in rng.integers(max(lo, -1000),
                                                   min(hi, 1000), 194)]
    a[10] = None
    b[11] = None
    pa, ja = _pair(kind, a)
    pb, jb = _pair(kind, b)
    assert col_parts(AR.multiply(pa, pb)) == col_parts(JAR.multiply(ja, jb))
    if kind.startswith("int"):
        assert col_parts(AR.multiply(pa, pb, is_try_mode=True)) == \
            col_parts(JAR.multiply(ja, jb, is_try_mode=True))
        with pytest.raises(ExceptionWithRowIndex) as got:
            AR.multiply(pa, pb, is_ansi_mode=True)
        with pytest.raises(JExceptionWithRowIndex) as want:
            JAR.multiply(ja, jb, is_ansi_mode=True)
        assert got.value.row_index == want.value.row_index


def test_multiply_goldens():
    a = Column.from_pylist([2**31 - 1, 3, None], dtypes.INT32, "cpu")
    b = Column.from_pylist([2, 4, 5], dtypes.INT32, "cpu")
    assert AR.multiply(a, b).to_pylist() == [-2, 12, None]
    assert AR.multiply(a, b, is_try_mode=True).to_pylist() == \
        [None, 12, None]
    with pytest.raises(ExceptionWithRowIndex) as ei:
        AR.multiply(a, b, is_ansi_mode=True)
    assert ei.value.row_index == 0
    c = Column.from_pylist([2**62, -2**63, 5], dtypes.INT64, "cpu")
    d = Column.from_pylist([2, -1, 7], dtypes.INT64, "cpu")
    assert AR.multiply(c, d, is_try_mode=True).to_pylist() == \
        [None, None, 35]
    with pytest.raises(ValueError):
        AR.multiply(a, b, is_ansi_mode=True, is_try_mode=True)


@pytest.mark.parametrize("kind,places", [
    ("int64", -1), ("int64", -3), ("int32", -2), ("int16", -1),
    ("int8", -1), ("int64", -19), ("int64", 2),
    ("decimal32", 0), ("decimal64", 1), ("decimal64", -2),
    ("decimal64", -25), ("float64", 1), ("float64", 0), ("float64", -2),
    ("float32", 2), ("float32", 0)])
@pytest.mark.parametrize("method", ["HALF_UP", "HALF_EVEN"])
def test_round_matches_reference(kind, places, method):
    """Negative values with exact ties both ways: the quotient and
    remainder truncate toward zero, where Python's // and % floor."""
    rng = np.random.default_rng(abs(places) * 7 + len(kind))
    n = 300
    if kind.startswith("float"):
        vals = list(rng.normal(size=n) * 10.0 ** rng.integers(-2, 6, n))
        vals[:8] = [2.5, -2.5, 0.125, -0.125, float("nan"),
                    float("-inf"), 1.5e30, -0.0]
    else:
        np_dt = jdtypes.DType(kind).np_dtype
        info = np.iinfo(np_dt)
        vals = [int(x) for x in rng.integers(info.min, info.max, n,
                                             endpoint=True)]
        vals[:10] = [info.min, info.max, -15, 15, -25, 25, -5, 5, -1,
                     -info.max // 2]
        vals[10:150] = [int(x) for x in rng.integers(
            max(info.min, -999), min(info.max, 999), 140)]
    vals[20] = None
    if kind.startswith("decimal"):
        # the unscaled values at scale -2
        pc, jc = _pair(kind, vals)
        pc = Column(dtypes.DType(kind, -2), pc.length, data=pc.data,
                    validity=pc.validity)
        jc = JColumn(jdtypes.DType(kind, -2), jc.length, data=jc.data,
                     validity=jc.validity)
    else:
        pc, jc = _pair(kind, vals)
    got = AR.round_column(pc, places, method)
    want = JAR.round_column(jc, places, method)
    assert col_parts(got) == col_parts(want)


def test_round_goldens_and_errors():
    a = Column.from_pylist([1729, 1735, -1735], dtypes.INT64, "cpu")
    assert AR.round_column(a, -1).to_pylist() == [1730, 1740, -1740]
    b = Column.from_pylist([15, 25, -15, -25], dtypes.INT64, "cpu")
    assert AR.round_column(b, -1, AR.HALF_EVEN).to_pylist() == \
        [20, 20, -20, -20]
    assert AR.round_column(b, -1, AR.HALF_UP).to_pylist() == \
        [20, 30, -20, -30]
    f = Column.from_pylist([1.5, 2.5, -2.5], dtypes.FLOAT64, "cpu")
    assert AR.round_column(f, 0, AR.HALF_EVEN).to_pylist() == \
        [2.0, 2.0, -2.0]
    assert AR.round_column(f, 0, AR.HALF_UP).to_pylist() == \
        [2.0, 3.0, -3.0]
    with pytest.raises(ValueError, match="rounding method"):
        AR.round_column(a, 0, "HALF_DOWN")
