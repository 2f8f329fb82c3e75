"""PyTorch port: ops/cast_more (bin, hex, decimal to string,
format_number, string to date and timestamp) and ops/datetime_ops'
civil_days_scalar against the JAX package, byte for byte, on seeded
values and the cases and goldens of tests/test_cast_more.py."""

import datetime

import numpy as np
import pytest

from spark_rapids_tpu.columns import dtypes as jdtypes
from spark_rapids_tpu.columns.column import Column as JColumn
from spark_rapids_tpu.ops import cast_more as JCM
from spark_rapids_tpu.ops import datetime_ops as JDT
from spark_rapids_tpu.ops.exceptions import CastException as JCast
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import cast_more as CM
from spark_rapids_tpu_torch.ops import datetime_ops as DT
from spark_rapids_tpu_torch.ops.exceptions import CastException
from torch_port_data import (col_parts, jax_column, port_column,
                             strings_spec, values_spec)


def both(spec):
    return port_column(spec), jax_column(spec)


def same(got, want):
    assert col_parts(got) == col_parts(want)


def d2e(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def int64_values(seed, n=500):
    rng = np.random.default_rng(seed)
    vals = [int(x) for x in rng.integers(-2**63, 2**63 - 1, n,
                                         endpoint=True)]
    vals[:8] = [0, 1, -1, 13, 2**63 - 1, -2**63, None, 255]
    vals[8:200] = [int(x) for x in rng.integers(0, 1 << 20, 192)]
    return vals


def test_long_to_binary_string_matches_reference():
    p, j = both(values_spec("int64", int64_values(1)))
    same(CM.long_to_binary_string(p), JCM.long_to_binary_string(j))
    c = Column.from_pylist([13, 0, 1, None, -1], dtypes.INT64, "cpu")
    assert CM.long_to_binary_string(c).to_pylist() == \
        ["1101", "0", "1", None, "1" * 64]


def test_long_to_binary_string_all_null_and_empty():
    p, j = both(values_spec("int64", [None, None]))
    same(CM.long_to_binary_string(p), JCM.long_to_binary_string(j))
    p, j = both(values_spec("int64", []))
    assert CM.long_to_binary_string(p).length == 0


def test_hex_matches_reference():
    p, j = both(values_spec("int64", int64_values(2)))
    same(CM.long_to_hex_string(p), JCM.long_to_hex_string(j))
    vals = ["abc", None, "", "日本", "\x00\xff"]
    p, j = both(strings_spec(vals))
    same(CM.bytes_to_hex(p), JCM.bytes_to_hex(j))
    assert CM.bytes_to_hex(p).to_pylist()[:3] == ["616263", None, ""]
    c = Column.from_pylist([255, 0, 4096, None], dtypes.INT64, "cpu")
    assert CM.long_to_hex_string(c).to_pylist() == ["FF", "0", "1000",
                                                    None]


@pytest.mark.parametrize("kind,scale", [("decimal128", -2),
                                        ("decimal128", 2),
                                        ("decimal128", 0),
                                        ("decimal128", -38),
                                        ("decimal64", -4),
                                        ("decimal32", -1)])
def test_decimal_to_string_matches_reference(kind, scale):
    rng = np.random.default_rng(abs(scale) + len(kind))
    bits = {"decimal32": 31, "decimal64": 63, "decimal128": 126}[kind]
    vals = [int(x) >> int(s) for x, s in zip(
        rng.integers(-2**62, 2**62, 200), rng.integers(0, 60, 200))]
    if kind == "decimal128":
        vals[:3] = [10**38 - 1, -(10**38 - 1), -(2**126)]
    vals = [max(min(v, 2**bits - 1), -2**bits) for v in vals]
    vals[5] = None
    vals[6] = 0
    got = CM.decimal_to_non_ansi_string(Column.from_pylist(
        vals, dtypes.DType(kind, scale), "cpu"))
    want = JCM.decimal_to_non_ansi_string(JColumn.from_pylist(
        vals, jdtypes.DType(kind, scale)))
    same(got, want)


def test_decimal_to_string_goldens():
    c = Column.from_pylist([12345, -12345, 5, 0, None],
                           dtypes.decimal128(-2), "cpu")
    assert CM.decimal_to_non_ansi_string(c).to_pylist() == \
        ["123.45", "-123.45", "0.05", "0.00", None]
    c2 = Column.from_pylist([42], dtypes.decimal128(2), "cpu")
    assert CM.decimal_to_non_ansi_string(c2).to_pylist() == ["4200"]


@pytest.mark.parametrize("kind,digits", [("float64", 2), ("float64", 0),
                                         ("float32", 3), ("int64", 0),
                                         ("int32", 2), ("float64", -1)])
def test_format_number_matches_reference(kind, digits):
    rng = np.random.default_rng(len(kind) * 10 + digits)
    if kind.startswith("float"):
        vals = list(rng.normal(size=200) * 10.0 ** rng.integers(-3, 9, 200))
        vals[:6] = [float("nan"), float("inf"), float("-inf"), -0.0, 0.5,
                    1234567.891]
    else:
        vals = [int(x) for x in rng.integers(-10**9, 10**9, 200)]
    vals[7] = None
    p, j = both(values_spec(kind, vals))
    same(CM.format_number(p, digits), JCM.format_number(j, digits))


def test_format_number_goldens():
    c = Column.from_pylist([1234567.891, -0.5, None], dtypes.FLOAT64, "cpu")
    assert CM.format_number(c, 2).to_pylist() == \
        ["1,234,567.89", "-0.50", None]
    i = Column.from_pylist([1234567], dtypes.INT64, "cpu")
    assert CM.format_number(i, 0).to_pylist() == ["1,234,567"]


DATE_TEXT = ["2023-07-26", "2023-7-6", "2023", "2023-02", "2023-02-30",
             "bogus", None, "2023-07-26 anything", "2023-07-26Tx",
             " 2020-02-29 ", "1900-02-29", "0000-02-29", "-0044-03-15",
             "+12345-01-01", "2023-13-01", "2023-00-10", "", "   ",
             "2023-07-26T14:30:05", "2023-07-26 14:30:05.123456",
             "2023-07-26T14:30:05Z", "2023-07-26T14:30:05+02:00",
             "2023-07-26T14:30:05-05:30", "2023-07-26 25:00:00",
             "2023-07-26T14:61", "1582-10-10", "9999-12-31",
             "2023-07-26T14:30:05.1", "2023-07-26T1:2:3"]


def _seeded_dates(seed, n=300):
    rng = np.random.default_rng(seed)
    days = rng.integers(d2e(1000, 1, 1), d2e(2500, 1, 1), n)
    out = []
    for k, d in enumerate(days):
        t = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d))
        s = t.isoformat()
        if k % 3 == 1:
            s += " %02d:%02d:%02d" % (k % 24, k % 60, (k * 7) % 60)
        elif k % 3 == 2:
            s += "T%02d:%02d" % (k % 24, k % 60)
        out.append(s)
    return out


def test_parse_dates_and_timestamps_match_reference():
    text = DATE_TEXT + _seeded_dates(3)
    p, j = both(strings_spec(text))
    same(CM.parse_strings_to_date(p), JCM.parse_strings_to_date(j))
    for off in (0, 3600, -19800):
        same(CM.parse_timestamp_strings(p, off),
             JCM.parse_timestamp_strings(j, off))


@pytest.mark.parametrize("fmt,text", [
    ("dd/MM/yyyy HH:mm", ["26/07/2023 14:30", "bad", None,
                          "31/02/2023 10:00", "01/01/1999 23:59"]),
    ("yyyy-MM-dd HH:mm:ss.SSS", ["2023-07-26 14:30:05.123",
                                 " 2023-07-26 14:30:05.999 ",
                                 "2023-07-26 14:30:05"]),
    ("yyyyMMddHHmmssSSSSSS", ["20230726143005123456", "2023072614300"]),
])
def test_parse_with_format_matches_reference(fmt, text):
    p, j = both(strings_spec(text))
    same(CM.parse_timestamp_strings_with_format(p, fmt),
         JCM.parse_timestamp_strings_with_format(j, fmt))


def test_ansi_raises_at_the_reference_row():
    text = ["2023-01-01", None, "2023-02-30", "x"]
    p, j = both(strings_spec(text))
    for fn, jfn in ((CM.parse_strings_to_date, JCM.parse_strings_to_date),
                    (CM.parse_timestamp_strings,
                     JCM.parse_timestamp_strings)):
        with pytest.raises(CastException) as got:
            fn(p, ansi_mode=True) if fn is CM.parse_strings_to_date \
                else fn(p, 0, True)
        with pytest.raises(JCast) as want:
            jfn(j, ansi_mode=True) if jfn is JCM.parse_strings_to_date \
                else jfn(j, 0, True)
        assert got.value.row_index == want.value.row_index == 2
    ok = strings_spec(["2023-01-01", None])
    same(CM.parse_strings_to_date(port_column(ok), ansi_mode=True),
         JCM.parse_strings_to_date(jax_column(ok), ansi_mode=True))


def test_parse_goldens():
    c = Column.from_strings(["2023-07-26", "2023-02-30", "0000-02-29"],
                            "cpu")
    assert CM.parse_strings_to_date(c).to_pylist()[:2] == \
        [d2e(2023, 7, 26), None]
    assert CM.parse_strings_to_date(c).to_pylist()[2] is not None
    base = int(datetime.datetime(2023, 7, 26, 14, 30, 5,
                                 tzinfo=datetime.timezone.utc)
               .timestamp() * 1e6)
    t = Column.from_strings(["2023-07-26T14:30:05+02:00"], "cpu")
    assert CM.parse_timestamp_strings(t).to_pylist() == \
        [base - 7200 * 1_000_000]


def test_civil_days_scalar_matches_reference():
    rng = np.random.default_rng(9)
    for y, m, d in zip(rng.integers(-5000, 12000, 400),
                       rng.integers(1, 13, 400), rng.integers(1, 29, 400)):
        assert DT.civil_days_scalar(int(y), int(m), int(d)) == \
            JDT.civil_days_scalar(int(y), int(m), int(d))
    assert DT.civil_days_scalar(1970, 1, 1) == 0
    assert DT.civil_days_scalar(2000, 3, 1) == d2e(2000, 3, 1)
