"""PyTorch port: the Spark string casts held byte for byte against the JAX
package -- string_to_integer, string_to_float (its Eisel-Lemire device
engine and its host oracle), float_to_string (its Ryu device engine and
its host oracle), string_to_decimal, the base conversions, the u64 lane
helpers and the JNI door's string_to_integer.

The cases are those of tests/test_cast_string.py, test_stod_device.py and
test_ftos_device.py, the same host columns built for both packages
(tests/torch_port_data.py, columns/interop.py) and compared on host
bytes: data (null rows too), validity and offsets.  Every float case
runs on both engines (SPARK_RAPIDS_TPU_STOD / _FTOS = device, host).
Each float column is padded to one shape (FLOAT_ROWS x FLOAT_WIDTH
chars, or FLOAT_ROWS values) so the JAX package compiles its engines
once a process.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columns import dtypes as jdtypes
from spark_rapids_tpu.ops import cast_string as JCS
from spark_rapids_tpu.ops import ftos_device as JFD
from spark_rapids_tpu.ops import stod_device as JSD
from spark_rapids_tpu.ops.exceptions import CastException as JCastException
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.ops import cast_string as CS
from spark_rapids_tpu_torch.ops import ftos_device as FD
from spark_rapids_tpu_torch.ops import stod_device as SD
from spark_rapids_tpu_torch.ops.exceptions import CastException
from spark_rapids_tpu_torch.shim import jni_api
from spark_rapids_tpu_torch.shim.handles import REGISTRY
from spark_rapids_tpu_torch.utils import u64math

from torch_port_data import (col_parts, jax_column, port_column,
                             strings_spec, values_spec)

FLOAT_ROWS = 4096
FLOAT_WIDTH = 320
INT_ROWS = 32
INT_WIDTH = 24


def _pad(values, rows, width):
    """`values` plus all-blank filler rows (invalid for every cast) up to
    `rows` rows, one of them `width` bytes wide."""
    assert len(values) < rows
    assert max(len(v) for v in values if v is not None) <= width
    return list(values) + [" " * width] + [" "] * (rows - len(values) - 1)


def _both(spec):
    return jax_column(spec), port_column(spec)


def _same(got, want):
    assert col_parts(got) == col_parts(want)


def _same_raise(call_port, call_jax):
    """Both raise the cast error at the same row with the same string."""
    with pytest.raises(JCastException) as want:
        call_jax()
    with pytest.raises(CastException) as got:
        call_port()
    assert got.value.row_index == want.value.row_index
    assert got.value.string_with_error == want.value.string_with_error


# ---------------------------------------------------- string -> integer

INT_CASES = {
    # castToIntegerTest / castToIntegerNoStripTest vectors
    "strip_long": [" 3", "9", "4", "2", "20.5", None, "7.6asd",
                   "\x00 \x1f1\x14"],
    "strip_int": ["5", "1  ", "0", "2", "7.1", None, "asdf",
                  "\x00 \x1f1\x14"],
    "strip_byte": ["2", "3", " 4 ", "5", " 9.2 ", None, "7.8.3",
                   "\x00 \x1f1\x14"],
    "no_strip": ["2", "3", " 4 ", "5.6", " 9.2 ", None, "7.8.3", "1 "],
    "signs_overflow": ["-128", "127", "128", "-129", "+5", "-", "+", "--1",
                       "1-", "", "9223372036854775807",
                       "-9223372036854775808", "9223372036854775808",
                       "-9223372036854775809", "2147483648", "-2147483649"],
    "dot_quirks": [".", ".5", "+.5", "1.", "1.2.3", ". 5", "-7.5", "99.5 "],
    "ansi_ok": ["3", None, "5", " 7 "],
    "ansi_bad": ["3", "bad", "5"],
}


def _int_column(values):
    """`values` padded with "0" rows (valid for every cast) to INT_ROWS
    rows, one of them INT_WIDTH bytes wide: one shape for every call."""
    assert len(values) < INT_ROWS
    return strings_spec(list(values) + ["0" * INT_WIDTH]
                        + ["0"] * (INT_ROWS - len(values) - 1))


@pytest.mark.parametrize("strip", [True, False])
@pytest.mark.parametrize("kind", ["int64", "int32", "int8"])
def test_string_to_integer_matches_reference(kind, strip):
    """Every case in one column."""
    jt, pt = jdtypes.DType(kind), dtypes.DType(kind)
    every = [v for case in sorted(INT_CASES) for v in INT_CASES[case]]
    j, p = _both(strings_spec(every))
    _same(CS.string_to_integer(p, pt, strip=strip),
          JCS.string_to_integer(j, jt, strip=strip))


@pytest.mark.parametrize("kind,strip", [("int64", True), ("int8", False)])
@pytest.mark.parametrize("case", ["ansi_ok", "ansi_bad", "dot_quirks"])
def test_string_to_integer_ansi_matches_reference(case, kind, strip):
    """ANSI mode: the result with the input's validity, or the same
    CastException row and string."""
    jt, pt = jdtypes.DType(kind), dtypes.DType(kind)
    j, p = _both(_int_column(INT_CASES[case]))
    try:
        want = JCS.string_to_integer(j, jt, ansi_mode=True, strip=strip)
    except JCastException:
        _same_raise(
            lambda: CS.string_to_integer(p, pt, ansi_mode=True,
                                         strip=strip),
            lambda: JCS.string_to_integer(j, jt, ansi_mode=True,
                                          strip=strip))
    else:
        _same(CS.string_to_integer(p, pt, ansi_mode=True, strip=strip),
              want)


def test_string_to_integer_no_rows():
    j, p = _both(strings_spec([]))
    _same(CS.string_to_integer(p, dtypes.INT32),
          JCS.string_to_integer(j, jdtypes.INT32))


def test_jni_string_to_integer_matches_reference():
    values = INT_CASES["signs_overflow"] + INT_CASES["dot_quirks"]
    j, _ = _both(strings_spec(values))
    start = REGISTRY.live_count()
    h = jni_api.make_column_from_host(values, dtypes.STRING, device="cpu")
    out = jni_api.string_to_integer(h, "int64", False, True)
    try:
        _same(REGISTRY.get(out),
              JCS.string_to_integer(j, jdtypes.INT64, False, True))
        assert REGISTRY.get(out).device.type == "cpu"
    finally:
        jni_api.release_column(out)
        jni_api.release_column(h)
    assert REGISTRY.live_count() == start


# ------------------------------------------------------ string -> float

def _mantissas_past_2_63():
    """19-digit mantissas from 2^63 - 1 to 10^19 - 1 (negative on int64
    lanes), with decimal points and exponents."""
    rng = np.random.default_rng(63)
    fixed = ["9223372036854775807", "9223372036854775808",
             "9223372036854775809", "9999999999999999999",
             "18446744073709551615", "18446744073709551616",
             "9999999999999999999e-19", "9223372036854775808e-300",
             "-9999999999999999999e308", "9.999999999999999999",
             "0.9223372036854775808", "922337203685477580.8e1"]
    out = list(fixed)
    for _ in range(500):
        m = int(rng.integers(2**63 - 1, 10**19 - 1, dtype=np.uint64))
        s = str(m)
        if rng.random() < 0.5:
            cut = int(rng.integers(0, 20))
            s = s[:cut] + "." + s[cut:]
        if rng.random() < 0.7:
            s += "e" + str(int(rng.integers(-340, 310)))
        out.append(("-" if rng.random() < 0.3 else "") + s)
    return out


def _random_decimals():
    rng = np.random.default_rng(21)
    strings = []
    for _ in range(3000):
        nd = int(rng.integers(1, 26))
        digits = "".join(rng.choice(list("0123456789"), nd))
        s = ("-" if rng.random() < 0.5 else "") + digits
        if rng.random() < 0.7:
            cut = int(rng.integers(0, len(digits) + 1))
            s = ("-" if s[0] == "-" else "") + digits[:cut] + "." \
                + digits[cut:]
        if rng.random() < 0.6:
            s += "e" + str(int(rng.integers(-345, 330)))
        strings.append(s)
    return strings


def _random_double_reprs():
    bits = np.random.default_rng(22).integers(0, 1 << 64, 3000,
                                              dtype=np.uint64)
    vals = bits.view(np.float64)
    return [repr(float(v)) for v in vals[np.isfinite(vals)]]


STOD_EDGES = [
    "1", "0", "-0", "0.0", "-0.0", ".5", "5.", "+.5", "1e5",
    "1E5", "1e+5", "1e-5", "-1.5e-300", "1.7976931348623157e308",
    "1.8e308", "-1.8e308", "4.9e-324", "1e-324", "2.2250738585072014e-308",
    "9007199254740993", "9007199254740992.5",
    "123456789012345678901234567890",
    "0.000000000000000000000000000001", "1e400", "-1e400", "1e-400",
    "inf", "Infinity", "-inf", "+infinity", "nan", "NaN", "+nan",
    "-nan", "", "  ", " 12 ", "\t7\n", "abc", "1e", "1e+", ".",
    "+", "-", "--1", "1.2.3", "0x1p3", "1_0", "1d", "12f",
    "00012.5", "1.place", "5e-1", "1e19", "18446744073709551616",
    "2.5", "3.5", "0.5", "1.5", "4.5", ("9" * 40),
    "0." + "0" * 40 + "1", "1" + "0" * 308, "17e-1", "125e-2", None,
    "1.4e-45", "1e-46", "3.4028236e38", "1.17549435e-38"]

FLOAT_CASES = {
    # castToFloatsTrimTest, castToFloatNanTest/castToFloatsInfTest,
    # castToDoubleHighPrecisionTest, the python-extension rejections
    "trim": ["1.1\x00", "1.2\x14", "1.3\x1f", "\x00\x001.4\x00",
             "1.5\x00 \x00", "1.6", "1.7!"],
    "nan_inf": ["nan", "nan ", " nan ", "NAN", "nAn ", " NAn ", "Nan 0",
                "+naN", "-nAn", "INFINITY ", "inf", "+inf ", " -INF  ",
                "INFINITY AND BEYOND", "INF"],
    "high_precision": ["1.7976931348623157", "9.9999999999999999",
                       "1.0000000000000001", "1.0000000000000002",
                       "3.1415926535897932", "1.234567890123456789",
                       "-1.7976931348623157", "9007199254740993e10",
                       "12345678901234567e7", "-9007199254740993e15"],
    "extensions": ["1_000", "0x10", "1e5", "1e", "  "],
    "edges": STOD_EDGES,
    "ordinary": [f"{i}.{i % 100:02d}" for i in range(2000)],
    "ansi_routing": ["1.5", "bad", "2.5"] * 20,
    "past_2_63": _mantissas_past_2_63(),
    "random_decimals": _random_decimals(),
    "random_double_reprs": _random_double_reprs(),
}


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("kind", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
def test_string_to_float_matches_reference(case, kind, engine,
                                           monkeypatch):
    """Bits, validity and, on the device engine, as many rows sent to
    the host parse as the reference sends there."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STOD", engine)
    j, p = _both(strings_spec(_pad(FLOAT_CASES[case], FLOAT_ROWS,
                                   FLOAT_WIDTH)))
    jt, pt = jdtypes.DType(kind), dtypes.DType(kind)
    got = CS.string_to_float(p, pt)
    seen = []
    real = JCS._float_host_rows

    def counting(col, idx, is_f32):
        seen.append(len(idx))
        return real(col, idx, is_f32)
    monkeypatch.setattr(JCS, "_float_host_rows", counting)
    _same(got, JCS.string_to_float(j, jt))
    if engine == "device":
        assert SD.LAST_CALL["fallback_rows"] == sum(seen)


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("case", ["ansi_routing", "high_precision"])
def test_string_to_float_ansi_matches_reference(case, engine, monkeypatch):
    """ANSI mode: the first bad row's CastException, or the result with
    the input's validity."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STOD", engine)
    values = FLOAT_CASES[case]
    values = values + ["0"] * (FLOAT_ROWS - len(values) - 1) \
        + ["0" * FLOAT_WIDTH]
    j, p = _both(strings_spec(values))
    for kind in ("float64", "float32"):
        jt, pt = jdtypes.DType(kind), dtypes.DType(kind)
        try:
            want = JCS.string_to_float(j, jt, ansi_mode=True)
        except JCastException:
            _same_raise(lambda: CS.string_to_float(p, pt, ansi_mode=True),
                        lambda: JCS.string_to_float(j, jt, ansi_mode=True))
        else:
            _same(CS.string_to_float(p, pt, ansi_mode=True), want)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_string_to_float_no_rows(engine, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STOD", engine)
    j, p = _both(strings_spec([]))
    _same(CS.string_to_float(p, dtypes.FLOAT64),
          JCS.string_to_float(j, jdtypes.FLOAT64))


def test_routing_threshold():
    """Below SPARK_RAPIDS_TPU_STOD_MIN_ROWS rows the host oracle runs;
    from it on, the device engine (both packages read the same knob)."""
    assert SD.DEVICE_MIN_ROWS == JSD.DEVICE_MIN_ROWS
    assert FD.DEVICE_MIN_ROWS == JFD.DEVICE_MIN_ROWS
    small = port_column(strings_spec(["1.5"] * (SD.DEVICE_MIN_ROWS - 1)))
    big = port_column(strings_spec(["1.5"] * SD.DEVICE_MIN_ROWS))
    assert not SD.use_device(small) and SD.use_device(big)


def test_narrow_to_f32_matches_reference():
    """f64 -> f32 narrowing on integer lanes, subnormal inputs flagged
    (the reference's ADVICE r2 case) and a seeded sample of patterns."""
    import jax.numpy as jnp

    rng = np.random.default_rng(32)
    vals = np.concatenate([
        np.array([5e-324, 1e-310, 0.0, -0.0, 1.5, -2.25, 3.5e38, -1e39,
                  1e-40, np.inf, -np.inf, np.nan]),
        rng.standard_normal(500) * 10.0 ** rng.integers(-50, 50, 500)])
    bits = vals.view(np.uint64)
    want, want_fb = JSD._narrow_to_f32(jnp.asarray(bits))
    got, got_fb = SD._narrow_to_f32(torch.from_numpy(bits.view(np.int64)))
    assert (got.numpy().view(np.uint64) == np.asarray(want)).all()
    assert (got_fb.numpy() == np.asarray(want_fb)).all()


# ------------------------------------------------------ float -> string

EDGE_F64 = [0.0, -0.0, 1.0, -1.0, 10.0, 0.5, 0.1, 1e-3, 9.999999e-4,
            1e7, 9999999.0, 1e-323, 5e-324, 1.7976931348623157e308,
            2.2250738585072014e-308, 123456.789, 3.141592653589793,
            1e16, 1e-16, 2.0 ** 53, 2.0 ** 53 - 1, 1.5e300, -2.5e-7,
            float("nan"), float("inf"), float("-inf"), None, 64.0,
            1.23e-290, 7.038531e-26, 100.0, 0.001, 0.0001, -1.23e-5]
EDGE_F32 = [0.0, -0.0, 1.0, -1.0, 0.1, 1e-3, 1e7, 3.4028235e38,
            1.4e-45, 1.1754944e-38, 3.1415927, None, 1e-44,
            float("nan"), float("inf"), float("-inf"), 16777216.0,
            0.33333334, -2.5e-7, 7.038531e-26, 1.5]


def _bits_spec(kind, bits):
    """A float host column of raw bit patterns."""
    if kind == "float64":
        return ("float64", bits.astype(np.uint64), None)
    return ("float32", bits.astype(np.uint32).view(np.float32), None)


def _random_bits(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "float64":
        return rng.integers(0, 1 << 64, 4000, dtype=np.uint64)
    return rng.integers(0, 1 << 32, 4000, dtype=np.uint64)


def _subnormals_and_boundaries():
    rng = np.random.default_rng(13)
    return np.concatenate([
        rng.integers(0, 1 << 52, 500, dtype=np.uint64),        # subnormal
        (rng.integers(1, 0x7FF, 500, dtype=np.uint64) << 52),  # pow2
        (rng.integers(1, 0x7FF, 500, dtype=np.uint64) << 52) | 1,
        (rng.integers(1, 0x7FF, 500, dtype=np.uint64) << 52)
        | ((1 << 52) - 1)])


FTOS_CASES = {
    "edges_f64": lambda: values_spec("float64", EDGE_F64),
    "edges_f32": lambda: values_spec(
        "float32", [None if v is None else float(np.float32(v))
                    for v in EDGE_F32]),
    "random_bits_f64": lambda: _bits_spec("float64",
                                          _random_bits("float64", 11)),
    "random_bits_f32": lambda: _bits_spec("float32",
                                          _random_bits("float32", 12)),
    "subnormals_boundaries_f64": lambda: _bits_spec(
        "float64", _subnormals_and_boundaries()),
    "routing_f64": lambda: values_spec("float64", [1.5] * 40),
}


def _pad_values(spec):
    """The host column padded to FLOAT_ROWS with valid 0.0 rows."""
    kind, data, validity = spec
    pad = FLOAT_ROWS - data.shape[0]
    if validity is not None:
        validity = np.concatenate([validity, np.ones(pad, np.uint8)])
    return (kind, np.concatenate([data, np.zeros(pad, data.dtype)]),
            validity)


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("case", sorted(FTOS_CASES))
def test_float_to_string_matches_reference(case, engine, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FTOS", engine)
    j, p = _both(_pad_values(FTOS_CASES[case]()))
    _same(CS.float_to_string(p), JCS.float_to_string(j))


def test_float_to_string_no_rows():
    j, p = _both(values_spec("float64", []))
    _same(FD.float_to_string_device(p), JFD.float_to_string_device(j))


def test_ryu_tables_match_reference():
    for name in ("_D_INV", "_D_POW5", "_F_INV", "_F_POW5", "_POW10_U64"):
        assert getattr(FD, name).tobytes() == \
            getattr(JFD, name).tobytes(), name
    assert SD._POW10_HI.tobytes() == JSD._POW10_HI.tobytes()


@pytest.mark.parametrize("kind", ["float64", "float32"])
def test_random_bits_render_and_parse_back(kind, monkeypatch):
    """4,096 seeded bit patterns rendered by the device engine and parsed
    back by the device parse engine: the same strings as the reference,
    and every finite value back bit for bit (Java's shortest repr
    round-trips)."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FTOS", "device")
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STOD", "device")
    rng = np.random.default_rng(4096)
    bits = rng.integers(0, 1 << (64 if kind == "float64" else 32),
                        FLOAT_ROWS, dtype=np.uint64)
    j, p = _both(_bits_spec(kind, bits))
    s_port, s_ref = CS.float_to_string(p), JCS.float_to_string(j)
    _same(s_port, s_ref)
    back = CS.string_to_float(s_port, dtypes.DType(kind))
    width = np.int64 if kind == "float64" else np.int32
    got = back.data.numpy().view(width)
    want = p.data.numpy().view(width)
    vals = p.data.numpy()
    finite = np.isfinite(vals)
    assert back.validity.numpy().all()
    assert (got[finite] == want[finite]).all()
    assert np.isnan(back.data.numpy()[~np.isfinite(vals)
                                      & np.isnan(vals)]).all()


# ------------------------------------------------------ decimal and base

DECIMAL_CASES = {
    # castToDecimalTest vectors and the more/hostile cases
    "ref_p2_s0": ([" 3", "9", "4", "2", "20.5", None, "7.6asd",
                   "\x00 \x1f1\x14"], 2, 0, True),
    "ref_p10_s0": (["5", "1 ", "0", "2", "7.1", None, "asdf",
                    "\x00 \x1f1\x14"], 10, 0, True),
    "ref_p3_sm1": (["2", "3", " 4 ", "5.07", "9.23", None, "7.8.3",
                    "\x00 \x1f1\x14"], 3, -1, True),
    "more": (["1e2", "-3.555", "999", "0.004", ""], 5, -2, True),
    "overflow": (["12345"], 3, 0, True),
    "no_strip": ([" 3", "3"], 3, 0, False),
    "wide": (["1" * 25, "-" + "9" * 30, "0.5"], 30, 0, True),
    "hostile": (["1e2147483647", "-5e2147483647", "1e-2147483647",
                 "0e2147483647"], 10, 0, True),
}


@pytest.mark.parametrize("case", sorted(DECIMAL_CASES))
def test_string_to_decimal_matches_reference(case):
    values, precision, scale, strip = DECIMAL_CASES[case]
    j, p = _both(strings_spec(values))
    _same(CS.string_to_decimal(p, precision, scale, strip=strip),
          JCS.string_to_decimal(j, precision, scale, strip=strip))
    try:
        want = JCS.string_to_decimal(j, precision, scale, True, strip)
    except JCastException:
        _same_raise(
            lambda: CS.string_to_decimal(p, precision, scale, True, strip),
            lambda: JCS.string_to_decimal(j, precision, scale, True, strip))
    else:
        _same(CS.string_to_decimal(p, precision, scale, True, strip), want)


BASE_CASES = {
    # baseDec2HexTestNoNulls / Mixed and baseHex2DecTest vectors
    "dec": (["510", "00510", "00-510"], 10),
    "dec_mixed": ([None, " ", "junk-510junk510", "--510",
                   "   -510junk510", "  510junk510", "510", "00510",
                   "00-510", "\t510", "99999999999999999999999"], 10),
    "hex": ([None, "junk", "0", "f", "junk-5Ajunk5A", "--5A",
             "   -5Ajunk5A", "  5Ajunk5A", "5a", "05a", "005a", "00-5a",
             "NzGGImWNRh"], 16),
}


@pytest.mark.parametrize("kind", ["uint64", "int32", "int8"])
@pytest.mark.parametrize("case", sorted(BASE_CASES))
def test_integers_with_base_match_reference(case, kind):
    values, base = BASE_CASES[case]
    j, p = _both(strings_spec(values))
    got = CS.string_to_integers_with_base(p, base,
                                          dtype=dtypes.DType(kind))
    want = JCS.string_to_integers_with_base(j, base,
                                            dtype=jdtypes.DType(kind))
    _same(got, want)
    for to_base in (10, 16):
        _same(CS.integers_with_base_to_string(got, to_base),
              JCS.integers_with_base_to_string(want, to_base))
    if case == "dec_mixed":
        _same_raise(
            lambda: CS.string_to_integers_with_base(p, base, True),
            lambda: JCS.string_to_integers_with_base(j, base, True))


def test_integers_with_base_to_string_signed_matches_reference():
    spec = values_spec("int32", [123, -1, 0, 27, 342718233, None])
    j, p = _both(spec)
    for to_base in (10, 16):
        _same(CS.integers_with_base_to_string(p, to_base),
              JCS.integers_with_base_to_string(j, to_base))


# -------------------------------------------------------------- u64 lanes

U64_EDGES = [0, 1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
             (1 << 63) + 1, (1 << 64) - 1, 10 ** 19 - 1, 0xFFFFFFFF00000000]


def _u64_lanes(values):
    t = torch.tensor([v - (1 << 64) if v >= 1 << 63 else v
                      for v in values], dtype=torch.int64)
    return t


def _u64(t):
    return [int(x) & ((1 << 64) - 1) for x in t.tolist()]


def test_umul128_and_clz64_match_python_ints():
    rng = np.random.default_rng(128)
    a = U64_EDGES + [int(x) for x in rng.integers(0, 1 << 64, 500,
                                                  dtype=np.uint64)]
    b = list(reversed(U64_EDGES)) + [
        int(x) >> int(s) for x, s in zip(
            rng.integers(0, 1 << 64, 500, dtype=np.uint64),
            rng.integers(0, 64, 500))]
    lo, hi = u64math.umul128(_u64_lanes(a), _u64_lanes(b))
    for x, y, gl, gh in zip(a, b, _u64(lo), _u64(hi)):
        assert gl == (x * y) & ((1 << 64) - 1) and gh == (x * y) >> 64
    clz = u64math.clz64(_u64_lanes(a)).tolist()
    assert clz == [64 - x.bit_length() for x in a]
    s = [int(k) for k in rng.integers(0, 64, len(a))]
    got = _u64(u64math.shr(_u64_lanes(a), torch.tensor(s)))
    assert got == [x >> k for x, k in zip(a, s)]
    assert u64math.ult(_u64_lanes(a), _u64_lanes(b)).tolist() == \
        [x < y for x, y in zip(a, b)]
