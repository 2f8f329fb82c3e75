"""PyTorch port: the datetime ops (ops/datetime_ops), the ORC writer-zone
rectification (ops/orc_timezones) and the TZif parser (utils/tzdb)
against the JAX package's and against independent oracles (zoneinfo,
the reference's DateTimeUtilsTest vectors): the cases of
tests/test_decimal_datetime.py's datetime half and of
tests/test_orc_timezones.py, tzdb's tables equal to the reference's, and
every op on seeded dates and instants of 1500-2100 (Julian dates and
pre-1970 instants, 4% nulls) byte for byte against the JAX package."""

import datetime
import random
import zoneinfo

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columns import dtypes as jdtypes
from spark_rapids_tpu.columns.column import Column as JColumn
from spark_rapids_tpu.ops import datetime_ops as jdt
from spark_rapids_tpu.ops import orc_timezones as JOT
from spark_rapids_tpu.utils import tzdb as jtzdb
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import datetime_ops as dt
from spark_rapids_tpu_torch.ops import orc_timezones as OT
from spark_rapids_tpu_torch.utils import tzdb
from torch_port_data import col_parts

ZONES = ["America/Los_Angeles", "Asia/Shanghai", "Asia/Tokyo",
         "Australia/Sydney", "Europe/London", "Antarctica/DumontDUrville",
         "Etc/GMT-12", "UTC"]
COMPONENTS = ["YEAR", "YYYY", "YY", "QUARTER", "MONTH", "MON", "MM",
              "WEEK", "DAY", "DD", "HOUR", "MINUTE", "SECOND",
              "MILLISECOND", "MICROSECOND"]
US_1500 = -14831769600 * 10**6     # 1500-01-01T00:00:00Z
US_2100 = 4102444800 * 10**6       # 2100-01-01T00:00:00Z


def d2e(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def pair(values, dtype, null_every=0):
    """(port column on the CPU, JAX column) over the same host values."""
    arr = np.asarray(values, dtype.np_dtype)
    valid = None
    if null_every:
        valid = (np.arange(len(arr)) % null_every != 0).astype(np.uint8)
    port = Column(dtype, len(arr), data=torch.from_numpy(arr.copy()),
                  validity=None if valid is None
                  else torch.from_numpy(valid))
    jax = JColumn(jdtypes.DType(dtype.kind, dtype.scale), len(arr),
                  data=jnp.asarray(arr),
                  validity=None if valid is None else jnp.asarray(valid))
    return port, jax


def same(got, want):
    assert col_parts(got) == col_parts(want)


def seeded_days(n=4099, seed=0):
    rng = np.random.default_rng(seed)
    days = rng.integers(d2e(1500, 1, 1), d2e(2100, 1, 1), n)
    edges = [d2e(1582, 10, 4), d2e(1582, 10, 5), d2e(1582, 10, 14),
             d2e(1582, 10, 15), -1, 0, 1, d2e(1600, 2, 29),
             d2e(1700, 2, 28), d2e(1700, 3, 1), d2e(2000, 2, 29)]
    return np.concatenate([edges, days]).astype(np.int32)


def seeded_micros(n=4099, seed=1):
    rng = np.random.default_rng(seed)
    us = rng.integers(US_1500, US_2100, n)
    edges = [-1, 0, 1, -999_999, -1_000_000, -1_000_001, -86_400_000_001,
             US_1500, US_2100 - 1, -12219292799000001, -12219292800000000]
    return np.concatenate([edges, us]).astype(np.int64)


# ------------------------------------------------ test_decimal_datetime


def test_floor_division_before_1970():
    x = torch.tensor([-1, -999_999, -1_000_000, -1_000_001, 0, 1_000_001],
                     dtype=torch.int64)
    assert dt._fdiv(x, 1_000_000).tolist() == [-1, -1, -1, -2, 0, 1]
    days, tod = dt._split_micros(Column(dtypes.TIMESTAMP_MICROS, 3,
                                        data=torch.tensor([-1, -86_400_000_000,
                                                           -86_400_000_001])))
    assert days.tolist() == [-1, -1, -2]
    assert tod.tolist() == [86_399_999_999, 0, 86_399_999_999]


def test_tz_fallback_overlap_uses_earlier_offset():
    wall = datetime.datetime(2023, 11, 5, 1, 30)
    us = int(wall.replace(tzinfo=datetime.timezone.utc).timestamp() * 1e6)
    c = Column.from_pylist([us], dtypes.TIMESTAMP_MICROS, device="cpu")
    out = dt.convert_timestamp_to_utc(c, "America/Los_Angeles")
    got = datetime.datetime.fromtimestamp(out.to_pylist()[0] / 1e6,
                                          datetime.timezone.utc)
    assert got.hour == 8 and got.minute == 30


@pytest.mark.parametrize("bad", ["/etc/passwd", "..", "../passwd",
                                 "America/../../etc", "Nowhere/Town"])
def test_tzdb_bad_zone_rejected(bad):
    with pytest.raises(ValueError) as got:
        tzdb.get_transitions(bad)
    with pytest.raises(ValueError) as want:
        jtzdb.get_transitions(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("zone", ZONES)
def test_tzdb_tables_equal_reference(zone):
    got, want = tzdb.get_zone_info(zone), jtzdb.get_zone_info(zone)
    for name in ("trans", "offs", "isdst"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.footer == want.footer
    assert (np.diff(got.trans) > 0).all()


def test_civil_date_roundtrip():
    days = torch.arange(-200000, 200000, 997, dtype=torch.int64)
    y, m, d = dt._days_to_ymd(days)
    assert torch.equal(dt._ymd_to_days(y, m, d), days)
    jy, jm, jd = jdt._days_to_ymd(jnp.asarray(days.numpy()))
    for a, b in ((y, jy), (m, jm), (d, jd)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jy2, jm2, jd2 = dt._days_to_julian_ymd(days)
    assert torch.equal(dt._julian_ymd_to_days(jy2, jm2, jd2), days)


def test_rebase_gregorian_julian():
    def col(vals):
        return Column.from_pylist(vals, dtypes.TIMESTAMP_DAYS, device="cpu")

    c = col([d2e(1582, 10, 15), d2e(2020, 1, 1)])
    assert dt.rebase_gregorian_to_julian(c).to_pylist() == c.to_pylist()
    assert dt.rebase_gregorian_to_julian(
        col([d2e(1582, 10, 4)])).to_pylist() == [d2e(1582, 10, 4) + 10]
    assert dt.rebase_gregorian_to_julian(
        col([d2e(1, 1, 1)])).to_pylist() == [d2e(1, 1, 1) - 2]
    c3 = col([d2e(1, 1, 1), d2e(1000, 6, 15)])
    rt = dt.rebase_julian_to_gregorian(dt.rebase_gregorian_to_julian(c3))
    assert rt.to_pylist() == c3.to_pylist()
    with pytest.raises(ValueError):
        dt.rebase_gregorian_to_julian(
            Column.from_pylist([1], dtypes.INT64, device="cpu"))


def test_truncate_timestamps():
    base = datetime.datetime(2023, 7, 26, 14, 37, 52, 123456)
    us = int(base.replace(tzinfo=datetime.timezone.utc).timestamp() * 1e6)
    c = Column.from_pylist([us], dtypes.TIMESTAMP_MICROS, device="cpu")

    def trunc_to(comp):
        out = dt.truncate(c, comp).to_pylist()[0]
        return datetime.datetime.fromtimestamp(
            out / 1e6, datetime.timezone.utc).replace(tzinfo=None)

    assert trunc_to("YEAR") == datetime.datetime(2023, 1, 1)
    assert trunc_to("QUARTER") == datetime.datetime(2023, 7, 1)
    assert trunc_to("MONTH") == datetime.datetime(2023, 7, 1)
    assert trunc_to("WEEK") == datetime.datetime(2023, 7, 24)
    assert trunc_to("DAY") == datetime.datetime(2023, 7, 26)
    assert trunc_to("HOUR") == datetime.datetime(2023, 7, 26, 14)
    assert trunc_to("SECOND") == datetime.datetime(2023, 7, 26, 14, 37, 52)
    with pytest.raises(ValueError):
        dt.truncate(c, "EON")


def test_truncate_component_column():
    base = datetime.datetime(2023, 7, 26, 14, 37, 52, 123456)
    us = int(base.replace(tzinfo=datetime.timezone.utc).timestamp() * 1e6)
    c = Column.from_pylist([us, us, us], dtypes.TIMESTAMP_MICROS,
                           device="cpu")
    comps = Column.from_strings(["YEAR", "bogus", "DAY"], device="cpu")
    out = dt.truncate(c, comps).to_pylist()
    assert out[1] is None and out[0] != out[2]


@pytest.mark.parametrize("zone", ["America/Los_Angeles", "Asia/Shanghai"])
def test_timezone_roundtrip_vs_zoneinfo(zone):
    tz = zoneinfo.ZoneInfo(zone)
    samples = [datetime.datetime(2023, 1, 15, 12, 0, 0),
               datetime.datetime(2023, 7, 15, 12, 0, 0),
               datetime.datetime(1995, 3, 3, 3, 33, 0),
               datetime.datetime(2030, 11, 2, 8, 0, 0),
               datetime.datetime(1950, 6, 1, 23, 59, 59)]
    utc_us = [int(s.replace(tzinfo=datetime.timezone.utc).timestamp()
                  * 1e6) for s in samples]
    c = Column.from_pylist(utc_us, dtypes.TIMESTAMP_MICROS, device="cpu")
    local = dt.convert_utc_timestamp_to_timezone(c, zone)
    for s, lv in zip(samples, local.to_pylist()):
        expected = s.replace(tzinfo=datetime.timezone.utc).astimezone(
            tz).replace(tzinfo=None)
        got = datetime.datetime.fromtimestamp(
            lv / 1e6, datetime.timezone.utc).replace(tzinfo=None)
        assert got == expected, (zone, s)
    assert dt.convert_timestamp_to_utc(local, zone).to_pylist() == utc_us


def test_rebase_reference_vectors_days():
    inp = [-719162, -354285, None, -141714, -141438, -141437, None, None,
           -141432, -141427, -31463, -31453, -1, 0, 18335]
    to_julian = [-719164, -354280, None, -141704, -141428, -141427, None,
                 None, -141427, -141427, -31463, -31453, -1, 0, 18335]
    c = Column.from_pylist(inp, dtypes.TIMESTAMP_DAYS, device="cpu")
    assert dt.rebase_gregorian_to_julian(c).to_pylist() == to_julian
    back = [-719162, -354285, None, -141714, -141438, -141427, None,
            None, -141427, -141427, -31463, -31453, -1, 0, 18335]
    cj = Column.from_pylist(to_julian, dtypes.TIMESTAMP_DAYS, device="cpu")
    assert dt.rebase_julian_to_gregorian(cj).to_pylist() == back


def test_rebase_reference_vectors_micros():
    inp = [-62135593076345679, -30610213078876544, None,
           -12244061221876544, -12220243200000000, -12219639001448163,
           -12219292799000001, -45446999900, 1, None, 1584178381500000]
    to_julian = [-62135765876345679, -30609781078876544, None,
                 -12243197221876544, -12219379200000000,
                 -12219207001448163, -12219292799000001, -45446999900, 1,
                 None, 1584178381500000]
    c = Column.from_pylist(inp, dtypes.TIMESTAMP_MICROS, device="cpu")
    assert dt.rebase_gregorian_to_julian(c).to_pylist() == to_julian
    back = [-62135593076345679, -30610213078876544, None,
            -12244061221876544, -12220243200000000, -12219207001448163,
            -12219292799000001, -45446999900, 1, None, 1584178381500000]
    cj = Column.from_pylist(to_julian, dtypes.TIMESTAMP_MICROS,
                            device="cpu")
    assert dt.rebase_julian_to_gregorian(cj).to_pylist() == back


def test_truncate_reference_vectors():
    days = Column.from_pylist([-31463, -31453, None, 0, 18335],
                              dtypes.TIMESTAMP_DAYS, device="cpu")
    fmt = Column.from_strings(["YEAR", "MONTH", "WEEK", "QUARTER", "YY"],
                              device="cpu")
    assert dt.truncate(days, fmt).to_pylist() == \
        [-31776, -31472, None, 0, 18262]
    ts = Column.from_pylist(
        [-12219292799000001, -45446999900, 1, None, 1584178381500000],
        dtypes.TIMESTAMP_MICROS, device="cpu")
    fmt2 = Column.from_strings(["YEAR", "HOUR", "WEEK", "QUARTER",
                                "SECOND"], device="cpu")
    assert dt.truncate(ts, fmt2).to_pylist() == \
        [-12244089600000000, -46800000000, -259200000000, None,
         1584178381000000]


# ------------------------------------------- seeded parity, byte for byte


@pytest.mark.parametrize("op", ["g2j", "j2g"])
@pytest.mark.parametrize("kind", ["days", "micros"])
def test_rebase_parity(op, kind):
    values = seeded_days() if kind == "days" else seeded_micros()
    dtype = (dtypes.TIMESTAMP_DAYS if kind == "days"
             else dtypes.TIMESTAMP_MICROS)
    port, jax = pair(values, dtype, null_every=25)
    name = {"g2j": "rebase_gregorian_to_julian",
            "j2g": "rebase_julian_to_gregorian"}[op]
    same(getattr(dt, name)(port), getattr(jdt, name)(jax))


@pytest.mark.parametrize("zone", ["America/Los_Angeles", "Asia/Shanghai",
                                  "Australia/Sydney", "UTC"])
def test_timezone_parity(zone):
    port, jax = pair(seeded_micros(), dtypes.TIMESTAMP_MICROS, null_every=25)
    for name in ("convert_timestamp_to_utc",
                 "convert_utc_timestamp_to_timezone"):
        same(getattr(dt, name)(port, zone), getattr(jdt, name)(jax, zone))


@pytest.mark.parametrize("writer,reader", [
    ("Asia/Tokyo", "UTC"), ("America/Los_Angeles", "Asia/Shanghai")])
def test_zone_rules_orc_parity(writer, reader):
    port, jax = pair(seeded_micros(), dtypes.TIMESTAMP_MICROS, null_every=25)
    same(dt.convert_orc_timezones(port, writer, reader),
         jdt.convert_orc_timezones(jax, writer, reader))


@pytest.mark.parametrize("comp", COMPONENTS)
def test_truncate_parity(comp):
    for values, dtype in ((seeded_days(), dtypes.TIMESTAMP_DAYS),
                          (seeded_micros(), dtypes.TIMESTAMP_MICROS)):
        port, jax = pair(values, dtype, null_every=25)
        same(dt.truncate(port, comp.lower()), jdt.truncate(jax, comp))


@pytest.mark.parametrize("kind", ["days", "micros"])
def test_truncate_component_column_parity(kind):
    values = seeded_days() if kind == "days" else seeded_micros()
    dtype = (dtypes.TIMESTAMP_DAYS if kind == "days"
             else dtypes.TIMESTAMP_MICROS)
    port, jax = pair(values, dtype, null_every=25)
    rng = np.random.default_rng(3)
    vocab = COMPONENTS + ["year", "Month", "bogus", "", "ſecond", "mınute",
                          "DAY ", None]
    comps = [vocab[i] for i in rng.integers(0, len(vocab), port.length)]
    got = dt.truncate(port, Column.from_strings(comps, device="cpu"))
    same(got, jdt.truncate(jax, JColumn.from_strings(comps)))
    assert got.validity is not None


def test_truncate_empty_component_column():
    port, jax = pair(np.zeros(0, np.int64), dtypes.TIMESTAMP_MICROS)
    same(dt.truncate(port, Column.from_strings([], device="cpu")),
         jdt.truncate(jax, JColumn.from_strings([])))


# ----------------------------------------------------- test_orc_timezones

ORC_ZONES = ["Asia/Shanghai", "Antarctica/DumontDUrville", "Etc/GMT-12",
             "Asia/Tokyo", "UTC", "+05:30"]


def _oracle_offset_ms(zone_id, ms, info):
    if info.transitions is None:
        return info.raw_offset
    if ms < info.transitions[0] or ms >= info.transitions[-1]:
        return info.raw_offset
    tz = zoneinfo.ZoneInfo(zone_id)
    t = datetime.datetime.fromtimestamp(ms / 1000.0, tz)
    return int(tz.utcoffset(t).total_seconds() * 1000)


def _oracle_convert(us, wtz, rtz):
    wi = OT.get_orc_timezone_info(wtz)
    ri = OT.get_orc_timezone_info(rtz)
    ms = us // 1000
    wo = _oracle_offset_ms(wtz, ms, wi)
    ro = _oracle_offset_ms(rtz, ms, ri)
    ra = _oracle_offset_ms(rtz, ms + wo - ro, ri)
    return us + (wo - ra) * 1000


def _orc_instants():
    rng = random.Random(20260729)
    lo = int(datetime.datetime(1880, 1, 1,
                               tzinfo=datetime.timezone.utc).timestamp()
             * 1_000_000)
    hi = int(datetime.datetime(9999, 12, 31,
                               tzinfo=datetime.timezone.utc).timestamp()
             * 1_000_000)
    return np.array([rng.randrange(lo, hi) for _ in range(256)]
                    + [0, 1, -1, -1001, 1001, lo, hi], np.int64)


@pytest.mark.parametrize("wtz", ORC_ZONES)
def test_orc_timezone_pairs(wtz):
    us = _orc_instants()
    for rtz in ORC_ZONES:
        port, jax = pair(us, dtypes.TIMESTAMP_MICROS)
        got = OT.convert_orc_timezones(port, wtz, rtz)
        same(got, JOT.convert_orc_timezones(jax, wtz, rtz))
        exp = np.array([_oracle_convert(int(u), wtz, rtz) for u in us],
                       np.int64)
        assert np.array_equal(got.data.numpy(), exp), (wtz, rtz)


def test_orc_timezone_dst_rejected():
    col = Column(dtypes.TIMESTAMP_MICROS, 1,
                 data=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(NotImplementedError):
        OT.convert_orc_timezones(col, "America/Los_Angeles", "UTC")
    with pytest.raises(NotImplementedError):
        OT.convert_orc_timezones(col, "UTC", "Australia/Sydney")


def test_orc_timezone_invalid_id():
    with pytest.raises(ValueError):
        OT.get_orc_timezone_info("Invalid/Zone")
    with pytest.raises(ValueError):
        OT.get_orc_timezone_info("+25:00")


def test_orc_dst_detection():
    for zone in ZONES + ["+05:30", "Z", "GMT", "UTC+08:00"]:
        assert OT.has_daylight_saving_time(zone) == \
            JOT.has_daylight_saving_time(zone), zone
    assert OT.has_daylight_saving_time("America/Los_Angeles")
    assert OT.has_daylight_saving_time("Australia/Sydney")
    assert not OT.has_daylight_saving_time("Asia/Shanghai")
    assert not OT.has_daylight_saving_time("Asia/Tokyo")
    assert not OT.has_daylight_saving_time("UTC")
    assert not OT.has_daylight_saving_time("+05:30")
    assert not OT.has_daylight_saving_time("Etc/GMT-12")


def test_orc_fixed_offset_ids():
    info = OT.get_orc_timezone_info("+05:30")
    assert info.raw_offset == 19800000 and info.transitions is None
    assert OT.get_orc_timezone_info("Etc/GMT-12").raw_offset == \
        12 * 3600 * 1000
    sh = OT.get_orc_timezone_info("Asia/Shanghai")
    assert sh.raw_offset == 8 * 3600 * 1000
    assert sh.transitions is not None and (np.diff(sh.transitions) > 0).all()
    for zone in ORC_ZONES + ["UTC-0330", "GMT+1400", "Z"]:
        got, want = OT.get_orc_timezone_info(zone), \
            JOT.get_orc_timezone_info(zone)
        assert got.raw_offset == want.raw_offset, zone
        assert (got.transitions is None) == (want.transitions is None)
        if got.transitions is not None:
            assert np.array_equal(got.transitions, want.transitions)
            assert np.array_equal(got.offsets, want.offsets)
