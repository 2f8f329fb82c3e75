"""Datetime ops: timezone conversion, Julian<->Gregorian rebase, truncate
(reference timezones.cu/timezones.hpp, datetime_rebase.cu,
datetime_truncate.cu, GpuTimeZoneDB.java / DateTimeRebase.java /
DateTimeUtils.java).

All date math is elementwise civil-calendar arithmetic (Howard Hinnant
style days<->ymd formulas) on the column's tensors, with floor division
(`torch.div(..., rounding_mode="floor")`) so instants before 1970 land
on the right day; timezone offsets come from `torch.searchsorted` over
the tzdb transition table (utils/tzdb.py), uploaded once per (zone,
device), matching the reference's device binary search over its
ZoneRules-derived table.
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import copying, groupby
from spark_rapids_tpu_torch.utils import tzdb

_I64 = torch.int64
_I32 = torch.int32

MICROS_PER_SEC = 1_000_000
SECS_PER_DAY = 86400
_DAY_US = MICROS_PER_SEC * SECS_PER_DAY


def _fdiv(a, b):
    """Floor division (Python's //) for int64 tensors of either sign."""
    return torch.div(a, b, rounding_mode="floor")


# ----------------------------------------------------- civil date helpers

def civil_days_scalar(y: int, m: int, d: int) -> int:
    """Scalar Hinnant days-from-civil (shared by host-loop parsers)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    mp = (m - 3) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _days_to_ymd(z):
    """Proleptic-Gregorian days-since-epoch -> (y, m, d)."""
    z = z + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _ymd_to_days(y, m, d):
    y = torch.where(m <= 2, y - 1, y)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _julian_ymd_to_days(y, m, d):
    """Julian-calendar Y/M/D -> days since 1970-01-01 (via JDN)."""
    a = _fdiv(14 - m, 12)
    yy = y + 4800 - a
    mm = m + 12 * a - 3
    jdn = d + _fdiv(153 * mm + 2, 5) + 365 * yy + _fdiv(yy, 4) - 32083
    return jdn - 2440588


def _days_to_julian_ymd(z):
    """days since epoch -> Julian-calendar (y, m, d)."""
    jdn = z + 2440588
    c = jdn + 32082
    d_ = _fdiv(4 * c + 3, 1461)
    e = c - _fdiv(1461 * d_, 4)
    m_ = _fdiv(5 * e + 2, 153)
    day = e - _fdiv(153 * m_ + 2, 5) + 1
    month = m_ + 3 - 12 * _fdiv(m_, 10)
    year = d_ - 4800 + _fdiv(m_, 10)
    return year, month, day


# -------------------------------------------------------------- timezone

@functools.lru_cache(maxsize=64)
def _zone_table(zone_id: str, wall_time: bool, device: torch.device):
    """(bounds, offsets) int64 tensors of a zone on ``device``: the
    transition instants (UTC, or local wall seconds when ``wall_time``)
    and the UTC offset in effect from each."""
    trans, offs = tzdb.get_transitions(zone_id)
    if wall_time:
        offs_before = np.concatenate([offs[:1], offs[:-1]])
        bounds = trans + offs_before
    else:
        bounds = trans
    return (torch.from_numpy(np.ascontiguousarray(bounds)).to(device),
            torch.from_numpy(np.ascontiguousarray(offs)).to(device))


def _offsets_at(instants_sec: torch.Tensor, zone_id: str,
                wall_time: bool) -> torch.Tensor:
    """UTC offset (seconds) at each instant.  wall_time=True treats the
    input as local wall seconds.  Wall boundaries use the offset BEFORE
    each transition (GpuTimeZoneDB.java:336-339 localInstant), so
    fall-back overlaps resolve to the earlier offset and spring-forward
    gaps to the later one — java.time ZoneRules semantics."""
    bounds, offs = _zone_table(zone_id, wall_time, instants_sec.device)
    idx = torch.searchsorted(bounds, instants_sec.contiguous(),
                             right=True) - 1
    return offs[idx.clamp_(0, offs.shape[0] - 1)]


def convert_timestamp_to_utc(col: Column, zone_id: str) -> Column:
    """Wall-clock micros in `zone_id` -> UTC micros
    (timezones.hpp:2 convert_timestamp_to_utc)."""
    assert col.dtype.kind == Kind.TIMESTAMP_MICROS
    micros = col.data.to(_I64)
    off = _offsets_at(_fdiv(micros, MICROS_PER_SEC), zone_id,
                      wall_time=True)
    return Column(col.dtype, col.length,
                  data=micros - off * MICROS_PER_SEC,
                  validity=col.validity)


def convert_utc_timestamp_to_timezone(col: Column, zone_id: str) -> Column:
    """UTC micros -> wall-clock micros in `zone_id`
    (timezones.hpp convert_utc_timestamp_to_timezone)."""
    assert col.dtype.kind == Kind.TIMESTAMP_MICROS
    micros = col.data.to(_I64)
    off = _offsets_at(_fdiv(micros, MICROS_PER_SEC), zone_id,
                      wall_time=False)
    return Column(col.dtype, col.length,
                  data=micros + off * MICROS_PER_SEC,
                  validity=col.validity)


# ---------------------------------------------------------------- rebase

_GREG_START_DAYS = -141427  # 1582-10-15


def _split_micros(col: Column):
    """(days, microseconds into the day) of a TIMESTAMP_MICROS column."""
    micros = col.data.to(_I64)
    days = _fdiv(micros, _DAY_US)
    return days, micros - days * _DAY_US


def rebase_gregorian_to_julian(col: Column) -> Column:
    """Proleptic-Gregorian -> hybrid Julian/Gregorian calendar
    (datetime_rebase.cu; Spark rebaseGregorianToJulianDays/Micros).
    Dates on/after 1582-10-15 are unchanged; earlier dates keep their
    Y/M/D field values reinterpreted in the Julian calendar."""
    if col.dtype.kind == Kind.TIMESTAMP_DAYS:
        out = _rebase_days_g2j(col.data.to(_I64))
        return Column(col.dtype, col.length, data=out.to(_I32),
                      validity=col.validity)
    if col.dtype.kind == Kind.TIMESTAMP_MICROS:
        days, tod = _split_micros(col)
        return Column(col.dtype, col.length,
                      data=_rebase_days_g2j(days) * _DAY_US + tod,
                      validity=col.validity)
    raise ValueError("date or timestamp column required")


def _rebase_days_g2j(days: torch.Tensor) -> torch.Tensor:
    """Shared day computation for both rebase branches.  Dates INSIDE
    the cutover gap (1582-10-05..14) do not exist in the hybrid
    calendar: Spark clamps them to the Gregorian start day
    (datetime_rebase.cu:86-89); earlier dates reinterpret their Y/M/D
    in the Julian calendar; later dates are unchanged."""
    jd = _julian_ymd_to_days(*_days_to_ymd(days))
    in_gap = (days >= _GREG_START_DAYS - 10) & (days < _GREG_START_DAYS)
    return torch.where(days >= _GREG_START_DAYS, days,
                       torch.where(in_gap, _GREG_START_DAYS, jd))


def _rebase_days_j2g(days: torch.Tensor) -> torch.Tensor:
    gd = _ymd_to_days(*_days_to_julian_ymd(days))
    return torch.where(days >= _GREG_START_DAYS, days, gd)


def rebase_julian_to_gregorian(col: Column) -> Column:
    """Inverse rebase (datetime_rebase.cu)."""
    if col.dtype.kind == Kind.TIMESTAMP_DAYS:
        out = _rebase_days_j2g(col.data.to(_I64))
        return Column(col.dtype, col.length, data=out.to(_I32),
                      validity=col.validity)
    if col.dtype.kind == Kind.TIMESTAMP_MICROS:
        days, tod = _split_micros(col)
        return Column(col.dtype, col.length,
                      data=_rebase_days_j2g(days) * _DAY_US + tod,
                      validity=col.validity)
    raise ValueError("date or timestamp column required")


# -------------------------------------------------------------- truncate

_COMPONENTS = {
    "YEAR": "year", "YYYY": "year", "YY": "year",
    "QUARTER": "quarter",
    "MONTH": "month", "MON": "month", "MM": "month",
    "WEEK": "week",
    "DAY": "day", "DD": "day",
    "HOUR": "hour",
    "MINUTE": "minute",
    "SECOND": "second",
    "MILLISECOND": "millisecond",
    "MICROSECOND": "microsecond",
}

_UNIT_US = {"day": _DAY_US, "hour": MICROS_PER_SEC * 3600,
            "minute": MICROS_PER_SEC * 60, "second": MICROS_PER_SEC,
            "millisecond": 1000, "microsecond": 1}


def truncate(col: Column, component: Union[str, Column]) -> Column:
    """Spark date_trunc / trunc (datetime_truncate.cu, DateTimeUtils.java:
    truncate).  Invalid components null the row; scalar or per-row
    component column."""
    if isinstance(component, Column):
        return _truncate_by_column(col, component)
    comp = _COMPONENTS.get(component.upper())
    if comp is None:
        raise ValueError(f"unsupported truncation component {component}")
    is_date = col.dtype.kind == Kind.TIMESTAMP_DAYS
    if is_date:
        days = col.data.to(_I64)
        tod = torch.zeros_like(days)
    else:
        days, tod = _split_micros(col)

    if comp in ("year", "quarter", "month", "week"):
        if comp == "week":   # Monday; 1970-01-01 is a Thursday
            out_days = days - torch.remainder(days + 3, 7)
        else:
            y, m, _d = _days_to_ymd(days)
            one = torch.ones_like(m)
            if comp == "year":
                out_days = _ymd_to_days(y, one, one)
            elif comp == "quarter":
                out_days = _ymd_to_days(y, _fdiv(m - 1, 3) * 3 + 1, one)
            else:
                out_days = _ymd_to_days(y, m, one)
        out_tod = torch.zeros_like(tod)
    else:
        unit = _UNIT_US[comp]
        out_days = days
        out_tod = tod if is_date else _fdiv(tod, unit) * unit

    if is_date:
        return Column(col.dtype, col.length, data=out_days.to(_I32),
                      validity=col.validity)
    return Column(col.dtype, col.length, data=out_days * _DAY_US + out_tod,
                  validity=col.validity)


def _truncate_by_column(col: Column, component: Column) -> Column:
    """Per-row components: one elementwise pass per distinct component
    named; rows whose component is null or unknown become null.  The
    component strings are grouped on their device (ops/groupby), and
    only each group's first row is read on the host."""
    device = col.device
    result = torch.zeros(col.length, dtype=_I64, device=device)
    mask = torch.zeros(col.length, dtype=torch.uint8, device=device)
    if col.length == 0:
        return Column(col.dtype, 0, data=result.to(col.dtype.torch_dtype),
                      validity=mask)
    ids, first, _n = groupby._group_ids(Table([component]))
    names = [None if v is None else str(v).upper()
             for v in copying.gather(component, first).to_pylist()]
    names = [n if n in _COMPONENTS else None for n in names]
    kinds = sorted(set(n for n in names if n))
    which = torch.tensor([kinds.index(n) if n else -1 for n in names],
                         dtype=_I64, device=ids.device)[ids.to(_I64)]
    base_valid = col.valid_mask()
    for k, comp in enumerate(kinds):
        sel = which == k
        result = torch.where(sel, truncate(col, comp).data.to(_I64), result)
        mask = torch.where(sel & base_valid, 1, mask).to(torch.uint8)
    return Column(col.dtype, col.length,
                  data=result.to(col.dtype.torch_dtype), validity=mask)


def convert_orc_timezones(col: Column, writer_zone: str,
                          reader_zone: str) -> Column:
    """ORC timestamp rectification (timezones.hpp:24-31
    convert_orc_timezones, OrcTimezoneInfo.java): ORC stores wall-clock
    values in the writer's zone; shift each instant by the difference of
    the writer/reader offsets in effect at that instant so the reader's
    interpretation matches the writer's wall clock.

    This one converts DST zones through the tzdb tables.  The reader's
    fix-up uses :func:`orc_timezones.convert_orc_timezones`
    (java.util.TimeZone semantics, DST zones refused, as spark-rapids
    does)."""
    assert col.dtype.kind == Kind.TIMESTAMP_MICROS
    micros = col.data.to(_I64)
    secs = _fdiv(micros, MICROS_PER_SEC)
    w_off = _offsets_at(secs, writer_zone, wall_time=False)
    r_off = _offsets_at(secs, reader_zone, wall_time=False)
    adjusted = micros + (w_off - r_off) * MICROS_PER_SEC
    # second reader lookup AT the adjusted instant: shifts landing across
    # a reader DST transition must use the post-shift offset
    # (timezones.cu convert_timestamp_between_timezones :340-348)
    r_off2 = _offsets_at(_fdiv(adjusted, MICROS_PER_SEC), reader_zone,
                         wall_time=False)
    return Column(col.dtype, col.length,
                  data=micros + (w_off - r_off2) * MICROS_PER_SEC,
                  validity=col.validity)
