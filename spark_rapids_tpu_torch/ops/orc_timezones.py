"""ORC writer->reader timezone rectification.

Reference: timezones.hpp:24-31 / timezones.cu convert_orc_timezones
(device port of org.apache.orc.impl.SerializationUtils
.convertBetweenTimezones), with the timezone tables built host-side the
way OrcTimezoneInfo.java builds them from java.util.TimeZone.

java.util.TimeZone (sun.util.calendar.ZoneInfo) lookup semantics — which
differ from java.time.ZoneRules and which the device table reproduces
(get_transition_index, timezones.cu:256-289):

  * BEFORE the first historical transition: the zone's RAW offset (not
    the pre-1900 LMT offset ZoneRules would report);
  * between transitions: the offset set by the latest transition <= t;
  * AFTER the last transition: the RAW offset again (recurring DST
    rules would apply here, but DST zones are rejected up front exactly
    like GpuTimeZoneDB.convertOrcTimezones:582-586).

The conversion itself is three offset lookups per timestamp
(SerializationUtils.convertBetweenTimezones), floor-dividing the
microsecond timestamp to milliseconds so negative sub-millisecond
values don't round toward zero (timezones.cu:322-329).  All lookups are
`torch.searchsorted` on the column's device, over the zone's table
uploaded once per device.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.utils import tzdb

# ORC supports timestamps from year 0001 on (OrcTimezoneInfo.java:67)
MIN_SUPPORTED_ORC_UTC_MILLIS = -62135596800000  # 0001-01-01T00:00:00Z

_FIXED_RE = re.compile(r"^([+-])(\d{2}):?(\d{2})(?::?(\d{2}))?$")


class OrcTimezoneInfo:
    """rawOffset (ms) + historical transition table (ms), mirroring
    OrcTimezoneInfo.java:46-59.  transitions is None for fixed zones.
    ``on_device`` holds the table's tensors per device."""

    __slots__ = ("raw_offset", "transitions", "offsets", "on_device")

    def __init__(self, raw_offset: int,
                 transitions: Optional[np.ndarray],
                 offsets: Optional[np.ndarray]):
        self.raw_offset = raw_offset
        self.transitions = transitions
        self.offsets = offsets
        self.on_device: Dict[torch.device, Tuple[torch.Tensor,
                                                 torch.Tensor]] = {}

    def table(self, device: torch.device):
        """(transitions, offsets) int64 tensors on ``device``."""
        got = self.on_device.get(device)
        if got is None:
            got = (torch.from_numpy(self.transitions).to(device),
                   torch.from_numpy(self.offsets).to(device))
            self.on_device[device] = got
        return got


_info_cache: Dict[str, OrcTimezoneInfo] = {}


def _parse_fixed_offset(zone_id: str) -> Optional[int]:
    """Offset millis for '+05:30'-style ids (valid ZoneIds that
    java.util.TimeZone would silently map to GMT; the reference derives
    the offset from ZoneRules instead, OrcTimezoneInfo.java:131-139)."""
    if zone_id == "Z":          # java ZoneId accepts bare 'Z' for UTC
        return 0
    zid = zone_id
    if zid.upper().startswith(("UTC+", "UTC-", "GMT+", "GMT-")):
        zid = zid[3:]
    m = _FIXED_RE.match(zid)
    if not m:
        return None
    sign = 1 if m.group(1) == "+" else -1
    h, mn = int(m.group(2)), int(m.group(3))
    s = int(m.group(4) or 0)
    if h > 18 or mn > 59 or s > 59:
        raise ValueError(f"invalid offset zone id {zone_id!r}")
    return sign * ((h * 3600 + mn * 60 + s) * 1000)


def _split_posix_std(footer: str) -> Tuple[Optional[str], str]:
    """Split a POSIX TZ footer into (std offset spec or None, rest after
    the offset).  Shared scanner for DST detection and raw-offset
    extraction so the two can't drift apart."""
    if not footer:
        return None, ""
    i = 0
    if footer.startswith("<"):        # <quoted> std designation
        close = footer.find(">")
        i = close + 1 if close >= 0 else len(footer)
    while i < len(footer) and footer[i] not in "+-0123456789":
        i += 1
    j = i
    if j < len(footer) and footer[j] in "+-":
        j += 1
    while j < len(footer) and (footer[j].isdigit() or footer[j] == ":"):
        j += 1
    spec = footer[i:j]
    if not spec or not any(ch.isdigit() for ch in spec):
        return None, footer[j:]
    return spec, footer[j:]


def _footer_has_dst(footer: str) -> bool:
    """POSIX TZ footer contains a DST designation (e.g. 'PST8PDT,M3...')?
    The std name + offset is followed by a dst name when the zone keeps
    observing DST — java.util.TimeZone.useDaylightTime equivalent."""
    _, rest = _split_posix_std(footer)
    return bool(rest.split(",")[0])


def has_daylight_saving_time(zone_id: str) -> bool:
    """GpuTimeZoneDB.isDST analog: the zone observes DST going forward
    (recurring rule in the TZif footer).  TZif v1 files carry no footer;
    for those, recent DST flags in the transition table are the signal —
    without this, a v1-only tzdata would silently convert DST zones with
    raw-offset semantics (data corruption) instead of raising."""
    if _parse_fixed_offset(zone_id) is not None or zone_id in (
            "UTC", "GMT", "Z"):
        return False
    rec = tzdb.get_zone_info(zone_id)
    if _footer_has_dst(rec.footer):
        return True
    if not rec.footer and len(rec.trans) > 1:
        horizon = int(rec.trans[-1]) - 15 * 365 * 86400
        recent = rec.trans >= horizon
        if bool((np.asarray(rec.isdst)[recent] != 0).any()):
            return True
    return False


def _raw_offset_ms(rec: "tzdb.ZoneInfoRecord") -> int:
    """java.util.TimeZone.getRawOffset: the current STANDARD offset.
    From the footer's std offset when present (authoritative for the
    recurring era), else the last non-DST offset in the table."""
    spec, _ = _split_posix_std(rec.footer)
    if spec is not None:
        neg = spec.startswith("-")
        parts = [int(x) for x in spec.lstrip("+-").split(":")]
        while len(parts) < 3:
            parts.append(0)
        secs = parts[0] * 3600 + parts[1] * 60 + parts[2]
        # POSIX TZ offsets are west-positive: UTC offset = -spec
        return (secs if neg else -secs) * 1000
    std = [(int(t), int(o)) for t, o, d in
           zip(rec.trans, rec.offs, rec.isdst) if not d]
    if std:
        return std[-1][1] * 1000
    return int(rec.offs[-1]) * 1000 if len(rec.offs) else 0


def get_orc_timezone_info(zone_id: str) -> OrcTimezoneInfo:
    """OrcTimezoneInfo.get analog (cached); ValueError on unknown ids
    (no silent GMT fallback — OrcTimezoneInfo.java:107-116)."""
    if zone_id in _info_cache:
        return _info_cache[zone_id]
    fixed = _parse_fixed_offset(zone_id)
    if fixed is not None:
        info = OrcTimezoneInfo(fixed, None, None)
    else:
        rec = tzdb.get_zone_info(zone_id)   # raises ValueError if unknown
        trans_s = rec.trans[1:]             # drop the -inf sentinel row
        offs_s = rec.offs[1:]
        trans_ms = trans_s * 1000
        offs_ms = offs_s * 1000
        keep = trans_ms >= MIN_SUPPORTED_ORC_UTC_MILLIS
        trans_ms, offs_ms = trans_ms[keep], offs_ms[keep]
        raw = _raw_offset_ms(rec)
        if trans_ms.size == 0:
            info = OrcTimezoneInfo(raw, None, None)
        else:
            info = OrcTimezoneInfo(raw, trans_ms.astype(np.int64),
                                   offs_ms.astype(np.int64))
    _info_cache[zone_id] = info
    return info


def _offset_lookup(t_ms: torch.Tensor, info: OrcTimezoneInfo
                   ) -> torch.Tensor:
    """Elementwise get_transition_index (timezones.cu:256-289): offset
    in effect at each t_ms under java.util.TimeZone semantics."""
    raw = info.raw_offset
    if info.transitions is None:
        return torch.full(t_ms.shape, raw, dtype=torch.int64,
                          device=t_ms.device)
    trans, offs = info.table(t_ms.device)
    n = trans.shape[0]
    idx = torch.searchsorted(trans, t_ms.contiguous(), right=True)
    at = offs[(idx - 1).clamp_(0, n - 1)]
    out = torch.where(idx == 0, raw, at)          # before the table
    return torch.where(idx == n, raw, out)        # after the table


def convert_orc_timezones(col: Column, writer_tz: str,
                          reader_tz: str) -> Column:
    """Rectify ORC timestamps written under writer_tz for a reader in
    reader_tz (GpuTimeZoneDB.convertOrcTimezones:578-604 →
    timezones.cu convert_timestamp_between_timezones).

    Raises NotImplementedError for DST zones, matching the reference's
    UnsupportedOperationException guard (GpuTimeZoneDB.java:582-586)."""
    assert col.dtype.kind == Kind.TIMESTAMP_MICROS
    if has_daylight_saving_time(writer_tz) or \
            has_daylight_saving_time(reader_tz):
        raise NotImplementedError(
            "Daylight Saving Time is not supported now.")
    w = get_orc_timezone_info(writer_tz)
    r = get_orc_timezone_info(reader_tz)

    us = col.data.to(torch.int64)
    ms = torch.div(us, 1000, rounding_mode="floor")
    w_off = _offset_lookup(ms, w)
    r_off = _offset_lookup(ms, r)
    adjusted_ms = ms + (w_off - r_off)
    r_adj = _offset_lookup(adjusted_ms, r)
    final = us + (w_off - r_adj) * 1000
    return Column(col.dtype, col.length, data=final,
                  validity=col.validity)
