"""Timezone transition database from the system tzdata (TZif files).

The reference builds its device timezone table from JVM ZoneRules
(GpuTimeZoneDB.loadData:262-398: LIST<STRUCT<utcInstant, localInstant,
offset>>).  Here the equivalent table is parsed directly from
/usr/share/zoneinfo TZif v2+ binaries (RFC 8536): per zone, sorted arrays
of (transition instant UTC seconds, UTC offset seconds after transition),
cached per process.  Kernels binary-search these arrays, exactly like the
reference's device binary search (timezones.cu).
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, Tuple

import numpy as np

TZDIR = os.environ.get("TZDIR", "/usr/share/zoneinfo")

_info_cache: Dict[str, "ZoneInfoRecord"] = {}
_lock = threading.Lock()


class ZoneInfoRecord:
    """Full TZif parse: transitions (with -inf sentinel row), UTC offsets,
    per-row DST flags, and the v2+ POSIX TZ footer string."""

    __slots__ = ("trans", "offs", "isdst", "footer")

    def __init__(self, trans, offs, isdst, footer):
        self.trans = trans
        self.offs = offs
        self.isdst = isdst
        self.footer = footer


def _parse_tzif(path: str) -> ZoneInfoRecord:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"TZif":
        raise ValueError(f"not a TZif file: {path}")
    version = data[4:5]

    def header(off):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = struct.unpack(">6i", data[off + 20: off + 44])
        return isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt

    off = 0
    isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = header(0)
    v1_size = (44 + timecnt * 5 + typecnt * 6 + charcnt + leapcnt * 8
               + isstdcnt + isutcnt)
    footer = ""
    if version >= b"2":
        # skip v1 block; parse the 64-bit second block
        off = v1_size
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = header(off)
        p = off + 44
        times = np.frombuffer(data, ">i8", timecnt, p)
        p += timecnt * 8
        idx = np.frombuffer(data, np.uint8, timecnt, p)
        p += timecnt
        ttinfos = [struct.unpack(">ibB", data[p + i * 6: p + i * 6 + 6])
                   for i in range(typecnt)]
        p += typecnt * 6 + charcnt + leapcnt * 12 + isstdcnt + isutcnt
        # RFC 8536 §3.3: NL, TZ string, NL
        tail = data[p:]
        if tail[:1] == b"\n":
            end = tail.find(b"\n", 1)
            if end > 0:
                footer = tail[1:end].decode("ascii", "replace")
    else:
        p = 44
        times = np.frombuffer(data, ">i4", timecnt, p).astype(np.int64)
        p += timecnt * 4
        idx = np.frombuffer(data, np.uint8, timecnt, p)
        p += timecnt
        ttinfos = [struct.unpack(">ibB", data[p + i * 6: p + i * 6 + 6])
                   for i in range(typecnt)]
    offsets = np.array([ttinfos[i][0] for i in idx], np.int64) if timecnt \
        else np.zeros(0, np.int64)
    dstflags = np.array([ttinfos[i][1] for i in idx], np.int64) if timecnt \
        else np.zeros(0, np.int64)
    # offset before the first transition: the first non-DST type, falling
    # back to type 0 (RFC 8536 §3.2 guidance)
    base = 0
    if ttinfos:
        base = ttinfos[0][0]
        for utoff, isdst, _ in ttinfos:
            if not isdst:
                base = utoff
                break
    trans = np.concatenate([np.array([-(2**62)], np.int64),
                            times.astype(np.int64)])
    offs = np.concatenate([np.array([base], np.int64), offsets])
    isdst = np.concatenate([np.array([0], np.int64), dstflags])
    return ZoneInfoRecord(trans, offs, isdst, footer)


def _zone_path(zone_id: str) -> str:
    path = os.path.realpath(os.path.join(TZDIR, zone_id))
    tzroot = os.path.realpath(TZDIR)
    if not path.startswith(tzroot + os.sep):
        raise ValueError(f"invalid zone id {zone_id!r}")
    if not os.path.exists(path):
        raise ValueError(f"unknown timezone {zone_id!r}")
    return path


def get_zone_info(zone_id: str) -> ZoneInfoRecord:
    """Full zone record incl. DST flags and POSIX footer (cached)."""
    with _lock:
        if zone_id in _info_cache:
            return _info_cache[zone_id]
    rec = _parse_tzif(_zone_path(zone_id))
    with _lock:
        _info_cache[zone_id] = rec
    return rec


def get_transitions(zone_id: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transition UTC seconds (ascending, starts with -inf sentinel),
    UTC offset seconds in effect from that instant)."""
    rec = get_zone_info(zone_id)
    return rec.trans, rec.offs
