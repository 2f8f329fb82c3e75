"""Windowed time-series telemetry over the metrics registry.

Every registry instrument is cumulative-since-boot — the right shape
for Prometheus scrapes and post-mortem dumps, but useless for "what
is tenant A's p99 *right now*".  The ``TimeseriesSampler`` closes the
gap without touching the hot path: a periodic ``tick()`` (driven by
the existing ``utils.telemetry.Monitor`` thread in production, by
explicit calls with an injected clock in tests) snapshots the
registry and appends ONE bounded ring entry holding the *delta*
since the previous tick:

  * counters    -> per-window increments (rate = delta / dur_s);
  * gauges      -> last value at tick time;
  * histograms  -> per-window ``bucket_counts``/sum/count deltas, so
                   percentiles estimated from a window are *recent*,
                   not diluted by everything since boot.

Conservation invariant (the fleet-reconciliation gate): the first
tick's delta is the full since-boot total, so the sum of every
window's counter deltas equals the registry's final cumulative value
exactly — rank 0's merged fleet timeseries can be checked against
each rank's own ``metrics_rank{r}.json`` dump to the byte.

``FleetTimeseries`` is the rank-0 side: workers publish their ring
as JSON snapshots (CTRL frames over the shuffle sockets, or dump-dir
files for the launcher tier) and the merger folds them keyed by
(epoch, rank, window seq) — snapshots from a stale fleet epoch are
fenced by the fleet membership machinery, re-delivered windows are
deduped by sequence number.

Disabled cost: ``maybe_tick``/``tick`` return after ONE attribute
read when ``enabled`` is False — same switch discipline as every
other observability hook (gated by scripts/slo_smoke.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


def histogram_quantile(buckets: List[float], bucket_counts: List[int],
                       q: float) -> float:
    """Estimate the q-quantile (0..1) from PER-BUCKET (non-cumulative)
    counts — the registry snapshot's and the window record's shared
    ``bucket_counts`` format.  Linear interpolation within the target
    bucket; the +Inf bucket clamps to the largest finite bound (an
    underestimate by construction).  Kept semantically identical to
    ``tools.metrics_report.histogram_quantile`` — tools must not be
    imported from here (they import us)."""
    total = sum(bucket_counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, n in enumerate(bucket_counts):
        if cum + n >= target and n > 0:
            if i >= len(buckets):          # +Inf bucket
                return float(buckets[-1]) if buckets else 0.0
            lo = float(buckets[i - 1]) if i > 0 else 0.0
            hi = float(buckets[i])
            return lo + (hi - lo) * (target - cum) / n
        cum += n
    return float(buckets[-1]) if buckets else 0.0


def _series_key(labels) -> str:
    """Stable flat key for a labelled series inside a window record
    (JSON dict keys must be strings; label values never contain the
    separator — the registry only ever sees identifier-ish values and
    the ``__other__`` overflow key)."""
    return "|".join(str(v) for v in labels)


class TimeseriesSampler:
    """Bounded ring of per-window registry delta snapshots.

    ``tick()`` is cheap but not free (a full registry snapshot), so it
    runs at window granularity off the Monitor thread — never inline
    with query work.  All public methods are safe to call concurrently
    with ticks (one lock around ring mutation/reads; the registry has
    its own per-series locks)."""

    def __init__(self, registry, *, window_s: float = 5.0,
                 capacity: int = 120,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time,
                 families: Optional[Tuple[str, ...]] = None,
                 on_tick: Optional[Callable[[int], None]] = None):
        self.enabled = False
        self.registry = registry
        self.window_s = float(window_s)
        self.capacity = int(capacity)
        self.families = tuple(families) if families else None
        self.on_tick = on_tick
        self._clock = clock
        self._wall_clock = wall_clock
        self._lock = threading.Lock()
        self._windows: deque = deque(maxlen=self.capacity)
        self._prev: Dict[str, dict] = {}
        self._seq = 0
        self._last_tick: Optional[float] = None

    # ------------------------------------------------------- sampling

    def _take(self) -> Dict[str, dict]:
        """Selective registry fold: with a ``families`` watch list only
        those families are snapshotted (``family_snapshot`` holds each
        family's series locks one at a time), else the whole registry."""
        if self.families is None:
            return self.registry.snapshot()
        out: Dict[str, dict] = {}
        for name in self.families:
            fam = self.registry.family_snapshot(name)
            if fam is not None:
                out[name] = fam
        return out

    @staticmethod
    def _delta_family(fam: dict, prev: Optional[dict]) -> Optional[dict]:
        """One family's window contribution, or None when nothing moved.
        Counter/histogram series that did not change this window are
        dropped from the record (they contribute zero to every sum);
        gauges always record their last value."""
        kind = fam.get("kind")
        prev_series: Dict[str, dict] = {}
        if prev is not None:
            for s in prev.get("series", []):
                prev_series[_series_key(s["labels"])] = s
        if kind == "gauge":
            vals = {_series_key(s["labels"]): s["value"]
                    for s in fam.get("series", [])}
            return {"kind": kind, "values": vals} if vals else None
        if kind == "counter":
            vals = {}
            for s in fam.get("series", []):
                key = _series_key(s["labels"])
                p = prev_series.get(key)
                d = s["value"] - (p["value"] if p else 0)
                if d:
                    vals[key] = d
            return {"kind": kind, "values": vals} if vals else None
        if kind == "histogram":
            series = {}
            for s in fam.get("series", []):
                key = _series_key(s["labels"])
                p = prev_series.get(key)
                if p is None:
                    bc = list(s["bucket_counts"])
                    dsum, dcount = s["sum"], s["count"]
                else:
                    bc = [a - b for a, b in
                          zip(s["bucket_counts"], p["bucket_counts"])]
                    dsum = s["sum"] - p["sum"]
                    dcount = s["count"] - p["count"]
                if dcount or dsum or any(bc):
                    series[key] = {"bucket_counts": bc, "sum": dsum,
                                   "count": dcount}
            if not series:
                return None
            return {"kind": kind, "buckets": list(fam.get("buckets", [])),
                    "series": series}
        return None

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """Append one window: the registry delta since the previous
        tick.  Returns the window record (also retained in the ring),
        or None when the sampler is disabled."""
        if not self.enabled:
            return None
        t0 = time.perf_counter_ns()
        return self._tick_from(self._take(), now, t0)

    def tick_with_registry(self, now: Optional[float] = None
                           ) -> Optional[Tuple[dict, dict]]:
        """Append one window and return it with the whole-registry fold
        it was cut from (None when disabled).  The ring's summed
        counter deltas equal that fold exactly, whatever other threads
        count meanwhile; a second ``snapshot()`` after ``tick()`` would
        also hold what a peer's frame counted between the two."""
        if not self.enabled:
            return None
        t0 = time.perf_counter_ns()
        full = self.registry.snapshot()
        snap = full if self.families is None else {
            n: full[n] for n in self.families if n in full}
        return self._tick_from(snap, now, t0), full

    def _tick_from(self, snap: Dict[str, dict], now: Optional[float],
                   t0: int) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            last = self._last_tick
            dur = (now - last) if last is not None else self.window_s
            window = {
                "window": self._seq,
                "t_unix_ms": int(self._wall_clock() * 1000),
                "dur_s": max(float(dur), 1e-9),
                "counters": {}, "gauges": {}, "histograms": {},
            }
            for name, fam in snap.items():
                d = self._delta_family(fam, self._prev.get(name))
                if d is None:
                    continue
                kind = d.pop("kind")
                if kind == "counter":
                    window["counters"][name] = d["values"]
                elif kind == "gauge":
                    window["gauges"][name] = d["values"]
                else:
                    window["histograms"][name] = d
            self._prev = snap
            self._windows.append(window)
            self._seq += 1
            self._last_tick = now
        if self.on_tick is not None:
            self.on_tick(time.perf_counter_ns() - t0)
        return window

    def maybe_tick(self, now: Optional[float] = None) -> Optional[dict]:
        """Tick only when a full window has elapsed — the Monitor
        thread calls this every sample period regardless of the
        configured window.  One attribute read when disabled."""
        if not self.enabled:
            return None
        now = self._clock() if now is None else now
        if self._last_tick is not None and \
                now - self._last_tick < self.window_s:
            return None
        return self.tick(now)

    # --------------------------------------------------------- queries

    def windows(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            ws = list(self._windows)
        return ws if n is None else ws[-n:]

    def last_tick_age_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds since the last tick, None before the first one —
        the liveness signal behind ``srt_monitor_last_sample_age_s``."""
        if self._last_tick is None:
            return None
        now = self._clock() if now is None else now
        return max(0.0, now - self._last_tick)

    def recent_histogram(self, family: str, key: Optional[str] = None,
                         n: Optional[int] = None):
        """Fold the last ``n`` windows' histogram deltas for one family
        (one series ``key``, or all series summed when None).  Returns
        ``(buckets, bucket_counts, sum, count)`` — feed straight into
        ``histogram_quantile`` for a *recent* percentile — or None when
        the family never appeared."""
        buckets: Optional[List[float]] = None
        counts: Optional[List[float]] = None
        total_sum = 0.0
        total_count = 0
        for w in self.windows(n):
            fam = w["histograms"].get(family)
            if fam is None:
                continue
            if buckets is None:
                buckets = fam["buckets"]
                counts = [0.0] * (len(buckets) + 1)
            for skey, s in fam["series"].items():
                if key is not None and skey != key:
                    continue
                for i, c in enumerate(s["bucket_counts"]):
                    counts[i] += c
                total_sum += s["sum"]
                total_count += s["count"]
        if buckets is None:
            return None
        return buckets, counts, total_sum, total_count

    def rate(self, family: str, key: Optional[str] = None,
             n: Optional[int] = None) -> float:
        """Recent per-second rate of a counter family (one series or
        all series summed) over the last ``n`` windows."""
        total = 0.0
        dur = 0.0
        for w in self.windows(n):
            dur += w["dur_s"]
            vals = w["counters"].get(family)
            if not vals:
                continue
            if key is None:
                total += sum(vals.values())
            else:
                total += vals.get(key, 0)
        return total / dur if dur > 0 else 0.0

    def snapshot(self) -> dict:
        """JSON-able ring dump — the unit FleetTimeseries merges and
        ``timeseries_rank{r}.json`` persists."""
        return {"window_s": self.window_s, "capacity": self.capacity,
                "windows": self.windows()}

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()
            self._prev = {}
            self._seq = 0
            self._last_tick = None


def sum_counter_windows(windows: List[dict], family: str
                        ) -> Dict[str, float]:
    """Fold a window list's counter deltas for one family into
    per-series totals — the reconciliation primitive: over a rank's
    FULL ring this equals the rank's cumulative registry value."""
    out: Dict[str, float] = {}
    for w in windows:
        for key, d in (w.get("counters", {}).get(family) or {}).items():
            out[key] = out.get(key, 0) + d
    return out


class FleetTimeseries:
    """Rank 0's merged view of every worker's windowed snapshots.

    ``offer()`` is the single entry point for both transports (CTRL
    frames and dump-dir polling) and is idempotent: re-delivered
    windows are deduped per (rank, window seq), and a snapshot carrying
    a fleet epoch older than the newest one seen is fenced outright —
    a zombie pre-rebalance worker cannot smear its stale tenant stats
    into the live view (the same staleness rule the fleet data frames
    obey)."""

    def __init__(self, capacity_per_rank: int = 240):
        self.capacity_per_rank = int(capacity_per_rank)
        self._lock = threading.Lock()
        self._epoch = 0
        self._ranks: Dict[int, dict] = {}

    def offer(self, snap: dict) -> str:
        """Fold one per-rank snapshot ``{"rank", "epoch", "window_s",
        "windows": [...], ...}``.  Returns "merged", "dup" (no new
        windows) or "stale_epoch" (fenced)."""
        rank = int(snap.get("rank", -1))
        epoch = int(snap.get("epoch", 0))
        with self._lock:
            if epoch < self._epoch:
                return "stale_epoch"
            self._epoch = max(self._epoch, epoch)
            st = self._ranks.setdefault(rank, {
                "last_seq": -1, "epoch": epoch,
                "windows": deque(maxlen=self.capacity_per_rank),
                "meta": {},
            })
            st["epoch"] = epoch
            for k, v in snap.items():
                if k not in ("rank", "epoch", "windows"):
                    st["meta"][k] = v
            fresh = 0
            for w in snap.get("windows", []):
                seq = int(w.get("window", -1))
                if seq <= st["last_seq"]:
                    continue
                st["windows"].append(w)
                st["last_seq"] = seq
                fresh += 1
            return "merged" if fresh else "dup"

    @property
    def epoch(self) -> int:
        return self._epoch

    def ranks(self) -> List[int]:
        with self._lock:
            return sorted(self._ranks)

    def rank_windows(self, rank: int) -> List[dict]:
        with self._lock:
            st = self._ranks.get(rank)
            return list(st["windows"]) if st else []

    def merged(self) -> dict:
        """One JSON-able fleet view keyed by epoch/rank — the shape
        srt-top renders and the fleet-reconciliation gate inspects."""
        with self._lock:
            ranks = {}
            for rank in sorted(self._ranks):
                st = self._ranks[rank]
                ranks[str(rank)] = {
                    "epoch": st["epoch"],
                    "last_window": st["last_seq"],
                    "windows": list(st["windows"]),
                    "meta": dict(st["meta"]),
                }
            return {"epoch": self._epoch, "ranks": ranks}

    def totals(self, family: str) -> Dict[str, Dict[str, float]]:
        """Per-rank counter totals for one family over every retained
        window — compare against each rank's own registry dump."""
        out: Dict[str, Dict[str, float]] = {}
        for rank in self.ranks():
            out[str(rank)] = sum_counter_windows(
                self.rank_windows(rank), family)
        return out
