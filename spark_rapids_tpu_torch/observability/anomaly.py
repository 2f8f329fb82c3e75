"""Anomaly detectors feeding the flight recorder.

Canopy-style trigger model (PAPERS.md): the always-on spine records
everything into bounded rings; these detectors watch the streams the
spine already produces and decide the MOMENT something is wrong, so the
flight recorder can freeze the rings into an incident bundle while the
evidence is still in them.

Four detectors, one contract: ``observe(...)`` is called from the hot
record helpers, costs a few dict/deque ops, and returns ``None`` on
the quiet path or a JSON-able dict describing the anomaly when one
fires.  Each detector self-arms with a cooldown (per key where it has
keys) so a sustained condition produces ONE fire, not a firehose — the
recorder's own rate limiting is the backstop, not the primary valve.

Clocks are injectable everywhere (``clock()`` returning seconds) so
tests drive the windows synthetically.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


def robust_z(value: float, samples) -> float:
    """Robust z-score of ``value`` against ``samples`` via median/MAD
    (consistent-estimator scaling 1.4826).  The MAD is floored at 5%
    of the median (and at 1.0) so a near-constant sample set cannot
    turn ordinary jitter into an infinite score."""
    xs = sorted(samples)
    n = len(xs)
    if n == 0:
        return 0.0
    med = (xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2.0)
    devs = sorted(abs(x - med) for x in xs)
    mad = (devs[n // 2] if n % 2
           else (devs[n // 2 - 1] + devs[n // 2]) / 2.0)
    scale = max(1.4826 * mad, 0.05 * abs(med), 1.0)
    return (value - med) / scale


class StragglerDetector:
    """Per-stage task-duration outliers: a new duration whose robust
    z-score against the stage's recent window exceeds ``threshold``
    fires (the "stage exchange.step p99 9.8x p50" class of finding).
    Needs ``min_samples`` prior observations per stage before it can
    judge — a cold stage never fires on its first slow task."""

    def __init__(self, threshold: float = 6.0, min_samples: int = 8,
                 window: int = 128, cooldown_s: float = 60.0,
                 clock=time.monotonic):
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.window = int(window)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._durations: Dict[str, deque] = {}
        self._last_fire: Dict[str, float] = {}

    def observe(self, stage: str, dur_ns: int,
                task=None) -> Optional[dict]:
        with self._lock:
            win = self._durations.get(stage)
            if win is None:
                win = self._durations[stage] = deque(maxlen=self.window)
            fired = None
            if len(win) >= self.min_samples:
                z = robust_z(float(dur_ns), win)
                if z >= self.threshold:
                    now = self.clock()
                    last = self._last_fire.get(stage)
                    if last is None or now - last >= self.cooldown_s:
                        self._last_fire[stage] = now
                        xs = sorted(win)
                        fired = {
                            "stage": stage,
                            "task": task,
                            "dur_ns": int(dur_ns),
                            "median_ns": int(xs[len(xs) // 2]),
                            "robust_z": round(z, 2),
                            "samples": len(win),
                        }
            win.append(float(dur_ns))
            return fired


class RetryStormDetector:
    """Retry-episode rate over a sliding window: more than
    ``threshold`` failed episodes inside ``window_s`` seconds fires.
    One storm = one fire (cooldown)."""

    def __init__(self, threshold: int = 10, window_s: float = 10.0,
                 cooldown_s: float = 60.0, clock=time.monotonic):
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._times: deque = deque()
        self._sections: deque = deque(maxlen=16)
        self._last_fire: Optional[float] = None

    def observe(self, section: str = "?") -> Optional[dict]:
        now = self.clock()
        with self._lock:
            self._times.append(now)
            self._sections.append(section)
            cutoff = now - self.window_s
            while self._times and self._times[0] < cutoff:
                self._times.popleft()
            if len(self._times) < self.threshold:
                return None
            if self._last_fire is not None and \
                    now - self._last_fire < self.cooldown_s:
                return None
            self._last_fire = now
            return {
                "episodes_in_window": len(self._times),
                "window_s": self.window_s,
                "recent_sections": sorted(set(self._sections)),
            }


class HbmPressureDetector:
    """Sustained HBM pressure: a device whose ``bytes_in_use`` stays at
    or above ``threshold_bytes`` for ``sustain_s`` seconds fires.  A
    ``threshold_bytes`` of None disarms the detector (the library
    cannot guess a chip's capacity; the operator sets the knob)."""

    def __init__(self, threshold_bytes: Optional[int] = None,
                 sustain_s: float = 5.0, cooldown_s: float = 60.0,
                 clock=time.monotonic):
        self.threshold_bytes = (None if threshold_bytes is None
                                else int(threshold_bytes))
        self.sustain_s = float(sustain_s)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._above_since: Dict[str, float] = {}
        self._last_fire: Dict[str, float] = {}

    def observe(self, device: str, bytes_in_use: int) -> Optional[dict]:
        if self.threshold_bytes is None:
            return None
        device = str(device)
        now = self.clock()
        with self._lock:
            if bytes_in_use < self.threshold_bytes:
                self._above_since.pop(device, None)
                return None
            since = self._above_since.setdefault(device, now)
            if now - since < self.sustain_s:
                return None
            last = self._last_fire.get(device)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_fire[device] = now
            return {
                "device": device,
                "bytes_in_use": int(bytes_in_use),
                "threshold_bytes": self.threshold_bytes,
                "sustained_s": round(now - since, 3),
            }


DEFAULT_LEAK_FLOOR_BYTES = 64 << 10


class LeakDetector:
    """Task-end leak check: ``task_done`` saw unreleased device bytes
    still attributed to the finishing task.  Fires per event when the
    leak is at least ``min_bytes`` (pool threads working for several
    tasks attribute their held bytes to every finishing task, so small
    residues can be shared accounting noise — the 64 KiB default floor
    filters those; the journal still records every positive leak)."""

    def __init__(self, min_bytes: int = DEFAULT_LEAK_FLOOR_BYTES):
        self.min_bytes = int(min_bytes)

    def observe(self, task_id: int, leaked_bytes: int,
                holders=()) -> Optional[dict]:
        if leaked_bytes < self.min_bytes:
            return None
        return {
            "task": task_id,
            "leaked_bytes": int(leaked_bytes),
            "holders": list(holders)[:8],
        }
