"""Process-wide metrics registry (counters, gauges, histograms).

The reference scatters its numbers across three surfaces — CUPTI
activity records (profiler/), NVML polled gauges (NVMLMonitor.java),
and the RmmSpark getAndReset* per-task counters
(SparkResourceAdaptorJni.cpp) — each with its own consumer.  This
registry is the single spine those islands feed here: named metric
families with small bounded label sets, safe under concurrent writers,
exposable as Prometheus text format or a JSON snapshot.

Design constraints:

  * near-zero cost when disabled: every mutator first reads one module
    bool (`_enabled` via the owning registry) and returns — no locks,
    no allocation on the fast path;
  * bounded label sets: a family caps its distinct label tuples
    (default 64); once full, updates with unseen tuples collapse into a
    single ``__other__`` series and `dropped_series` counts those
    collapsed updates (unseen tuples are deliberately not remembered —
    that map is exactly what must not grow), so a cardinality bug can
    never make exposition unbounded;
  * thread-safe: one lock per child series (updates are a handful of
    integer ops), one lock per family for child creation.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.analysis.lockdep import make_lock

# Latency buckets in nanoseconds: 1us .. 10s decades, the range host-side
# op brackets actually land in (sub-us brackets are measurement noise).
DEFAULT_LATENCY_BUCKETS_NS = (
    1_000, 10_000, 100_000, 1_000_000, 10_000_000,
    100_000_000, 1_000_000_000, 10_000_000_000)

_OTHER = "__other__"


def _fmt_value(v) -> str:
    """Prometheus sample value: integers render without exponent."""
    if isinstance(v, float) and not v.is_integer():
        return repr(v)
    return str(int(v))


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


class _Series:
    """One labelled child: a value cell (counter/gauge) or histogram
    state.  All mutation under its own small lock."""

    __slots__ = ("lock", "value", "bucket_counts", "sum", "count")

    def __init__(self, n_buckets: int = 0):
        self.lock = make_lock("metrics.series")
        self.value = 0
        if n_buckets:
            self.bucket_counts = [0] * (n_buckets + 1)  # +inf tail
            self.sum = 0
            self.count = 0


class _Family:
    """Base for one named metric family with a declared label schema."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labels: Sequence[str], max_series: int):
        self.registry = registry
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self.max_series = max_series
        self.dropped_series = 0
        self._lock = make_lock("metrics.family")
        self._children: Dict[Tuple[str, ...], _Series] = {}

    # -- child management --------------------------------------------------

    def _n_buckets(self) -> int:
        return 0

    def _child(self, labels: Optional[Tuple[str, ...]]) -> _Series:
        key = tuple(str(v) for v in labels) if labels else ()
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: got {len(key)} label values for "
                f"{len(self.label_names)} declared labels")
        c = self._children.get(key)
        if c is not None:
            return c
        with self._lock:
            c = self._children.get(key)
            if c is None:
                if key and len(self._children) >= self.max_series:
                    # bounded label set: collapse into the overflow
                    # series rather than growing without limit (counts
                    # every collapsed update, not distinct tuples —
                    # remembering tuples is the growth being prevented)
                    self.dropped_series += 1
                    key = (_OTHER,) * len(self.label_names)
                    c = self._children.get(key)
                    if c is not None:
                        return c
                c = _Series(self._n_buckets())
                self._children[key] = c
        return c

    def reset(self):
        with self._lock:
            self._children.clear()
            self.dropped_series = 0

    # -- exposition --------------------------------------------------------

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.label_names, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def expose(self, out: List[str]):
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            items = sorted(self._children.items())
        for key, c in items:
            out.append(
                f"{self.name}{self._label_str(key)} {_fmt_value(c.value)}")

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._children.items())
        return {
            "kind": self.kind, "help": self.help,
            "labels": list(self.label_names),
            "series": [{"labels": list(k), "value": c.value}
                       for k, c in items],
        }


class Counter(_Family):
    kind = "counter"

    def inc(self, value=1, labels: Optional[Tuple[str, ...]] = None):
        if not self.registry.enabled:
            return
        c = self._child(labels)
        with c.lock:
            c.value += value


class Gauge(_Family):
    kind = "gauge"

    def set(self, value, labels: Optional[Tuple[str, ...]] = None):
        if not self.registry.enabled:
            return
        c = self._child(labels)
        with c.lock:
            c.value = value

    def add(self, value, labels: Optional[Tuple[str, ...]] = None):
        if not self.registry.enabled:
            return
        c = self._child(labels)
        with c.lock:
            c.value += value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry, name, help, labels, max_series,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_NS):
        super().__init__(registry, name, help, labels, max_series)
        self.buckets = tuple(sorted(buckets))

    def _n_buckets(self) -> int:
        return len(self.buckets)

    def observe(self, value, labels: Optional[Tuple[str, ...]] = None):
        if not self.registry.enabled:
            return
        c = self._child(labels)
        i = 0
        for b in self.buckets:           # ~8 entries: linear scan wins
            if value <= b:
                break
            i += 1
        with c.lock:
            c.bucket_counts[i] += 1
            c.sum += value
            c.count += 1

    def expose(self, out: List[str]):
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} histogram")
        with self._lock:
            items = sorted(self._children.items())
        for key, c in items:
            # snapshot under the series lock: a torn read across a
            # concurrent observe would scrape count != sum-of-buckets
            with c.lock:
                bucket_counts = list(c.bucket_counts)
                total, n_obs = c.sum, c.count
            cum = 0
            for b, n in zip(self.buckets, bucket_counts):
                cum += n
                le = 'le="%s"' % _fmt_value(b)
                out.append(f"{self.name}_bucket"
                           f"{self._label_str(key, le)} {cum}")
            cum += bucket_counts[-1]
            inf = 'le="+Inf"'
            out.append(f"{self.name}_bucket"
                       f"{self._label_str(key, inf)} {cum}")
            out.append(f"{self.name}_sum{self._label_str(key)} "
                       f"{_fmt_value(total)}")
            out.append(f"{self.name}_count{self._label_str(key)} "
                       f"{n_obs}")

    def _series_state(self, c: _Series) -> dict:
        with c.lock:
            return {"bucket_counts": list(c.bucket_counts),
                    "sum": c.sum, "count": c.count}

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._children.items())
        return {
            "kind": "histogram", "help": self.help,
            "labels": list(self.label_names),
            "buckets": list(self.buckets),
            "series": [{"labels": list(k), **self._series_state(c)}
                       for k, c in items],
        }


class MetricsRegistry:
    """Named metric families; the process normally holds ONE of these
    (spark_rapids_tpu_torch.observability.METRICS)."""

    def __init__(self, enabled: bool = False, max_series: int = 64):
        self.enabled = enabled
        self.default_max_series = max_series
        self._lock = make_lock("metrics.registry")
        self._families: Dict[str, _Family] = {}

    # -- family creation (idempotent: same name returns same family) ------

    def _family(self, cls, name, help, labels, max_series, **kw):
        with self._lock:
            f = self._families.get(name)
            if f is not None:
                if type(f) is not cls:
                    raise ValueError(
                        f"metric {name} already registered as {f.kind}")
                return f
            f = cls(self, name, help, labels,
                    max_series or self.default_max_series, **kw)
            self._families[name] = f
            return f

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = (),
                max_series: int = 0) -> Counter:
        return self._family(Counter, name, help, labels, max_series)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = (),
              max_series: int = 0) -> Gauge:
        return self._family(Gauge, name, help, labels, max_series)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_NS,
                  max_series: int = 0) -> Histogram:
        return self._family(Histogram, name, help, labels, max_series,
                            buckets=buckets)

    # -- lifecycle ---------------------------------------------------------

    def reset(self):
        """Zero every family's series (families stay registered so
        module-level instrument handles remain valid)."""
        with self._lock:
            fams = list(self._families.values())
        for f in fams:
            f.reset()

    # -- exposition --------------------------------------------------------

    def expose_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        with self._lock:
            fams = sorted(self._families.items())
        for _, f in fams:
            f.expose(out)
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> dict:
        with self._lock:
            fams = sorted(self._families.items())
        return {name: f.snapshot() for name, f in fams}

    def family_snapshot(self, name: str) -> Optional[dict]:
        """One family's snapshot (None when unregistered) — consumers
        that diff a handful of named families (the query profiler)
        must not pay a whole-registry walk per read."""
        with self._lock:
            f = self._families.get(name)
        return f.snapshot() if f is not None else None

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)
