"""Data-statistics plane.

Six observability PRs made *time* fully observable; nothing observed
the *data*.  This module is the cardinality & statistics observatory:

  * vectorized one-pass sketches over device columns — a KMV
    distinct-count sketch (bottom-k of a splitmix64 hash), a
    space-saving heavy-hitter sketch, min/max/null-fraction, and an
    equi-width histogram — all plain numpy over a host copy of the
    column's first ``sketch_row_cap()`` rows;
  * the :class:`StatsCollector` singleton (``observability.STATS``)
    that folds per-node observed row counts tapped out of fused
    stages (plan/compiler.py) into per-node actuals, joins them
    against registered *estimates* (Parquet footer row counts,
    catalog generator sizes), and fires the misestimate sentinel when
    actual/estimate divergence exceeds
    ``SPARK_RAPIDS_TPU_STATS_MISEST_RATIO``;
  * the persistent :class:`StatsStore`, keyed by (plan digest, node
    id, source ingest-epoch vector from perf/result_cache) with the
    same file-cache discipline as perf/calibrate.py (atomic
    tmp+replace writes, TTL, {} on torn reads) — actuals and sketches
    survive across processes, and a source's ingest-epoch bump
    naturally starts a fresh key.

Cost discipline (the tracer's noop contract): with
``SPARK_RAPIDS_TPU_STATS`` off every hook is ONE attribute read —
the compiler checks ``STATS.enabled`` before building any
observation, and :func:`StatsCollector.note_stage` is never reached.

The module is dependency-light on purpose: the metric/journal/trigger
fan-out is injected by ``observability/__init__`` through the
``on_observation``/``on_misestimate``/``on_sketch`` callbacks (the
profiler's ``enabled_ref`` pattern), so tests build isolated
collectors and the layering rule (instrumented layers import
observability, never the reverse) holds.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.analysis.lockdep import make_rlock

STATS_VERSION = 1

# sketch defaults: KMV bottom-k (relative NDV error ~ 1/sqrt(k-1),
# ~1.6% at 4096), space-saving counter budget, histogram bins
KMV_K = 4096
HH_CAPACITY = 64
HIST_BINS = 16

DEFAULT_MISEST_RATIO = 8.0
DEFAULT_TTL_S = 7 * 86400.0

# journal/profile payloads stay bounded: a stage with hundreds of
# nodes still reports at most this many per-node rows
_MAX_NODES_REPORTED = 64


def misest_ratio() -> float:
    """Sentinel threshold (dynamic read, like fusion_mode): actual
    vs estimate divergence past this ratio fires the misestimate
    chain."""
    try:
        return float(os.environ.get(
            "SPARK_RAPIDS_TPU_STATS_MISEST_RATIO",
            DEFAULT_MISEST_RATIO))
    except ValueError:
        return DEFAULT_MISEST_RATIO


def sketch_row_cap() -> int:
    """Rows a single sketch pass will look at (head slice): bounds
    host-copy cost on huge columns; the cap is generous because the
    pass is one-shot per (stage, input, epoch vector)."""
    try:
        return int(os.environ.get(
            "SPARK_RAPIDS_TPU_STATS_SKETCH_ROWS", str(1 << 20)))
    except ValueError:
        return 1 << 20


# ------------------------------------------------------------------ hashing


def host_head(column, max_rows: int) -> np.ndarray:
    """The first ``max_rows`` values of a column as a host array: a
    tensor is sliced on its device, then copied to the host once.
    FLOAT64 comes back as its uint64 bit pattern (the form the JAX
    package stores it in), so sketches over it equal the JAX
    package's value for value."""
    import torch
    if isinstance(column, torch.Tensor):
        t = column.detach()[:max_rows]
        if t.dtype == torch.float64:
            return t.view(torch.int64).cpu().numpy().view(np.uint64)
        return t.cpu().numpy()
    return np.asarray(column)


def _hash64(values: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over a column's bit pattern — the KMV
    sketch's uniform hash.  Floats hash their IEEE bits (NaN patterns
    collapse to one canonical NaN), non-numeric dtypes hash through
    python ``hash`` per UNIQUE value (one pass over the distinct set,
    not the column)."""
    a = np.asarray(values)
    if a.dtype.kind == "f":
        a = a.astype(np.float64, copy=False)
        a = np.where(np.isnan(a), np.float64("nan"), a)
        a = a.view(np.uint64)
    elif a.dtype.kind in "iub":
        a = a.astype(np.int64, copy=False).view(np.uint64)
    else:
        u, inv = np.unique(a.astype(str), return_inverse=True)
        hu = np.fromiter(
            (hash(x) & 0xFFFFFFFFFFFFFFFF for x in u),
            dtype=np.uint64, count=len(u))
        a = hu[inv]
    z = a + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


# ----------------------------------------------------------------- sketches


def kmv_sketch(values, k: int = KMV_K) -> dict:
    """KMV (bottom-k) distinct-count sketch.  Below ``k`` distinct
    hashes the answer is EXACT; past it the k-th smallest hash
    position estimates NDV as ``(k-1) / U_(k)`` with ``U_(k)`` the
    normalized k-th minimum — standard error ~ ``1/sqrt(k-2)``."""
    h = np.unique(_hash64(values))
    if h.size < k:
        return {"k": int(k), "exact": True, "ndv": int(h.size)}
    kth = np.partition(h, k - 1)[k - 1]
    u = (float(kth) + 1.0) / float(2 ** 64)
    ndv = (k - 1) / u if u > 0 else float(h.size)
    return {"k": int(k), "exact": False, "kth": int(kth),
            "ndv": int(round(ndv))}


def heavy_hitter_sketch(values, capacity: int = HH_CAPACITY) -> dict:
    """Space-saving heavy-hitter sketch: at most ``capacity`` live
    counters; a new value at capacity evicts the minimum counter and
    inherits its count as overestimation error.  Guarantees: every
    value with true frequency > n/capacity is present, and each
    reported ``count`` overestimates the true one by at most ``err``.
    The pass is vectorized per chunk (np.unique folds duplicates
    before the counter merge touches python)."""
    a = np.asarray(values).reshape(-1)
    counters: Dict[object, List[int]] = {}   # value -> [count, err]
    n = int(a.size)
    chunk = 1 << 16
    for lo in range(0, n, chunk):
        u, c = np.unique(a[lo:lo + chunk], return_counts=True)
        for v, cnt in zip(u.tolist(), c.tolist()):
            slot = counters.get(v)
            if slot is not None:
                slot[0] += cnt
            elif len(counters) < capacity:
                counters[v] = [cnt, 0]
            else:
                m = min(counters, key=lambda x: counters[x][0])
                floor = counters[m][0]
                del counters[m]
                counters[v] = [floor + cnt, floor]
    items = sorted(
        ([v, int(cc[0]), int(cc[1])] for v, cc in counters.items()),
        key=lambda it: (-it[1], str(it[0])))
    return {"capacity": int(capacity), "n": n, "items": items}


def heavy_hitter_topk(sketch: dict, k: int) -> list:
    """Top-``k`` values by estimated count (the sketch already sorts
    descending)."""
    return [it[0] for it in sketch.get("items", [])[:k]]


def histogram_sketch(values, bins: int = HIST_BINS) -> Optional[dict]:
    """Equi-width histogram over the finite values (exact counts —
    equi-width needs only min/max, known after the same pass).  None
    for non-numeric columns or all-NaN input."""
    a = np.asarray(values).reshape(-1)
    if a.dtype.kind not in "iufb" or a.size == 0:
        return None
    a = a.astype(np.float64, copy=False)
    a = a[np.isfinite(a)]
    if a.size == 0:
        return None
    lo, hi = float(a.min()), float(a.max())
    if lo == hi:
        return {"bins": 1, "lo": lo, "hi": hi, "counts": [int(a.size)]}
    counts, _edges = np.histogram(a, bins=bins, range=(lo, hi))
    return {"bins": int(bins), "lo": lo, "hi": hi,
            "counts": [int(c) for c in counts]}


def column_stats(values, *, kmv_k: int = KMV_K,
                 hh_capacity: int = HH_CAPACITY,
                 bins: int = HIST_BINS,
                 max_rows: Optional[int] = None) -> dict:
    """One-pass column statistics: rows, null fraction (NaN for
    floats), min/max, KMV NDV, heavy hitters, equi-width histogram.
    ``max_rows`` head-slices the column first (the sketch-cost cap);
    ``rows`` still reports the slice actually observed."""
    a = np.asarray(values).reshape(-1)
    if max_rows is not None and a.size > max_rows:
        a = a[:max_rows]
    rows = int(a.size)
    null_frac = 0.0
    mn = mx = None
    if a.dtype.kind == "f" and rows:
        nan = int(np.isnan(a).sum())
        null_frac = nan / rows
        fin = a[np.isfinite(a)]
        if fin.size:
            mn, mx = float(fin.min()), float(fin.max())
    elif a.dtype.kind in "iub" and rows:
        mn, mx = int(a.min()), int(a.max())
    kmv = kmv_sketch(a, k=kmv_k) if rows else \
        {"k": kmv_k, "exact": True, "ndv": 0}
    return {
        "rows": rows,
        "null_frac": round(null_frac, 6),
        "min": mn,
        "max": mx,
        "ndv": int(kmv["ndv"]),
        "ndv_exact": bool(kmv.get("exact")),
        "kmv": kmv,
        "heavy_hitters": heavy_hitter_sketch(a, capacity=hh_capacity)
        if rows else {"capacity": hh_capacity, "n": 0, "items": []},
        "histogram": histogram_sketch(a, bins=bins),
    }


# --------------------------------------------------------------- stats store


def store_path() -> str:
    """Persistent stats file (calibrate.py's cache_path contract):
    env-pointed, tempdir default, empty string disables the file
    layer (the process cache still works)."""
    return os.environ.get(
        "SPARK_RAPIDS_TPU_STATS_STORE",
        os.path.join(tempfile.gettempdir(), "srt_stats_store.json"))


def _load(path: str) -> dict:
    if not path:
        return {}
    try:
        with open(path) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def _save(path: str, d: dict) -> None:
    """Atomic tmp+replace (the calibrate.py discipline): a reader
    racing a truncate-write would see torn JSON, read {}, and the
    next save would wipe every persisted actual."""
    if not path:
        return
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _ttl() -> float:
    try:
        return float(os.environ.get(
            "SPARK_RAPIDS_TPU_STATS_STORE_TTL", DEFAULT_TTL_S))
    except ValueError:
        return DEFAULT_TTL_S


def epoch_signature(epochs: Dict[str, int]) -> str:
    """Canonical ingest-epoch vector: part of every store key, so a
    source's epoch bump (perf/result_cache.note_ingest) retires the
    old actuals instead of averaging stale data in."""
    return ",".join(f"{k}:{int(v)}" for k, v in sorted(epochs.items()))


class StatsStore:
    """Persistent per-node actuals + sketches, keyed
    ``plan_digest|node|epoch_signature``.  Process dict for the hot
    path, JSON file (atomic writes, TTL) for cross-process reuse."""

    def __init__(self, path_fn: Callable[[], str] = store_path):
        self._path_fn = path_fn
        self._lock = make_rlock("observability.stats_store")
        self._proc: Dict[str, dict] = {}
        self._loaded = False

    @staticmethod
    def key(plan_digest: str, node: str,
            epochs: Dict[str, int]) -> str:
        return f"{plan_digest}|{node}|{epoch_signature(epochs)}"

    def _load_once_locked(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        now = time.time()  # srt-lint: disable=SRT005 wall-clock TTL of the on-disk store; expiry never folds into a digest or cache key
        for k, rec in _load(self._path_fn()).items():
            if not isinstance(rec, dict):
                continue
            try:
                fresh = now - float(rec.get("t", 0)) < _ttl()
            except (TypeError, ValueError):
                fresh = False
            if fresh:
                self._proc[k] = rec

    def record(self, plan_digest: str, node: str,
               epochs: Dict[str, int], rows: int,
               sketch: Optional[dict] = None,
               persist: bool = True) -> dict:
        """Fold one observation; returns the merged record
        ({rows, calls, sketch?})."""
        k = self.key(plan_digest, node, epochs)
        with self._lock:
            self._load_once_locked()
            rec = self._proc.get(k)
            if rec is None:
                rec = {"rows": int(rows), "calls": 0}
            rec["rows"] = int(rows)
            rec["calls"] = int(rec.get("calls", 0)) + 1
            if sketch is not None:
                rec["sketch"] = sketch
            # srt-lint: disable=SRT005 wall-clock stamp read back only by the TTL check; never part of a key
            rec["t"] = time.time()
            self._proc[k] = rec
            if persist:
                path = self._path_fn()
                d = _load(path)
                d[k] = rec
                _save(path, d)
            return dict(rec)

    def lookup(self, plan_digest: str, node: str,
               epochs: Dict[str, int]) -> Optional[dict]:
        k = self.key(plan_digest, node, epochs)
        with self._lock:
            self._load_once_locked()
            rec = self._proc.get(k)
            return dict(rec) if rec is not None else None

    def clear(self) -> int:
        """Drop process entries AND the file (operator reset door)."""
        with self._lock:
            n = len(self._proc)
            self._proc.clear()
            self._loaded = True
            _save(self._path_fn(), {})
            return n

    def reset(self) -> None:
        """Process-side reset only (tests): the file layer keeps its
        entries — point SPARK_RAPIDS_TPU_STATS_STORE at a throwaway
        file to isolate."""
        with self._lock:
            self._proc.clear()
            self._loaded = False


# ------------------------------------------------------------ the collector


def _ingest_epochs(sources) -> Dict[str, int]:
    """Current ingest-epoch vector for a stage's input names (perf/result_cache's
    registry; a source nobody bumped reads 0).  Lazy import keeps the
    observability <- perf layering acyclic at import time."""
    try:
        from spark_rapids_tpu_torch.perf.result_cache import ingest_epoch
        return {str(s): int(ingest_epoch(str(s))) for s in sources}
    except Exception:
        return {str(s): 0 for s in sources}


class StatsCollector:
    """Process-wide estimate registry + observation folder + sentinel.

    ``enabled`` is the one-attribute-read gate the compiler checks
    before building any observation.  ``on_observation(stage, n)``,
    ``on_misestimate(stage, node, est, actual, ratio, first)`` and
    ``on_sketch(ns)`` are the accounting hooks observability/__init__
    points at the ``srt_stats_*`` families."""

    def __init__(self, store: Optional[StatsStore] = None,
                 on_observation: Optional[Callable] = None,
                 on_misestimate: Optional[Callable] = None,
                 on_sketch: Optional[Callable] = None):
        self.enabled = False
        self.store = store if store is not None else StatsStore()
        self.on_observation = on_observation
        self.on_misestimate = on_misestimate
        self.on_sketch = on_sketch
        self._lock = make_rlock("observability.stats")
        # (stage, node) -> {"rows": int, "origin": str}
        self._estimates: Dict[Tuple[str, str], dict] = {}
        # source -> {"rows": int, "origin": str} (parquet footers …)
        self._sources: Dict[str, dict] = {}
        # last stats section per stage (snapshot/debug surface)
        self._last: Dict[str, dict] = {}
        # sketch memo: (stage, input, epoch_sig) -> column stats
        self._sketches: Dict[Tuple[str, str, str], dict] = {}
        # sentinel once-per-key discipline: the flight-recorder
        # bundle fires on the FIRST detection of a (stage, node)
        # misestimate; repeats still count the metric
        self._misest_fired: set = set()
        self._observations = 0
        self._misestimates = 0

    # ------------------------------------------------------- estimates

    def register_estimate(self, stage: str, node: str, rows: int,
                          origin: str = "manual") -> None:
        """Expected row count for one plan node (``input:<name>`` for
        scan inputs).  Catalog runners register generator sizes;
        tests/operators seed deliberate misestimates through the same
        door."""
        with self._lock:
            self._estimates[(str(stage), str(node))] = {
                "rows": int(rows), "origin": str(origin)}

    def register_input_estimates(self, stage: str,
                                 rows_by_input: Dict[str, int],
                                 origin: str = "catalog") -> None:
        for name, rows in rows_by_input.items():
            self.register_estimate(stage, f"input:{name}", rows,
                                   origin=origin)

    def note_source_rows(self, source: str, rows: int,
                         origin: str = "parquet_footer") -> None:
        """Footer-derived estimate for an ingest source (io/ layer):
        consulted as the fallback when no per-node estimate was
        registered for an input of the same name."""
        with self._lock:
            self._sources[str(source)] = {"rows": int(rows),
                                          "origin": str(origin)}

    def estimate_for(self, stage: str, node: str) -> Optional[dict]:
        with self._lock:
            est = self._estimates.get((str(stage), str(node)))
            if est is None and node.startswith("input:"):
                est = self._sources.get(node[len("input:"):])
            return dict(est) if est is not None else None

    def forget_estimates(self) -> None:
        with self._lock:
            self._estimates.clear()
            self._sources.clear()
            self._misest_fired.clear()

    # ----------------------------------------------------- observation

    def _check_misestimate(self, stage: str, node: str,
                           est_rows: int, actual: int) -> Optional[float]:
        """Symmetric divergence ratio when past the threshold, else
        None (the +1 smoothing keeps 0-row actuals finite)."""
        ratio = max((actual + 1) / (est_rows + 1),
                    (est_rows + 1) / (actual + 1))
        if ratio < misest_ratio():
            return None
        return ratio

    def _sketch_for(self, stage: str, name: str, epoch_sig: str,
                    column) -> Optional[dict]:
        """Column stats memoized per (stage, input, epoch vector):
        the sketch pass runs ONCE per key per process, then rides the
        store."""
        key = (stage, name, epoch_sig)
        with self._lock:
            hit = self._sketches.get(key)
        if hit is not None:
            return hit
        try:
            t0 = time.monotonic_ns()
            cs = column_stats(host_head(column, sketch_row_cap()),
                              max_rows=sketch_row_cap())
            ns = time.monotonic_ns() - t0
        except Exception:
            return None
        hook = self.on_sketch
        if hook is not None:
            try:
                hook(ns)
            except Exception:
                pass
        with self._lock:
            if len(self._sketches) > 512:
                self._sketches.clear()
            self._sketches[key] = cs
        return cs

    def note_stage(self, observation: dict,
                   columns: Optional[Dict[str, object]] = None
                   ) -> Optional[dict]:
        """Fold one stage execution's observed row counts (the
        compiler's tap vector, already host-side ints) into the
        store, join estimates, run the sentinel, and return the
        profile's per-stage ``stats`` section.  Never raises — stats
        must not fail the query they describe."""
        if not self.enabled:
            return None
        try:
            return self._note_stage(observation, columns or {})
        except Exception:
            return None

    def _note_stage(self, observation: dict,
                    columns: Dict[str, object]) -> dict:
        stage = str(observation.get("stage", "?"))
        plan_digest = str(observation.get("plan_digest", "?"))
        inputs = list(observation.get("inputs", ()))
        tapped = list(observation.get("nodes", ()))
        epochs = _ingest_epochs([i["name"] for i in inputs])
        epoch_sig = epoch_signature(epochs)

        nodes: List[dict] = []
        rows_in = 0
        for i in inputs:
            name, rows = str(i["name"]), int(i["rows"])
            rows_in += rows
            row = {"node": f"input:{name}", "kind": "input",
                   "rows": rows}
            col = columns.get(name)
            if col is not None:
                cs = self._sketch_for(stage, name, epoch_sig, col)
                if cs is not None:
                    row["ndv"] = cs["ndv"]
                    row["null_frac"] = cs["null_frac"]
            nodes.append(row)
        for t in tapped[:_MAX_NODES_REPORTED]:
            row = {"node": str(t["node"]), "kind": str(t["kind"]),
                   "rows": int(t["rows"])}
            denom = int(t.get("rows_in", 0)) or rows_in
            if t["kind"] == "Project" and denom > 0:
                row["selectivity"] = round(int(t["rows"]) / denom, 6)
            nodes.append(row)

        misestimates = []
        for row in nodes:
            est = self.estimate_for(stage, row["node"])
            if est is None:
                continue
            row["est"] = int(est["rows"])
            row["est_origin"] = est["origin"]
            ratio = self._check_misestimate(
                stage, row["node"], int(est["rows"]), row["rows"])
            if ratio is None:
                continue
            row["misestimate"] = True
            row["ratio"] = round(ratio, 2)
            misestimates.append(row)
            with self._lock:
                self._misestimates += 1
                first = (stage, row["node"]) not in self._misest_fired
                self._misest_fired.add((stage, row["node"]))
            hook = self.on_misestimate
            if hook is not None:
                try:
                    hook(stage=stage, node=row["node"],
                         est=int(est["rows"]), actual=row["rows"],
                         ratio=row["ratio"], first=first)
                except Exception:
                    pass

        for row in nodes:
            sketch = None
            if row["kind"] == "input":
                name = row["node"][len("input:"):]
                sketch = self._sketches.get((stage, name, epoch_sig))
                if sketch is not None:
                    # the persisted copy keeps the compact sketches,
                    # not the full histogram-of-everything payload
                    sketch = {"ndv": sketch["ndv"],
                              "null_frac": sketch["null_frac"],
                              "min": sketch["min"],
                              "max": sketch["max"],
                              "kmv": sketch["kmv"],
                              "heavy_hitters":
                                  sketch["heavy_hitters"],
                              "histogram": sketch["histogram"]}
            self.store.record(plan_digest, row["node"], epochs,
                              row["rows"], sketch=sketch)

        section = {
            "version": STATS_VERSION,
            "epochs": epochs,
            "rows_in": rows_in,
            "rows_out": (int(tapped[-1]["rows"]) if tapped else None),
            "nodes": nodes,
        }
        with self._lock:
            self._observations += len(nodes)
            self._last[stage] = section
        hook = self.on_observation
        if hook is not None:
            try:
                hook(stage, nodes, misestimates)
            except Exception:
                pass
        return section

    # ------------------------------------------------------------ read

    def last(self, stage: str) -> Optional[dict]:
        with self._lock:
            s = self._last.get(str(stage))
            return dict(s) if s is not None else None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "observations": self._observations,
                "misestimates": self._misestimates,
                "estimates": {
                    f"{s}/{n}": dict(v)
                    for (s, n), v in sorted(self._estimates.items())},
                "sources": {k: dict(v) for k, v
                            in sorted(self._sources.items())},
                "stages": {k: dict(v) for k, v
                           in sorted(self._last.items())},
            }

    def reset(self) -> None:
        with self._lock:
            self._estimates.clear()
            self._sources.clear()
            self._last.clear()
            self._sketches.clear()
            self._misest_fired.clear()
            self._observations = 0
            self._misestimates = 0
        self.store.reset()
