"""Flight recorder: anomaly-triggered incident bundles.

The reference stack answers "what was the process doing when it died"
with CUPTI profiler dumps and RmmSpark's thread-state dump; the metrics
spine keeps the same evidence — metrics, journal events, finished
spans, the OOM ledger — but only in bounded in-process rings, so by
the time a human looks at a dead query the interesting records have
rotated out.  This module is the black box: always on (when enabled),
near-zero overhead on the quiet path, and at the moment of failure it
freezes every ring into one self-contained on-disk *incident bundle*
that ``tools/doctor.py`` (``srt-doctor``) can diagnose offline.

Bundle layout (one directory per incident, renamed into place whole so
a half-written bundle is never visible):

    incident-<unix_ms>-<kind>-<seq>/
      trigger.json        what fired: kind, severity, detail, cause
                          chain (exception types/messages, and the
                          full attempt history for RetryExhausted)
      metrics.json        full registry snapshot + per-task rollup
                          (wall-clock anchored: snapshot_unix_ms,
                          uptime_s)
      journal.jsonl       journal ring tail + task_rollup records +
                          registry_snapshot (metrics_report format)
      spans.jsonl         finished-span ring tail (trace_export
                          format)
      memory_ledger.json  SparkResourceAdaptor.memory_ledger(): per
                          thread/task allocation totals, watermarks,
                          OOM-state timeline
      threads.json        python-level stacks of every live thread +
                          the adaptor's thread states
      jit_cache.json      perf/jit_cache stats
      fault_rules.json    the fault injector's live rule set
      env.json            process/config fingerprint (SPARK_RAPIDS_*
                          env, versions, argv, pid)
      MANIFEST.json       written LAST: file sizes + bundle version —
                          its presence marks the bundle complete

Safety valves: a minimum interval between bundles (rate limit) and a
global byte budget over the output directory — a crash-looping
executor fills its budget once and then only counts suppressions,
never the disk.  When a bundle would exceed the remaining budget the
journal/span tails are halved stepwise before giving up.

Knobs: ``SPARK_RAPIDS_TPU_FLIGHT_RECORDER`` (=1 enables at import),
``SPARK_RAPIDS_TPU_FLIGHT_RECORDER_DIR`` (default ``./srt_incidents``),
``SPARK_RAPIDS_TPU_FLIGHT_RECORDER_MAX_BYTES`` (default 64 MiB),
``SPARK_RAPIDS_TPU_FLIGHT_RECORDER_HBM_BYTES`` (arms the HBM-pressure
detector).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.observability import anomaly
from spark_rapids_tpu_torch.observability.dumpio import atomic_write

ENABLE_ENV = "SPARK_RAPIDS_TPU_FLIGHT_RECORDER"
DIR_ENV = "SPARK_RAPIDS_TPU_FLIGHT_RECORDER_DIR"
MAX_BYTES_ENV = "SPARK_RAPIDS_TPU_FLIGHT_RECORDER_MAX_BYTES"
HBM_BYTES_ENV = "SPARK_RAPIDS_TPU_FLIGHT_RECORDER_HBM_BYTES"

DEFAULT_DIR = "srt_incidents"
DEFAULT_MAX_BYTES = 64 << 20
DEFAULT_MIN_INTERVAL_S = 30.0
BUNDLE_VERSION = 1
MANIFEST = "MANIFEST.json"

# journal/span tail sizes tried in order until the bundle fits the
# remaining byte budget
_TAIL_STEPS = (4096, 1024, 256, 64)
MAX_CAUSE_CHAIN = 8


def exception_chain(e: Optional[BaseException]) -> List[dict]:
    """Walk ``__cause__``/``__context__`` into a bounded JSON-able
    chain, innermost last.  RetryExhausted contributes its attempt
    history — the cause chain IS the triage surface."""
    out: List[dict] = []
    seen = set()
    while e is not None and len(out) < MAX_CAUSE_CHAIN:
        if id(e) in seen:
            break
        seen.add(id(e))
        rec = {"type": type(e).__name__, "message": str(e)[:500]}
        attempts = getattr(e, "attempts", None)
        if attempts and isinstance(attempts, list):
            hist = []
            for a in attempts[-16:]:
                hist.append({
                    "index": getattr(a, "index", None),
                    "kind": getattr(a, "kind", None),
                    "error": getattr(a, "error", None),
                    "elapsed_ns": getattr(a, "elapsed_ns", None),
                    "split_depth": getattr(a, "split_depth", 0),
                    "batch_size": getattr(a, "batch_size", None),
                })
            rec["attempts"] = hist
        out.append(rec)
        e = e.__cause__ or e.__context__
    return out


def _jsonable(v, depth: int = 0):
    """Best-effort conversion of trigger detail to JSON-able values
    (a trigger must never fail because a caller passed an object)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if depth >= 4:
        return str(v)[:200]
    if isinstance(v, dict):
        return {str(k)[:64]: _jsonable(x, depth + 1)
                for k, x in list(v.items())[:32]}
    if isinstance(v, (list, tuple, set)):
        return [_jsonable(x, depth + 1) for x in list(v)[:32]]
    return str(v)[:200]


class FlightRecorder:
    """One per process (``observability.FLIGHT``); tests build their
    own with synthetic clocks."""

    def __init__(self, enabled: bool = False,
                 out_dir: Optional[str] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
                 clock=time.monotonic, wallclock=time.time,
                 straggler: Optional[anomaly.StragglerDetector] = None,
                 retry_storm: Optional[anomaly.RetryStormDetector] = None,
                 hbm: Optional[anomaly.HbmPressureDetector] = None,
                 leak: Optional[anomaly.LeakDetector] = None):
        self.enabled = enabled
        self.out_dir = out_dir or DEFAULT_DIR
        self.max_bytes = int(max_bytes)
        self.min_interval_s = float(min_interval_s)
        self.clock = clock
        self.wallclock = wallclock
        self.straggler = straggler or anomaly.StragglerDetector(
            clock=clock)
        self.retry_storm = retry_storm or anomaly.RetryStormDetector(
            clock=clock)
        self.hbm = hbm or anomaly.HbmPressureDetector(clock=clock)
        self.leak = leak or anomaly.LeakDetector()
        self._lock = threading.Lock()
        # serializes whole dumps: the byte-budget read and the write
        # it authorizes must not interleave across threads, or two
        # concurrent triggers jointly overshoot the budget
        self._dump_lock = threading.Lock()
        self._last_trigger_t: Optional[float] = None
        self._last_error_t: Optional[float] = None
        self._seq = 0
        self._bundles_written = 0
        self._bytes_written = 0
        self._suppressed: Dict[str, int] = {}
        self._last_trigger: Optional[dict] = None

    @classmethod
    def from_env(cls, environ=os.environ) -> "FlightRecorder":
        enabled = environ.get(ENABLE_ENV, "") not in ("", "0")
        out_dir = environ.get(DIR_ENV) or DEFAULT_DIR
        try:
            max_bytes = int(environ.get(MAX_BYTES_ENV, ""))
        except ValueError:
            max_bytes = DEFAULT_MAX_BYTES
        if max_bytes <= 0:
            max_bytes = DEFAULT_MAX_BYTES
        hbm = None
        try:
            hbm_bytes = int(environ.get(HBM_BYTES_ENV, ""))
            if hbm_bytes > 0:
                hbm = anomaly.HbmPressureDetector(
                    threshold_bytes=hbm_bytes)
        except ValueError:
            pass
        return cls(enabled=enabled, out_dir=out_dir,
                   max_bytes=max_bytes, hbm=hbm)

    def configure(self, out_dir: Optional[str] = None,
                  max_bytes: Optional[int] = None,
                  min_interval_s: Optional[float] = None) -> None:
        with self._lock:
            if out_dir:
                self.out_dir = out_dir
            if max_bytes is not None and max_bytes > 0:
                self.max_bytes = int(max_bytes)
            if min_interval_s is not None and min_interval_s >= 0:
                self.min_interval_s = float(min_interval_s)

    # ------------------------------------------------------- detectors
    # Feeds called from observability's record helpers.  Each is one
    # method call + the detector's few deque/dict ops; callers gate on
    # `FLIGHT.enabled` first so the disabled path is one attribute read.

    def observe_span(self, rec: dict) -> None:
        if rec.get("span_kind") != "stage":
            return
        task = rec.get("task")
        fire = self.straggler.observe(rec.get("name", "?"),
                                      rec.get("dur_ns", 0), task=task)
        if fire:
            self.trigger("straggler", severity="warn", **fire)

    def observe_retry_episode(self, name: str, outcome: str) -> None:
        fire = self.retry_storm.observe(name)
        if fire:
            fire["last_outcome"] = outcome
            self.trigger("retry_storm", severity="warn", **fire)

    def observe_hbm(self, device, bytes_in_use: int) -> None:
        fire = self.hbm.observe(device, bytes_in_use)
        if fire:
            self.trigger("hbm_pressure", severity="warn", **fire)

    def observe_task_leak(self, task_id: int, leaked_bytes: int,
                          holders=()) -> None:
        fire = self.leak.observe(task_id, leaked_bytes, holders)
        if fire:
            self.trigger("memory_leak", severity="error", **fire)

    # --------------------------------------------------------- trigger

    def trigger(self, kind: str, cause: Optional[BaseException] = None,
                force: bool = False, severity: str = "error",
                **detail) -> Optional[str]:
        """Freeze an incident bundle.  Returns the bundle path, or
        None when disabled/suppressed.  ``force=True`` (the shim's
        ``incident_dump``) bypasses the enabled flag and the rate
        limit but still honors the byte budget."""
        if not self.enabled and not force:
            return None
        now = self.clock()
        with self._lock:
            # severity-aware rate limit: an error trigger is only
            # limited by previous ERROR bundles — a warn bundle (a
            # retry storm fired by the very episode that then
            # exhausts) must never shadow the terminal bundle whose
            # cause chain is the whole point.  Warn triggers are
            # limited by everything.
            last = (self._last_error_t if severity == "error"
                    else self._last_trigger_t)
            if not force and last is not None \
                    and now - last < self.min_interval_s:
                self._suppressed["rate_limit"] = \
                    self._suppressed.get("rate_limit", 0) + 1
                self._count("suppressed", "rate_limit")
                return None
            prev_t, prev_e = self._last_trigger_t, self._last_error_t
            self._last_trigger_t = now
            if severity == "error":
                self._last_error_t = now
            self._seq += 1
            seq = self._seq
        record = {
            "kind": kind,
            "severity": severity,
            "seq": seq,
            "t_unix_ms": int(self.wallclock() * 1000),
            "t_mono_ns": time.monotonic_ns(),
            "pid": os.getpid(),
            "thread": threading.get_ident(),
            "detail": _jsonable(detail),
            "cause_chain": exception_chain(cause),
        }
        with self._lock:
            self._last_trigger = record
        try:
            path = self._dump_bundle(record)
        except Exception:
            # the recorder must never take down the failing code path
            # it is documenting.  Roll back the rate-limit stamps: a
            # TRANSIENT write failure (disk momentarily full) must not
            # shadow the next genuine incident.  (Byte-budget
            # suppression keeps the stamps — retrying cannot help
            # until the budget changes.)
            with self._lock:
                if self._last_trigger_t == now:
                    self._last_trigger_t = prev_t
                if self._last_error_t == now:
                    self._last_error_t = prev_e
                self._suppressed["error"] = \
                    self._suppressed.get("error", 0) + 1
            self._count("suppressed", "error")
            return None
        if path is not None:
            self._count("written", kind)
        return path

    def _count(self, what: str, label: str) -> None:
        """Fold recorder activity into the metrics registry (lazy
        import: this module must stay import-clean of the package)."""
        try:
            from spark_rapids_tpu_torch import observability as obs
            if what == "written":
                obs.INCIDENTS_TOTAL.inc(labels=(label,))
            else:
                obs.INCIDENTS_SUPPRESSED.inc(labels=(label,))
        except Exception:
            pass

    # ------------------------------------------------------------ dump

    def _existing_bytes(self) -> int:
        """Total size of complete bundles already in the output dir —
        counted from their manifests so the budget survives process
        restarts and concurrent writers."""
        total = 0
        try:
            names = os.listdir(self.out_dir)
        except OSError:
            return 0
        for name in names:
            if name.endswith(".tmp"):
                continue  # crash leftovers are litter, not bundles —
            #             they must not eat the budget forever
            try:
                with open(os.path.join(self.out_dir, name,
                                       MANIFEST)) as f:
                    total += int(json.load(f).get("total_bytes", 0))
            except (OSError, ValueError):
                continue
        return total

    def _collect_fixed_files(self, record: dict) -> Dict[str, str]:
        """Render every tail-independent bundle file to a string
        (sizes must be known before anything touches disk: the byte
        budget is a promise).  Rendered ONCE per trigger — only the
        journal/span tails re-render while shrinking to the budget."""
        from spark_rapids_tpu_torch import observability as obs
        files: Dict[str, str] = {}
        files["trigger.json"] = json.dumps(record, indent=2,
                                           sort_keys=True, default=str)
        files["metrics.json"] = json.dumps(obs.snapshot(),
                                           sort_keys=True)

        ledger: dict = {}
        states: List[dict] = []
        try:
            from spark_rapids_tpu_torch.memory import rmm_spark
            adaptor = rmm_spark.installed_adaptor()
            if adaptor is not None:
                ledger = adaptor.memory_ledger()
                states = adaptor.thread_state_dump()
        except Exception:
            ledger = {"error": "memory ledger unavailable"}
        files["memory_ledger.json"] = json.dumps(ledger, indent=2,
                                                 sort_keys=True,
                                                 default=str)
        files["threads.json"] = json.dumps(
            {"python": self._python_threads(), "adaptor": states},
            indent=2, sort_keys=True, default=str)

        try:
            from spark_rapids_tpu_torch.perf import jit_cache
            files["jit_cache.json"] = json.dumps(
                jit_cache.CACHE.stats(), sort_keys=True, default=str)
        except Exception:
            files["jit_cache.json"] = "{}"

        # the live fault-injection rules (srt-doctor's root-cause
        # rule names the one that fired)
        try:
            from spark_rapids_tpu_torch.utils import fault_injection as fi
            inj = fi.installed()
            files["fault_rules.json"] = json.dumps(
                inj.active_rules() if inj is not None else [])
        except Exception:
            files["fault_rules.json"] = "[]"

        # the most recent per-query profile rides every
        # bundle so srt-doctor can name the slowest plan node, not
        # just the slowest thread.  Only written when one exists —
        # a profiler-off process keeps its bundle layout unchanged.
        try:
            prof = obs.PROFILER.last()
            if prof is not None:
                files["profile.json"] = json.dumps(
                    prof, indent=2, sort_keys=True, default=str)
        except Exception:
            pass   # a malformed profile must not block the bundle

        # the last query's time-attribution ledger freezes
        # alongside the profile so srt-doctor can name the dominant
        # bucket at incident time.  Attribution-off processes keep
        # their bundle layout unchanged.
        try:
            led = obs.attribution_last()
            if led is not None:
                files["attribution.json"] = json.dumps(
                    led, indent=2, sort_keys=True, default=str)
        except Exception:
            pass   # a torn ledger must not block the bundle

        files["env.json"] = json.dumps(self._env_fingerprint(),
                                       indent=2, sort_keys=True)
        return files

    @staticmethod
    def _collect_tail_files(tail: int) -> Dict[str, str]:
        """The two ring dumps whose size scales with ``tail``."""
        from spark_rapids_tpu_torch import observability as obs
        lines = [json.dumps(r, default=str)
                 for r in obs.JOURNAL.records()[-tail:]]
        for task_id, d in obs.TASKS.rollup().items():
            lines.append(json.dumps(
                {"kind": "task_rollup", "task": task_id, **d}))
        lines.append(json.dumps({"kind": "registry_snapshot",
                                 "registry": obs.METRICS.snapshot()}))
        return {
            "journal.jsonl": "\n".join(lines) + "\n",
            "spans.jsonl": "".join(
                json.dumps(r, default=str) + "\n"
                for r in obs.TRACER.records()[-tail:]),
        }

    @staticmethod
    def _python_threads() -> List[dict]:
        frames = sys._current_frames()
        out = []
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            stack = (traceback.format_stack(frame, limit=24)
                     if frame is not None else [])
            out.append({"ident": t.ident, "name": t.name,
                        "daemon": t.daemon,
                        "stack": [s.rstrip() for s in stack]})
        return out

    @staticmethod
    def _env_fingerprint() -> dict:
        env = {k: v for k, v in sorted(os.environ.items())
               if k.startswith(("SPARK_RAPIDS_TPU_", "FAULT_INJECTOR_",
                                "TORCH", "CUDA", "BENCH_"))}
        fp = {"pid": os.getpid(), "argv": sys.argv,
              "python": sys.version.split()[0],
              "platform": sys.platform, "env": env}
        try:
            import torch
            fp["torch"] = torch.__version__
            fp["cuda"] = torch.version.cuda
            if torch.cuda.is_available():
                fp["device"] = torch.cuda.get_device_name(
                    torch.cuda.current_device())
        except Exception:
            pass
        return fp

    def _dump_bundle(self, record: dict) -> Optional[str]:
        with self._dump_lock:
            return self._dump_bundle_locked(record)

    def _dump_bundle_locked(self, record: dict) -> Optional[str]:
        kind = "".join(c if c.isalnum() or c in "_-" else "_"
                       for c in record["kind"])[:40]
        os.makedirs(self.out_dir, exist_ok=True)
        remaining = self.max_bytes - self._existing_bytes()
        # sizes are ON-DISK (UTF-8) bytes, not character counts — the
        # budget is a promise about the directory, not about str lens
        fixed = {k: v.encode("utf-8")
                 for k, v in self._collect_fixed_files(record).items()}
        for tail in _TAIL_STEPS:
            files = dict(fixed, **{
                k: v.encode("utf-8")
                for k, v in self._collect_tail_files(tail).items()})
            # +1024: headroom for the manifest itself
            if sum(len(v) for v in files.values()) + 1024 <= remaining:
                break
        else:
            # even the smallest tails blow the budget: suppress
            with self._lock:
                self._suppressed["byte_budget"] = \
                    self._suppressed.get("byte_budget", 0) + 1
            self._count("suppressed", "byte_budget")
            return None
        name = (f"incident-{record['t_unix_ms']}-{kind}"
                f"-{record['seq']:03d}")
        final = os.path.join(self.out_dir, name)
        n = 0
        while os.path.exists(final):
            n += 1
            final = os.path.join(self.out_dir, f"{name}.{n}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        try:
            sizes = {}
            for fname, content in files.items():
                atomic_write(os.path.join(tmp, fname),
                             lambda f, c=content: f.write(c),
                             mode="wb")
                sizes[fname] = len(content)
            manifest = {
                "bundle_version": BUNDLE_VERSION,
                "trigger_kind": record["kind"],
                "severity": record["severity"],
                "seq": record["seq"],
                "t_unix_ms": record["t_unix_ms"],
                "files": sizes,
                "total_bytes": sum(sizes.values()),
            }
            # manifest LAST: its presence marks a complete bundle
            atomic_write(os.path.join(tmp, MANIFEST),
                         lambda f: f.write(json.dumps(manifest,
                                                      indent=2,
                                                      sort_keys=True)))
            os.rename(tmp, final)
        except BaseException:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        with self._lock:
            self._bundles_written += 1
            self._bytes_written += manifest["total_bytes"]
        return final

    # ------------------------------------------------------ inspection

    def incident_list(self) -> List[dict]:
        """Complete bundles under the output dir (manifest-bearing),
        oldest first."""
        out: List[dict] = []
        try:
            names = sorted(os.listdir(self.out_dir))
        except OSError:
            return out
        for name in names:
            if name.endswith(".tmp"):
                continue  # a bundle still being assembled
            path = os.path.join(self.out_dir, name)
            try:
                with open(os.path.join(path, MANIFEST)) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                continue
            out.append({"path": path,
                        "kind": m.get("trigger_kind"),
                        "severity": m.get("severity"),
                        "seq": m.get("seq"),
                        "t_unix_ms": m.get("t_unix_ms"),
                        "total_bytes": m.get("total_bytes")})
        out.sort(key=lambda r: (r["t_unix_ms"] or 0, r["seq"] or 0,
                                r["path"]))
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "dir": self.out_dir,
                "max_bytes": self.max_bytes,
                "min_interval_s": self.min_interval_s,
                "bundles_written": self._bundles_written,
                "bytes_written": self._bytes_written,
                "suppressed": dict(self._suppressed),
                "last_trigger": self._last_trigger,
            }
