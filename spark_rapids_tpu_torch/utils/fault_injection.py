"""Fault injection at the shim boundary (reference faultinj/faultinj.cu:
libcufaultinj.so loaded via CUDA_INJECTION64_PATH, JSON config from
FAULT_INJECTOR_CONFIG_PATH with hot reload, matching driver/runtime
callbacks by function name or '*' with probability and repeat counts).

Port mapping: the interception point is the op shim, as in the JAX
package — ops (or the Java bindings layer) call `maybe_inject(op_name)`
before dispatch, so a rule fires at the same calls whichever package
runs it.  Config schema mirrors the reference:

    {"seed": 42,                       # optional deterministic seed
     "faults": [
        {"match": "murmur3_32",        # exact op name or "*"
         "probability": 0.5,           # 0..1 (default 1.0)
         "repeat": 3,                  # max hits, -1 = unlimited
         "exception": "CudfException"} # or "GpuRetryOOM", ...
     ]}

Probabilities draw from Python's ``random.Random(seed)``, the JAX
injector's generator, so one seeded rules file fires at the same calls
in both packages.  The config file is watched by mtime and
hot-reloaded, like the reference's dynamicReconfig watcher thread
(faultinj.cu:88); the watcher stops on ``uninstall``."""

from __future__ import annotations

import json
import os
import random
import threading
from typing import List, Optional

from spark_rapids_tpu_torch.analysis.lockdep import make_lock
from spark_rapids_tpu_torch.memory import exceptions as exc

CONFIG_ENV = "FAULT_INJECTOR_CONFIG_PATH"

_EXCEPTIONS = {
    "CudfException": exc.CudfException,
    "GpuRetryOOM": exc.GpuRetryOOM,
    "GpuSplitAndRetryOOM": exc.GpuSplitAndRetryOOM,
    "CpuRetryOOM": exc.CpuRetryOOM,
    "CpuSplitAndRetryOOM": exc.CpuSplitAndRetryOOM,
    "GpuOOM": exc.GpuOOM,
}


class _Rule:
    def __init__(self, spec: dict):
        self.match = spec.get("match", "*")
        self.probability = float(spec.get("probability", 1.0))
        self.remaining = int(spec.get("repeat", -1))
        self.exception = _EXCEPTIONS.get(spec.get("exception",
                                                  "CudfException"),
                                         exc.CudfException)

    def applies(self, op_name: str) -> bool:
        return self.match == "*" or self.match == op_name


INTERVAL_ENV = "FAULT_INJECTOR_INTERVAL_MS"
DEFAULT_INTERVAL_MS = 200


class FaultInjector:
    def __init__(self, config_path: Optional[str] = None,
                 watch: bool = False,
                 interval_ms: Optional[int] = None):
        """A missing/unreadable/garbled config is TOLERATED (empty rule
        set) — the watcher keeps polling and picks the file up when it
        appears or heals, matching the reference injector's dynamic-
        reconfig behavior.  ``interval_ms`` tunes the watch poll
        (default 200ms, env ``FAULT_INJECTOR_INTERVAL_MS``)."""
        self.config_path = config_path or os.environ.get(CONFIG_ENV)
        if interval_ms is None:
            try:
                env = int(os.environ.get(INTERVAL_ENV, ""))
            except ValueError:
                env = 0      # unset/garbled env: tolerant, like the
            #                  config itself — fall to the default
            interval_ms = env if env > 0 else DEFAULT_INTERVAL_MS
        self.interval_ms = max(int(interval_ms), 1)
        self._rules: List[_Rule] = []
        self._rng = random.Random()
        self._lock = make_lock("faultinj.rules")
        self._mtime = 0.0
        self._watching = False
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        if self.config_path:
            self.reload()
            if watch:
                self._watching = True
                self._watcher = threading.Thread(
                    target=self._watch_loop, name="srt-faultinj-watch",
                    daemon=True)
                self._watcher.start()

    def reload(self) -> bool:
        """Load/refresh the rule set; returns True when a config was
        applied.  A missing or unreadable file clears the rules (and
        returns False) instead of raising — the watcher retries, so a
        config that appears later still takes effect; a file that
        exists but holds bad JSON keeps the CURRENT rules (a partial
        write must not drop live rules)."""
        # stat BEFORE reading: a write landing between read and stat must
        # still trigger another reload on the next watcher poll
        try:
            mtime = os.stat(self.config_path).st_mtime
        except OSError:
            mtime = self._mtime
        try:
            with open(self.config_path) as f:
                spec = json.load(f)
        except OSError:
            with self._lock:
                self._rules = []
                # forget the applied mtime: a config restored with a
                # PRESERVED mtime (mv of a backup) must still reload
                self._mtime = 0.0
            return False
        except (json.JSONDecodeError, ValueError):
            # keep the CURRENT rules and the OLD mtime: a bad read is
            # usually a non-atomic write in flight, and recording its
            # mtime could skip the completed write when it lands in
            # the same mtime granule — re-parse every poll instead
            return False
        try:
            # build OUTSIDE the lock and tolerantly: valid JSON with a
            # garbled rule spec (bad probability, non-dict entry) must
            # keep the current rules, like any other bad write
            rules = [_Rule(r) for r in spec.get("faults", [])]
            seed = spec.get("seed")
        except (TypeError, ValueError, AttributeError, KeyError):
            return False    # garbled rule spec: same contract as a
        #                     bad write — keep rules, keep re-parsing
        with self._lock:
            if seed is not None:
                self._rng = random.Random(seed)
            self._rules = rules
            self._mtime = mtime
        return True

    def _watch_loop(self):
        while not self._stop.wait(self.interval_ms / 1000.0):
            try:
                m = os.stat(self.config_path).st_mtime
            except OSError:
                # config deleted: drop any live rules ONCE (deleting
                # the file is the operator's off switch, same contract
                # as reload on a missing file); keep polling for it
                with self._lock:
                    had_rules = bool(self._rules)
                if had_rules:
                    self.reload()
                continue
            if m != self._mtime:
                self.reload()   # tolerant: see reload's contract

    def stop(self):
        """Stop the watcher thread (it ends within one poll; joined
        unless the caller IS the watcher)."""
        self._watching = False
        self._stop.set()
        w = self._watcher
        if w is not None and w is not threading.current_thread():
            w.join(self.interval_ms / 1000.0 + 1.0)
        self._watcher = None

    def active_rules(self) -> List[dict]:
        """Snapshot of the live rule set (shim/CLI introspection and
        the chaos harness's hot-reload assertion)."""
        with self._lock:
            return [{"match": r.match, "probability": r.probability,
                     "remaining": r.remaining,
                     "exception": r.exception.__name__}
                    for r in self._rules]

    def maybe_inject(self, op_name: str):
        """Raise the configured exception for this op, honoring
        probability and repeat count."""
        with self._lock:
            for rule in self._rules:
                if not rule.applies(op_name):
                    continue
                if rule.remaining == 0:
                    continue
                if rule.probability < 1.0 and \
                        self._rng.random() >= rule.probability:
                    continue
                if rule.remaining > 0:
                    rule.remaining -= 1
                raise rule.exception(
                    f"injected fault in {op_name}")


_global: Optional[FaultInjector] = None


def install(config_path: Optional[str] = None,
            watch: bool = True,
            interval_ms: Optional[int] = None) -> FaultInjector:
    """Process-global injector (the CUDA_INJECTION64_PATH load analog).
    Replacing an installed injector stops its watcher first."""
    global _global
    if _global is not None:
        _global.stop()
    _global = FaultInjector(config_path, watch=watch,
                            interval_ms=interval_ms)
    return _global


def installed() -> Optional[FaultInjector]:
    return _global


def uninstall():
    global _global
    if _global is not None:
        _global.stop()
    _global = None


def maybe_inject(op_name: str):
    if _global is not None:
        _global.maybe_inject(op_name)
