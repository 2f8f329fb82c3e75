"""Query lifeguard: the eviction half of multi-tenancy (the port of
the JAX package's ``robustness/lifeguard.py``; same policy, clocks and
bounds).

Admission and fair-share scheduling decide who gets into the resident
server; this module supplies the primitives the query server
(``server/server.py``) wires into its watchdog to take a misbehaving
query out:

  * **heartbeats**: a bounded per-thread "last sign of life" table.
    Workers beat through the existing instrumentation seams: every
    retry-driver attempt start (``robustness/retry.py``), every
    cooperative ``QueryContext.check_cancel`` poll (``models``), and
    every hook the observability heartbeat seam feeds.  A worker
    silent past the hang threshold is presumed wedged.
  * :class:`QuarantineBreaker`: a (tenant, query, schema-digest)
    circuit breaker: a signature that dies repeatedly (hang /
    OOM-exhausted / crash) is quarantined with a retry-after hint and
    re-admitted through a half-open single probe, so one poison query
    stops burning pool slots and retry budget for everyone.
  * :class:`Watchdog`: a small resilient ticker thread: calls the
    server's scan on an interval, swallows (and counts) scan bugs so
    the lifeguard can never drown the pool it guards.

Everything takes injectable clocks so tests drive the policy
synchronously; nothing here imports the server package (the server
imports us).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.analysis.lockdep import make_lock

# ------------------------------------------------------------ heartbeats

# thread ident -> (monotonic_ns, label).  Bounded: dead threads' rows
# are pruned once the table crosses _BEATS_MAX (a resident server must
# not keep one row per worker thread that ever lived).
_BEATS: Dict[int, Tuple[int, str]] = {}
_BEATS_LOCK = make_lock("lifeguard.beats")
_BEATS_MAX = 4096


def beat(label: str = "") -> None:
    """Record a sign of life for the CURRENT thread.  Called from the
    hot instrumentation seams (cooperative checkpoints, retry attempt
    starts), so the no-consumer path — no server ever started, hook
    refcount zero — is a single global read; otherwise two dict ops
    under a lock."""
    if _HOOK_INSTALLS == 0:
        return
    ident = threading.get_ident()
    now = time.monotonic_ns()
    with _BEATS_LOCK:
        if ident not in _BEATS and len(_BEATS) >= _BEATS_MAX:
            live = {t.ident for t in threading.enumerate()}
            for dead in [i for i in _BEATS if i not in live]:
                del _BEATS[dead]
        _BEATS[ident] = (now, label)


def last_beat(ident: int) -> Optional[Tuple[int, str]]:
    """(monotonic_ns, label) of the thread's last beat, or None."""
    with _BEATS_LOCK:
        return _BEATS.get(ident)


def clear_beat(ident: int) -> None:
    with _BEATS_LOCK:
        _BEATS.pop(ident, None)


_HOOK_LOCK = make_lock("lifeguard.hook")
_HOOK_INSTALLS = 0


def install_heartbeat_hook() -> None:
    """Route the observability heartbeat seam
    (``observability.set_heartbeat_hook``) into :func:`beat`, so every
    hook that calls it counts as a sign of life.  Ref-counted with
    :func:`release_heartbeat_hook`; installed by each server start (a
    process that never serves pays nothing)."""
    global _HOOK_INSTALLS
    from spark_rapids_tpu_torch import observability as _obs
    with _HOOK_LOCK:
        _HOOK_INSTALLS += 1
        _obs.set_heartbeat_hook(lambda op: beat(f"op:{op}"))


def release_heartbeat_hook() -> None:
    """Drop one install; at zero the hook is removed so a process
    whose servers are all stopped pays nothing on the hot
    instrumentation paths again."""
    global _HOOK_INSTALLS
    from spark_rapids_tpu_torch import observability as _obs
    with _HOOK_LOCK:
        if _HOOK_INSTALLS > 0:
            _HOOK_INSTALLS -= 1
        if _HOOK_INSTALLS == 0:
            _obs.set_heartbeat_hook(None)


def thread_stack(ident: Optional[int], limit: int = 24) -> List[str]:
    """Python-level stack of a live thread (the hung worker's 'where
    is it stuck' evidence for the ``query_hang`` bundle)."""
    if ident is None:
        return []
    import sys
    frame = sys._current_frames().get(ident)
    if frame is None:
        return []
    return [s.rstrip()
            for s in traceback.format_stack(frame, limit=limit)]


# ------------------------------------------------------------- signature


def signature(tenant: str, query: str, params: Optional[dict]) -> str:
    """Poison-query identity: tenant + query name + schema digest.
    The digest folds the params dict (which determines the generated
    data's schema/shape for catalog queries), so ``tpcds_q9`` at 1k
    rows and the same query at 1M rows quarantine independently."""
    try:
        blob = json.dumps(params or {}, sort_keys=True, default=str)
    except (TypeError, ValueError):
        blob = repr(sorted((params or {}).items(), key=str))
    digest = hashlib.sha256(blob.encode()).hexdigest()[:12]
    return f"{tenant}/{query}@{digest}"


# ------------------------------------------------------------ quarantine

QUARANTINE_CLOSED = "closed"
QUARANTINE_OPEN = "open"
QUARANTINE_HALF_OPEN = "half_open"

# outcomes that count as a "death" for the breaker (hang, OOM budget
# exhausted against quota, crash, burned its whole deadline); success
# closes, cancellation is neutral
DEATH_OUTCOMES = ("hung", "shed", "failed", "deadline")


class QuarantineBreaker:
    """Per-signature circuit breaker with half-open probe re-admission.

    ``failures`` consecutive deaths open the circuit for
    ``cooldown_s`` (doubling on every re-open, capped at 8x); once the
    cooldown passes, exactly ONE probe submission is re-admitted —
    success closes the circuit, another death re-opens it with the
    escalated cooldown.  Entries are LRU-bounded so a tenant cycling
    fresh params cannot grow resident state without limit."""

    MAX_ENTRIES = 512

    def __init__(self, failures: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failures = int(failures)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = make_lock("lifeguard.breaker")
        self._entries: Dict[str, dict] = {}

    @property
    def enabled(self) -> bool:
        return self.failures > 0

    def _entry(self, sig: str) -> dict:
        e = self._entries.pop(sig, None)
        if e is None:
            e = {"state": QUARANTINE_CLOSED, "strikes": 0,
                 "opens": 0, "open_until": 0.0, "last_reason": None,
                 "probe_since": 0.0}
            if len(self._entries) >= self.MAX_ENTRIES:
                # evict CLOSED entries first: a tenant churning fresh
                # signatures (exactly the load this bound exists for)
                # must not flush an OPEN quarantine out of the table —
                # that would re-admit the poison query with a clean
                # slate.  Open entries only go once the table doubles
                # the cap (hard bound beats an unbounded dict).
                for sig2 in list(self._entries):
                    if len(self._entries) < self.MAX_ENTRIES:
                        break
                    if self._entries[sig2]["state"] \
                            == QUARANTINE_CLOSED:
                        del self._entries[sig2]
                while len(self._entries) >= self.MAX_ENTRIES * 2:
                    self._entries.pop(next(iter(self._entries)))
        self._entries[sig] = e   # (re-)insert at the LRU tail
        return e

    def _cooldown_for(self, opens: int) -> float:
        return min(self.cooldown_s * (2.0 ** max(opens - 1, 0)),
                   self.cooldown_s * 8.0)

    # ---------------------------------------------------------- admit

    def admit(self, sig: str) -> dict:
        """Admission verdict for a signature:
        ``{"verdict": "ok"}`` (closed), ``{"verdict": "probe"}`` (the
        half-open single probe — caller must report the outcome), or
        ``{"verdict": "refused", "retry_after_s": ...}``."""
        if not self.enabled:
            return {"verdict": "ok"}
        now = self.clock()
        with self._lock:
            e = self._entries.get(sig)
            if e is None or e["state"] == QUARANTINE_CLOSED:
                return {"verdict": "ok"}
            # an actively-refused signature is HOT: refresh its LRU
            # recency so signature churn can't age the open circuit
            # to the eviction end of the table
            self._entries[sig] = self._entries.pop(sig)
            if e["state"] == QUARANTINE_OPEN:
                if now < e["open_until"]:
                    return {"verdict": "refused",
                            "retry_after_s":
                                round(e["open_until"] - now, 3),
                            "strikes": e["strikes"]}
                # cooldown over: re-admit exactly one probe
                e = self._entry(sig)
                e["state"] = QUARANTINE_HALF_OPEN
                e["probe_since"] = now
                return {"verdict": "probe", "strikes": e["strikes"]}
            # HALF_OPEN: a probe is already in flight — wait for it.
            # Self-healing: a probe whose outcome never came back (a
            # server stopped mid-probe, an abandoned drain straggler)
            # must not quarantine the signature forever, so past a
            # generous window the door re-arms and grants a new probe.
            stale_after = max(self._cooldown_for(e["opens"]) * 2,
                              60.0)
            if e.get("probe_since", 0.0) \
                    and now - e["probe_since"] > stale_after:
                e["state"] = QUARANTINE_HALF_OPEN
                e["probe_since"] = now
                return {"verdict": "probe", "strikes": e["strikes"]}
            return {"verdict": "refused",
                    "retry_after_s": round(
                        self._cooldown_for(e["opens"]), 3),
                    "strikes": e["strikes"]}

    def abort_probe(self, sig: str) -> None:
        """The probe admission bounced downstream (queue full, quota):
        the circuit re-opens with an expired cooldown so the next
        submit probes again."""
        with self._lock:
            e = self._entries.get(sig)
            if e is not None and e["state"] == QUARANTINE_HALF_OPEN:
                e["state"] = QUARANTINE_OPEN
                e["open_until"] = 0.0

    # -------------------------------------------------------- outcomes

    def note_death(self, sig: str, reason: str,
                   probe: bool = False) -> dict:
        """A job with this signature died (``reason`` in
        :data:`DEATH_OUTCOMES`).  Returns the breaker transition:
        ``{"quarantined": bool, "strikes", "opened": bool,
        "retry_after_s"}``."""
        if not self.enabled:
            return {"quarantined": False, "strikes": 0,
                    "opened": False, "retry_after_s": 0.0}
        now = self.clock()
        with self._lock:
            e = self._entry(sig)
            e["strikes"] += 1
            e["last_reason"] = reason
            opened = False
            if probe or e["state"] == QUARANTINE_HALF_OPEN:
                # failed probe: re-open with escalated cooldown
                e["opens"] += 1
                e["state"] = QUARANTINE_OPEN
                e["open_until"] = now + self._cooldown_for(e["opens"])
                opened = True
            elif e["state"] == QUARANTINE_CLOSED \
                    and e["strikes"] >= self.failures:
                e["opens"] += 1
                e["state"] = QUARANTINE_OPEN
                e["open_until"] = now + self._cooldown_for(e["opens"])
                opened = True
            quarantined = e["state"] == QUARANTINE_OPEN
            return {"quarantined": quarantined,
                    "strikes": e["strikes"], "opened": opened,
                    "retry_after_s":
                        round(max(e["open_until"] - now, 0.0), 3)}

    def note_success(self, sig: str, probe: bool = False) -> dict:
        """A job with this signature finished cleanly: strikes reset;
        a successful probe closes the circuit."""
        if not self.enabled:
            return {"closed": False}
        with self._lock:
            e = self._entries.get(sig)
            if e is None:
                return {"closed": False}
            was_open = e["state"] != QUARANTINE_CLOSED
            e["state"] = QUARANTINE_CLOSED
            e["strikes"] = 0
            e["opens"] = 0
            e["open_until"] = 0.0
            return {"closed": was_open}

    def note_neutral(self, sig: str, probe: bool = False) -> None:
        """Cancelled: not a death, not a recovery.  A cancelled probe
        re-opens the door for the next probe immediately."""
        if probe:
            self.abort_probe(sig)

    # -------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        with self._lock:
            quarantined = {}
            for sig, e in self._entries.items():
                if e["state"] != QUARANTINE_CLOSED:
                    quarantined[sig] = {
                        "state": e["state"],
                        "strikes": e["strikes"],
                        "opens": e["opens"],
                        "last_reason": e["last_reason"],
                    }
            return {"enabled": self.enabled,
                    "failures": self.failures,
                    "cooldown_s": self.cooldown_s,
                    "tracked": len(self._entries),
                    "quarantined": quarantined}


# -------------------------------------------------------------- watchdog


class Watchdog:
    """Resilient ticker: runs ``scan()`` every ``interval_s`` on a
    daemon thread.  A scan that raises is counted and swallowed — the
    lifeguard must never drown the pool it guards."""

    def __init__(self, scan: Callable[[], None], interval_s: float,
                 name: str = "srt-lifeguard"):
        self.scan = scan
        self.interval_s = max(float(interval_s), 0.01)
        self.name = name
        self.scan_errors = 0
        self.scans = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name=self.name, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout_s)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scans += 1
                self.scan()
            except Exception:
                self.scan_errors += 1

    def snapshot(self) -> dict:
        return {"interval_s": self.interval_s, "scans": self.scans,
                "scan_errors": self.scan_errors,
                "alive": self._thread is not None}
