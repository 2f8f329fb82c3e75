"""Per-tenant SLO definitions + multi-window burn-rate monitoring.

An SLO here is the serving-system contract the Presto-on-GPUs line of
work is judged on: *objective* fraction of a tenant's queries must
succeed within a *latency target*, end to end (admission wait +
execution — the number a caller actually experiences).  Every server
completion becomes one SLI event:

    good  :=  outcome == "success"  AND  latency_ns <= target

The monitor tracks the bad fraction over TWO sliding windows — a fast
one (default 60 s) for responsiveness and a slow one (default 600 s)
to suppress blips — and converts each to a *burn rate*: the observed
bad fraction divided by the error budget (1 - objective).  Burn 1.0
means the budget is being spent exactly as provisioned; the alert
fires only when BOTH windows exceed the threshold (the classic
multi-window multi-burn rule), which rides the ``slo_burn``
flight-recorder trigger so the incident bundle freezes the timeseries
ring tail + the offending tenant's snapshot alongside the usual
evidence.

Everything takes an injectable clock so tests and the CI smoke drive
minutes of burn in milliseconds, and ``observe()`` is a deque append —
safe on the server completion path.  One attribute read when the
monitor is disabled (same switch discipline as every other hook).

Configuration (``SloMonitor.from_env``):

  SPARK_RAPIDS_TPU_SLO                enable ("1")
  SPARK_RAPIDS_TPU_SLO_CONFIG         inline JSON or @/path/to/file:
      {"*":       {"latency_ms": 250, "objective": 0.99},
       "tenantA": {"latency_ms": 50,  "objective": 0.999}}
      ("*" is the default applied to tenants without their own entry;
      with no config at all every tenant gets the built-in default)
  SPARK_RAPIDS_TPU_SLO_FAST_S         fast burn window (default 60)
  SPARK_RAPIDS_TPU_SLO_SLOW_S         slow burn window (default 600)
  SPARK_RAPIDS_TPU_SLO_BURN_THRESHOLD fire when both windows exceed
                                      this burn rate (default 4.0)
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

DEFAULT_LATENCY_MS = 250.0
DEFAULT_OBJECTIVE = 0.99
DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 600.0
DEFAULT_BURN_THRESHOLD = 4.0

# outcomes that do not consume error budget: the tenant asked for the
# cancel, and a shed/rejected query never ran — admission-control
# pushback is reported by the server stats, not double-counted as an
# SLO miss (deadline/failed/hung DO burn budget).  cache_hit is
# neutral in BOTH directions: a free warm answer must not count as a
# latency win either, or a cache-heavy replay would mask a burning
# tenant
_NEUTRAL_OUTCOMES = frozenset({"cancelled", "rejected", "shed",
                               "requeued", "admitted", "cache_hit"})


@dataclass(frozen=True)
class SloConfig:
    """One tenant's objective: latency target + success-ratio goal."""

    latency_target_ns: int = int(DEFAULT_LATENCY_MS * 1e6)
    objective: float = DEFAULT_OBJECTIVE

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"slo objective must be in (0,1): "
                             f"{self.objective}")

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)

    def to_dict(self) -> dict:
        return {"latency_ms": self.latency_target_ns / 1e6,
                "objective": self.objective}

    @classmethod
    def from_dict(cls, d: dict) -> "SloConfig":
        ms = float(d.get("latency_ms", DEFAULT_LATENCY_MS))
        obj = float(d.get("objective", DEFAULT_OBJECTIVE))
        if not 0.0 < obj < 1.0:
            raise ValueError(f"slo objective must be in (0,1): {obj}")
        return cls(latency_target_ns=int(ms * 1e6), objective=obj)


def parse_slo_config(spec: str) -> Dict[str, SloConfig]:
    """``SPARK_RAPIDS_TPU_SLO_CONFIG`` parser: inline JSON object or
    ``@path`` indirection.  Malformed config raises — a serving fleet
    silently monitoring the wrong objective is worse than failing to
    boot."""
    spec = spec.strip()
    if not spec:
        return {}
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    obj = json.loads(spec)
    if not isinstance(obj, dict):
        raise ValueError("slo config must be a JSON object "
                         "keyed by tenant")
    return {str(t): SloConfig.from_dict(d) for t, d in obj.items()}


class _TenantState:
    __slots__ = ("config", "events", "good_total", "bad_total",
                 "breaches", "last_fire", "burn_fast", "burn_slow")

    def __init__(self, config: SloConfig):
        self.config = config
        # (t_mono, good) — pruned to the slow window on evaluate
        self.events: deque = deque()
        self.good_total = 0
        self.bad_total = 0
        self.breaches = 0
        self.last_fire: Optional[float] = None
        self.burn_fast = 0.0
        self.burn_slow = 0.0


class SloMonitor:
    """Multi-window burn-rate evaluator over server completion events.

    ``observe()`` runs on the completion path (cheap); ``evaluate()``
    runs at window granularity off the Monitor thread and returns the
    list of tenants whose burn alert fired this round (already
    cooldown-filtered) — the observability wiring turns each into one
    ``slo_burn`` incident."""

    def __init__(self, configs: Optional[Dict[str, SloConfig]] = None,
                 *, fast_s: float = DEFAULT_FAST_S,
                 slow_s: float = DEFAULT_SLOW_S,
                 threshold: float = DEFAULT_BURN_THRESHOLD,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_burn: Optional[Callable[[str, dict], None]] = None,
                 max_tenants: int = 256):
        self.enabled = False
        self.configs = dict(configs or {})
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.threshold = float(threshold)
        # one alert per tenant per slow window by default: the CI smoke
        # asserts EXACTLY one bundle for the injected-slow tenant
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else slow_s)
        self.on_burn = on_burn
        self.max_tenants = int(max_tenants)
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {}
        self._last_eval: Optional[float] = None

    @classmethod
    def from_env(cls, environ=os.environ, **kw) -> "SloMonitor":
        configs = parse_slo_config(
            environ.get("SPARK_RAPIDS_TPU_SLO_CONFIG", ""))

        def _f(name, default):
            raw = environ.get(name, "")
            return float(raw) if raw else default

        return cls(configs,
                   fast_s=_f("SPARK_RAPIDS_TPU_SLO_FAST_S",
                             DEFAULT_FAST_S),
                   slow_s=_f("SPARK_RAPIDS_TPU_SLO_SLOW_S",
                             DEFAULT_SLOW_S),
                   threshold=_f("SPARK_RAPIDS_TPU_SLO_BURN_THRESHOLD",
                                DEFAULT_BURN_THRESHOLD),
                   **kw)

    # -------------------------------------------------------- ingest

    def _config_for(self, tenant: str) -> SloConfig:
        return self.configs.get(tenant) \
            or self.configs.get("*") \
            or SloConfig()

    def observe(self, tenant: str, outcome: str, latency_ns: int,
                now: Optional[float] = None) -> None:
        """One SLI event from the server completion hook.  Neutral
        outcomes (tenant-initiated cancels, admission pushback) are
        ignored — they spend no error budget."""
        if not self.enabled:
            return
        if outcome in _NEUTRAL_OUTCOMES:
            return
        now = self._clock() if now is None else now
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                if len(self._tenants) >= self.max_tenants:
                    return  # bounded like every per-tenant table
                st = self._tenants[tenant] = _TenantState(
                    self._config_for(tenant))
            good = (outcome == "success"
                    and latency_ns <= st.config.latency_target_ns)
            st.events.append((now, good))
            if good:
                st.good_total += 1
            else:
                st.bad_total += 1

    # ------------------------------------------------------ evaluate

    @staticmethod
    def _bad_fraction(events, cutoff: float) -> Optional[float]:
        good = bad = 0
        for t, g in events:
            if t < cutoff:
                continue
            if g:
                good += 1
            else:
                bad += 1
        n = good + bad
        return (bad / n) if n else None

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Recompute every tenant's burn rates; returns the alerts that
        fired this round as ``[{"tenant", "burn_fast", "burn_slow",
        ...}]`` (cooldown already applied).  Also invokes ``on_burn``
        per alert when set."""
        if not self.enabled:
            return []
        now = self._clock() if now is None else now
        fired: List[dict] = []
        with self._lock:
            for tenant, st in self._tenants.items():
                while st.events and st.events[0][0] < now - self.slow_s:
                    st.events.popleft()
                bf = self._bad_fraction(st.events, now - self.fast_s)
                bs = self._bad_fraction(st.events, now - self.slow_s)
                budget = st.config.error_budget
                st.burn_fast = (bf / budget) if bf is not None else 0.0
                st.burn_slow = (bs / budget) if bs is not None else 0.0
                if st.burn_fast >= self.threshold \
                        and st.burn_slow >= self.threshold:
                    if st.last_fire is not None \
                            and now - st.last_fire < self.cooldown_s:
                        continue
                    st.last_fire = now
                    st.breaches += 1
                    fired.append({
                        "tenant": tenant,
                        "burn_fast": round(st.burn_fast, 3),
                        "burn_slow": round(st.burn_slow, 3),
                        "fast_window_s": self.fast_s,
                        "slow_window_s": self.slow_s,
                        "threshold": self.threshold,
                        "objective": st.config.objective,
                        "latency_target_ms":
                            st.config.latency_target_ns / 1e6,
                        "attainment": self._attainment_locked(st),
                    })
        if self.on_burn is not None:
            for alert in fired:
                self.on_burn(alert["tenant"], alert)
        return fired

    def maybe_evaluate(self, now: Optional[float] = None
                       ) -> Optional[List[dict]]:
        """Throttled evaluate for the Monitor-thread drive path: runs
        at most every fast_s/10 (>= 0.5 s) so a fast sample period
        does not re-scan every tenant's event deque each tick.
        Returns None when throttled, else the fired alerts."""
        if not self.enabled:
            return None
        now = self._clock() if now is None else now
        period = max(self.fast_s / 10.0, 0.5)
        if self._last_eval is not None \
                and now - self._last_eval < period:
            return None
        self._last_eval = now
        return self.evaluate(now)

    # -------------------------------------------------------- status

    @staticmethod
    def _attainment_locked(st: _TenantState) -> float:
        n = st.good_total + st.bad_total
        return (st.good_total / n) if n else 1.0

    def attainment(self, tenant: str) -> float:
        """Lifetime good fraction for one tenant (1.0 when it has no
        budget-consuming events yet)."""
        with self._lock:
            st = self._tenants.get(tenant)
            return self._attainment_locked(st) if st else 1.0

    def status(self) -> Dict[str, dict]:
        """JSON-able per-tenant SLO view — embedded in server stats,
        timeseries snapshots and the metrics-report "slo" section."""
        with self._lock:
            out = {}
            for tenant in sorted(self._tenants):
                st = self._tenants[tenant]
                out[tenant] = {
                    "latency_target_ms":
                        st.config.latency_target_ns / 1e6,
                    "objective": st.config.objective,
                    "events": st.good_total + st.bad_total,
                    "attainment": round(self._attainment_locked(st), 6),
                    "burn_fast": round(st.burn_fast, 3),
                    "burn_slow": round(st.burn_slow, 3),
                    "breaches": st.breaches,
                }
            return out

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()
            self._last_eval = None
