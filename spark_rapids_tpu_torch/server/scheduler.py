"""Weighted fair-share scheduling across tenants.

Classic virtual-time fair queuing, sized for a per-process executor:
every tenant accumulates ``vruntime`` (service seconds / weight) as
its jobs complete, and dispatch picks the queued tenant with the
smallest ``vruntime + running/weight`` — tenants that have consumed
the least weighted service (counting what they are running *right
now*) go first, so a tenant that queues 50 jobs cannot starve one
that queues 2.  A tenant arriving (or returning from idle) has its
vruntime floored to the minimum among currently-active tenants — the
CFS wakeup rule — so neither a newcomer starting at zero nor an
early-runner returning with a stale-low value can monopolize the pool
to "catch up" on service it never asked for.

Within a tenant the queue is FIFO by admission order — which is also
descending ``memory/task_priority`` order, since the server registers
each admitted attempt with the global priority registry: earlier
admissions hold higher (larger) priorities, and a load-shed requeue
releases + re-registers its attempt id, landing a strictly lower
priority AND the back of its tenant's queue (the documented
re-registration semantics in ``task_priority.py``).

``deficit()`` is the starvation evidence surface: per tenant, how far
behind the most-served tenant its weighted service is.  The soak gate
asserts it stays bounded and every tenant finishes.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

STATE_QUEUED = "queued"
STATE_RUNNING = "running"
STATE_DONE = "done"
STATE_FAILED = "failed"
STATE_CANCELLED = "cancelled"


@dataclass
class Job:
    """One admitted query: identity, attribution, and lifecycle."""

    query_id: str
    tenant: str
    query: str
    params: dict
    seq: int                 # global admission order (FIFO tiebreak)
    task_id: int             # RmmSpark/task_priority attempt id
    priority: int            # task_priority value at (re-)admission
    submit_ns: int
    demotions: int = 0       # load-shed requeues so far
    spill_rescued: bool = False  # one-shot spill-store rescue used
    state: str = STATE_QUEUED
    result: Any = None
    error: Optional[dict] = None
    wait_ns: int = 0
    dur_ns: int = 0
    outcome: Optional[str] = None  # terminal verdict (finalize stamps
    #                                it; cache_hit is DISTINCT from a
    #                                zero-duration success)
    # lifeguard fields
    deadline_ns: Optional[int] = None   # absolute monotonic deadline
    signature: Optional[str] = None     # quarantine identity
    probe: bool = False                 # half-open re-admission probe
    cancel_reason: Optional[str] = None  # "user"|"deadline"|"drain"
    worker_ident: Optional[int] = None  # executing thread (heartbeats)
    run_start_ns: int = 0               # dispatch time (hang age base)
    hung: bool = False                  # watchdog declared it wedged
    cancel_event: threading.Event = field(
        default_factory=threading.Event)
    done_event: threading.Event = field(
        default_factory=threading.Event)

    def status(self) -> dict:
        out = {"query_id": self.query_id, "tenant": self.tenant,
               "query": self.query, "state": self.state,
               "demotions": self.demotions, "wait_ns": self.wait_ns,
               "dur_ns": self.dur_ns}
        if self.outcome is not None:
            out["outcome"] = self.outcome
        if self.state == STATE_DONE:
            out["result"] = self.result
        if self.error is not None:
            out["error"] = self.error
        if self.hung:
            out["hung"] = True
        if self.cancel_reason is not None:
            out["cancel_reason"] = self.cancel_reason
        return out


class FairShareScheduler:
    """Per-tenant FIFO queues + weighted virtual-time pick.  NOT
    internally locked: the owning server serializes every call under
    its own lock (pick/enqueue/charge must be atomic with the
    server's queued/running bookkeeping anyway)."""

    def __init__(self):
        self._queues: Dict[str, collections.deque] = {}
        self._vruntime: Dict[str, float] = {}

    def enqueue(self, job: Job,
                running_by_tenant: Optional[Dict[str, int]] = None
                ) -> None:
        q = self._queues.setdefault(job.tenant, collections.deque())
        if not q and not (running_by_tenant or {}).get(job.tenant, 0):
            # tenant (re-)arriving from idle: floor its vruntime to
            # the minimum among tenants that are actually ACTIVE
            # (queued or running) — the CFS wakeup rule.  Without
            # this, a tenant that ran early and idled for an hour
            # would return with a stale-low vruntime and monopolize
            # the pool until it "caught up" on service it never
            # asked for; and a brand-new tenant starts at the floor
            # instead of zero for the same reason.
            active = {t for t, qq in self._queues.items() if qq}
            active |= {t for t, n in (running_by_tenant or {}).items()
                       if n > 0}
            active.discard(job.tenant)
            floor = min((self._vruntime.get(t, 0.0) for t in active),
                        default=None)
            if floor is not None:
                self._vruntime[job.tenant] = max(
                    self._vruntime.get(job.tenant, 0.0), floor)
            else:
                self._vruntime.setdefault(job.tenant, 0.0)
            # bounded history: idle tenants' vruntime entries are
            # disposable (a return trip re-floors them right here),
            # so a resident server never accretes rows for tenants
            # long gone
            if len(self._vruntime) > 512:
                idle = [t for t in self._vruntime
                        if not self._queues.get(t)
                        and not (running_by_tenant or {}).get(t, 0)
                        and t != job.tenant]
                for t in idle:
                    del self._vruntime[t]
                    self._queues.pop(t, None)
        q.append(job)

    def remove(self, job: Job) -> bool:
        q = self._queues.get(job.tenant)
        if q is None:
            return False
        try:
            q.remove(job)
            return True
        except ValueError:
            return False

    def queued_total(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def queued_for(self, tenant: str) -> int:
        q = self._queues.get(tenant)
        return len(q) if q else 0

    def pick(self, running_by_tenant: Dict[str, int],
             weight_fn: Callable[[str], float]) -> Optional[Job]:
        """Dequeue the next job under weighted fairness, or None when
        every queue is empty."""
        best_tenant = None
        best_key = None
        for tenant, q in self._queues.items():
            if not q:
                continue
            w = max(weight_fn(tenant), 1e-9)
            score = (self._vruntime.get(tenant, 0.0)
                     + running_by_tenant.get(tenant, 0) / w)
            key = (score, q[0].seq)
            if best_key is None or key < best_key:
                best_tenant, best_key = tenant, key
        if best_tenant is None:
            return None
        return self._queues[best_tenant].popleft()

    def charge(self, tenant: str, cost_s: float, weight: float) -> None:
        """Account completed service (wall seconds / weight)."""
        self._vruntime[tenant] = (self._vruntime.get(tenant, 0.0)
                                  + cost_s / max(weight, 1e-9))

    def deficit(self) -> Dict[str, float]:
        """Weighted service each tenant is behind the most-served
        tenant (0 for the front-runner; bounded = no starvation)."""
        if not self._vruntime:
            return {}
        vmax = max(self._vruntime.values())
        return {t: vmax - v for t, v in self._vruntime.items()}

    def snapshot(self) -> dict:
        return {
            "queued": {t: len(q) for t, q in self._queues.items()
                       if q},
            "vruntime": {t: round(v, 6)
                         for t, v in sorted(self._vruntime.items())},
            "deficit": {t: round(v, 6)
                        for t, v in sorted(self.deficit().items())},
        }
