"""Admission control for the multi-tenant query server.

Admission is the *only* place load is refused; everything past it is
scheduling and (worst case) load-shedding.  Three checks run at submit
time, cheapest first, and every refusal is a **typed**
:class:`ServerOverloaded` carrying the reason and a retry-after hint —
callers (and the socket front door) can distinguish "back off and
retry" from a real failure:

  * ``queue_full``      — the server-wide admitted-but-not-running
    backlog reached ``max_queue`` (queue-depth backpressure: the
    device is not keeping up, nobody gets to pile on more);
  * ``tenant_inflight`` — THIS tenant reached its in-flight quota
    (queued + running); neighbors are unaffected;
  * ``tenant_bytes``    — the tenant's live tasks already hold more
    device bytes (the memory-ledger fold) than its quota allows;
    admitting more work would let one tenant OOM its neighbors.

Quotas are per-tenant :class:`TenantQuota` rows (defaults from the
server config / ``SPARK_RAPIDS_TPU_SERVER_*`` env knobs); ``weight``
also feeds the fair-share scheduler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from spark_rapids_tpu_torch.analysis.lockdep import make_lock

REASON_QUEUE_FULL = "queue_full"
REASON_TENANT_INFLIGHT = "tenant_inflight"
REASON_TENANT_BYTES = "tenant_bytes"
REASON_SHUTDOWN = "shutdown"
# lifeguard refusals: the server is healthy, but THIS
# submission is refused — the signature is circuit-broken, or the
# server is gracefully draining for restart
REASON_QUARANTINED = "quarantined"
REASON_DRAINING = "draining"


class ServerOverloaded(Exception):
    """Typed backpressure response: the submission was refused, the
    server is healthy, and ``retry_after_s`` is the polite resubmit
    hint (grows with backlog depth)."""

    def __init__(self, reason: str, tenant: str, detail: str = "",
                 retry_after_s: float = 0.0):
        self.reason = reason
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        msg = f"server overloaded ({reason}) for tenant {tenant!r}"
        if detail:
            msg += f": {detail}"
        if retry_after_s > 0:
            msg += f" (retry after {retry_after_s:.3f}s)"
        super().__init__(msg)

    def to_dict(self) -> dict:
        return {"type": "ServerOverloaded", "reason": self.reason,
                "tenant": self.tenant,
                "retry_after_s": self.retry_after_s,
                "message": str(self)}


@dataclass
class TenantQuota:
    """Per-tenant admission limits + scheduler weight.

    ``max_inflight``      — queued + running jobs (0 = unlimited);
    ``max_device_bytes``  — device bytes the tenant's live tasks may
                            hold before new admissions bounce
                            (0 = unlimited);
    ``weight``            — fair-share weight (2.0 = entitled to twice
                            the service of a weight-1.0 tenant)."""

    max_inflight: int = 0
    max_device_bytes: int = 0
    weight: float = 1.0


class AdmissionController:
    """Quota table + the admission predicate.  Counts are supplied by
    the server under its own lock — this class holds no job state, so
    it can be unit-tested as a pure policy."""

    def __init__(self, max_queue: int,
                 default_quota: Optional[TenantQuota] = None):
        self.max_queue = int(max_queue)
        self.default_quota = default_quota or TenantQuota()
        self._quotas: Dict[str, TenantQuota] = {}
        self._lock = make_lock("server.admission")

    def set_quota(self, tenant: str, *, max_inflight: int = -1,
                  max_device_bytes: int = -1,
                  weight: float = -1.0) -> TenantQuota:
        """Create/update a tenant's quota; negative values keep the
        current (or default) setting."""
        with self._lock:
            cur = self._quotas.get(tenant)
            if cur is None:
                d = self.default_quota
                cur = TenantQuota(d.max_inflight, d.max_device_bytes,
                                  d.weight)
                self._quotas[tenant] = cur
            if max_inflight >= 0:
                cur.max_inflight = int(max_inflight)
            if max_device_bytes >= 0:
                cur.max_device_bytes = int(max_device_bytes)
            if weight >= 0:
                cur.weight = float(weight)
            return cur

    def quota_for(self, tenant: str) -> TenantQuota:
        with self._lock:
            return self._quotas.get(tenant, self.default_quota)

    def weight_for(self, tenant: str) -> float:
        return max(self.quota_for(tenant).weight, 1e-9)

    def quotas(self) -> Dict[str, TenantQuota]:
        with self._lock:
            return dict(self._quotas)

    # ------------------------------------------------------- predicate

    def retry_after(self, queued_total: int) -> float:
        """Backpressure hint: deeper backlog, longer pause (bounded —
        a hint, not a lease)."""
        return round(min(0.01 * (queued_total + 1), 2.0), 3)

    def check(self, tenant: str, *, queued_total: int,
              tenant_inflight: int, tenant_device_bytes: int) -> None:
        """Raise :class:`ServerOverloaded` if this submission must be
        refused; return silently when it may be admitted."""
        if self.max_queue > 0 and queued_total >= self.max_queue:
            raise ServerOverloaded(
                REASON_QUEUE_FULL, tenant,
                f"{queued_total} queued >= max_queue {self.max_queue}",
                retry_after_s=self.retry_after(queued_total))
        q = self.quota_for(tenant)
        if q.max_inflight > 0 and tenant_inflight >= q.max_inflight:
            raise ServerOverloaded(
                REASON_TENANT_INFLIGHT, tenant,
                f"{tenant_inflight} in flight >= quota "
                f"{q.max_inflight}",
                retry_after_s=self.retry_after(queued_total))
        if q.max_device_bytes > 0 \
                and tenant_device_bytes >= q.max_device_bytes:
            raise ServerOverloaded(
                REASON_TENANT_BYTES, tenant,
                f"{tenant_device_bytes} device bytes held >= quota "
                f"{q.max_device_bytes}",
                retry_after_s=self.retry_after(queued_total))
