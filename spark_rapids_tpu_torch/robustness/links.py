"""Link-level failure handling for the distributed shuffle.

The task-level drivers in :mod:`robustness.retry` recover a COMPUTE
section from OOM-flavored throws; a shuffle link fails differently: a
peer NAKs a CRC-corrupt payload, a connection resets mid-send, an ack
times out.  Those are transient (the payload is still in hand; resend
it) right up until they are not (the peer process is dead).  This
module is that judgement call, built on the SAME
:class:`~spark_rapids_tpu_torch.robustness.retry.RetryPolicy` (bounded
attempts, decorrelated-jitter backoff, wall-clock deadline) so link
retries and OOM retries share one tuning vocabulary:

  * :class:`ShuffleLinkError`: one attempt failed for a reason a
    resend can fix (NAK, reconnect, timeout).  ``reason`` names it.
  * :class:`PeerDiedException`: terminal, the retry budget ran out (or
    the listener reported the peer gone).  Carries the peer, the
    attempt count, and the last transport error.
  * :func:`with_link_retry`: the driver.  Run one send attempt,
    classify, back off, resend.  ``LINK_STATS`` counts the failed
    attempts by reason; each failed attempt also bumps
    ``srt_shuffle_link_retries_total`` and an episode that saw a
    failure lands in the retry journal (observability).

Corrupt-stream handling on the RECEIVE side stays in the kudo reader
(KCRC verify + resync, shuffle/kudo.py); the receiving transport turns
a corrupt payload into a NAK so the SENDER's copy of this driver
resends clean bytes: re-reading a corrupt socket buffer yields the
same garbage forever, but the sender's buffer is intact.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, TypeVar

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.robustness.retry import RetryPolicy

T = TypeVar("T")


class ShuffleLinkError(RuntimeError):
    """One shuffle-link attempt failed transiently.  ``reason`` in
    {'nak', 'link'}: 'nak' means the peer received bytes but its CRC
    verifier refused them; 'link' is any connect/send/ack transport
    failure."""

    def __init__(self, msg: str, reason: str = "link"):
        super().__init__(msg)
        self.reason = reason


class PeerDiedException(RuntimeError):
    """Terminal: a peer stayed unreachable (or kept NAKing) past the
    link retry budget.  The distributed driver treats this as the
    query's failure on this worker: there is no one left to resend
    to."""

    def __init__(self, peer, attempts: int,
                 last: Optional[BaseException] = None,
                 detail: str = ""):
        self.peer = str(peer)
        self.attempts = attempts
        self.last = last
        super().__init__(
            f"peer {peer} unreachable after {attempts} link attempts"
            + (f": {detail}" if detail else "")
            + (f" (last: {type(last).__name__}: {last})"
               if last is not None else ""))


# transport failures a resend can fix: our typed attempt error plus
# the OS-level socket family (ConnectionError, socket.timeout, and
# plain OSError from a half-closed unix socket all subclass OSError)
TRANSIENT = (ShuffleLinkError, OSError)

DEFAULT_LINK_POLICY = RetryPolicy(max_attempts=5, base_backoff_s=0.02,
                                  max_backoff_s=0.5, deadline_s=30.0)

# failed link attempts by reason, and link episodes that gave up
LINK_STATS = {"nak": 0, "link": 0, "exhausted": 0}
_STATS_LOCK = threading.Lock()


def _reason_of(e: BaseException) -> str:
    if isinstance(e, ShuffleLinkError):
        return e.reason
    return "link"


def _count(key: str) -> None:
    with _STATS_LOCK:
        LINK_STATS[key] += 1


def with_link_retry(attempt: Callable[[], T], *, peer,
                    name: str = "shuffle_link",
                    policy: Optional[RetryPolicy] = None) -> T:
    """Run one link ``attempt`` under the policy's bounded resend loop.
    Transient failures (:data:`TRANSIENT`) back off with decorrelated
    jitter and resend; budget exhaustion (attempts or deadline) raises
    :class:`PeerDiedException`.  Anything else escalates untouched.
    Each failed attempt is counted (``srt_shuffle_link_retries_total``)
    and an episode that saw a failure is journalled under ``name``."""
    pol = policy or DEFAULT_LINK_POLICY
    t0 = pol.clock()
    failures = 0
    lost_ns = 0
    prev_backoff = 0.0
    errors = []
    while True:
        attempt_t0 = time.monotonic_ns()
        try:
            out = attempt()
            if failures:
                _obs.record_retry_episode(
                    name, attempts=failures + 1, retries=failures,
                    splits=0, max_split_depth=0, lost_ns=lost_ns,
                    outcome="success", errors=errors)
            return out
        except TRANSIENT as e:
            failures += 1
            lost_ns += time.monotonic_ns() - attempt_t0
            errors.append(type(e).__name__)
            _count(_reason_of(e))
            _obs.record_shuffle_link_retry(peer, _reason_of(e))
            deadline_hit = (pol.deadline_s is not None
                            and pol.clock() - t0 >= pol.deadline_s)
            if failures >= pol.max_attempts or deadline_hit:
                _count("exhausted")
                _obs.record_retry_episode(
                    name, attempts=failures, retries=failures,
                    splits=0, max_split_depth=0, lost_ns=lost_ns,
                    outcome="exhausted:deadline" if deadline_hit
                    else "exhausted:attempts", errors=errors)
                raise PeerDiedException(
                    peer, failures, last=e,
                    detail="deadline" if deadline_hit
                    else "attempts") from e
            backoff = pol.backoff_for(failures, prev_backoff)
            prev_backoff = backoff
            if backoff > 0:
                pol.sleep(backoff)
