"""Task-level retry drivers (reference: the plugin's
``RmmRapidsRetryIterator`` — ``withRetry`` / ``withRetryNoSplit`` /
``withRestoreOnRetry`` over ``RmmSpark.blockThreadUntilReady``).

Four drivers, one shared episode bookkeeping:

  * :func:`with_retry`        — re-run a recomputable section on
    ``GpuRetryOOM``/``CpuRetryOOM``/``CudfException`` (and, because a
    pure recompute is always a valid "split" of itself, on
    ``GpuSplitAndRetryOOM`` too), restoring checkpointed state between
    attempts.
  * :func:`with_retry_no_split` — same, but split-and-retry OOMs
    ESCALATE to the caller (something above owns a real splitter).
  * :func:`split_and_retry`   — process a batch; a split-and-retry OOM
    halves the batch via ``batch_splitter`` and the halves are
    processed depth-first (each may split again) down to a
    one-element floor, then :class:`RetryExhausted` carries the
    attempt history.
  * :func:`with_collective_retry` — :func:`with_retry` for a section
    every rank of a process group runs in lockstep: the ranks agree at
    each attempt's start, so they retry or return together.

Every attempt starts by cooperating with the OOM state machine
(``SparkResourceAdaptor.block_thread_until_ready`` — a BUFN'd thread
parks here until memory frees) and by polling the forced-OOM hooks
(``RmmSpark.force_retry_oom`` and friends), so injected faults fire
even for compute-only sections that never allocate.  Failed attempts
back off exponentially under a bounded-attempts + wall-clock-deadline
policy.  The drivers make no torch call: what an attempt runs on the
device is the caller's.

Episodes that saw at least one failure fold into the observability
spine: ``srt_retry_*`` counters, a ``retry_episode`` journal event,
and a ``retry``-kind span (attach=False — it never re-parents the
traced work under it).  A zero-failure episode records nothing.

An exhausted budget freezes a ``retry_exhausted`` incident bundle
when the flight recorder is armed.

Every attempt start beats the lifeguard's heartbeat
(``robustness/lifeguard.beat``) and polls the injection hooks (forced
OOMs from ``RmmSpark.force_retry_oom`` and the fault injector's rules,
``utils/fault_injection.maybe_inject``), so injected faults fire even
for compute-only sections that never allocate.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.memory import exceptions as exc
from spark_rapids_tpu_torch.utils import fault_injection as _fi
from spark_rapids_tpu_torch.robustness import lifeguard as _lifeguard

# what the drivers recover from (reference catch set: RetryOOM,
# SplitAndRetryOOM, CudfException — GpuOOM/OffHeapOOM stay terminal)
RETRYABLE = (exc.RetryOOMBase, exc.CudfException)
SPLITTABLE = (exc.SplitAndRetryOOMBase,)

# exception types that are TERMINAL even if they land inside the
# retryable catch set (e.g. a subclass of CudfException raised for
# deterministic input corruption): layers register theirs at import —
# io/page_decode.ParquetDecodeException is the canonical case, since
# re-reading a corrupt page yields the same bytes forever (A13 here).
NON_RETRYABLE: Tuple[type, ...] = ()


def register_non_retryable(*exc_types: type) -> None:
    """Declare exception types the drivers must escalate immediately
    (idempotent; isinstance-checked before every retry decision)."""
    global NON_RETRYABLE
    merged = dict.fromkeys(NON_RETRYABLE)
    merged.update(dict.fromkeys(exc_types))
    NON_RETRYABLE = tuple(merged)


def _is_non_retryable(e: BaseException) -> bool:
    return isinstance(e, NON_RETRYABLE)


def is_retryable(e: BaseException) -> bool:
    """Whether the drivers re-run a section that raised ``e``."""
    return (isinstance(e, RETRYABLE + SPLITTABLE)
            and not _is_non_retryable(e))


@dataclass
class Attempt:
    """One failed attempt inside an episode (the history
    :class:`RetryExhausted` carries)."""

    index: int          # 0-based attempt number within the episode
    kind: str           # "retry" | "split"
    error: str          # exception class name
    message: str
    elapsed_ns: int     # time this attempt burned before failing
    split_depth: int = 0
    batch_size: Optional[int] = None


class RetryExhausted(Exception):
    """Terminal: the retry budget (attempts, deadline, or the
    one-element split floor) ran out.  ``attempts`` is the full
    failure history; ``last`` is the exception that ended it."""

    def __init__(self, name: str, reason: str, attempts: List[Attempt],
                 last: Optional[BaseException] = None):
        self.name = name
        self.reason = reason
        self.attempts = list(attempts)
        self.last = last
        errs = ",".join(a.error for a in self.attempts[-4:])
        super().__init__(
            f"retry exhausted in {name!r} ({reason}) after "
            f"{len(self.attempts)} failed attempts [..{errs}]")


class SplitFloorReached(RetryExhausted):
    """Terminal at the ONE-ELEMENT split floor specifically: the batch
    cannot shrink further, so more splitting is pointless — a
    different failure from a spent attempt/deadline budget, and
    doctor/server treat it differently (the fix is spilling or a
    bigger device, not more retries).  Carries the resident-bytes
    evidence snapshot (per-task active bytes from the memory ledger at
    raise time) so the bundle shows WHO was holding device memory when
    the floor was hit."""

    def __init__(self, name: str, attempts: List[Attempt],
                 last: Optional[BaseException] = None,
                 resident_bytes: Optional[dict] = None):
        super().__init__(name, "split_floor", attempts, last)
        self.resident_bytes = dict(resident_bytes or {})

    @staticmethod
    def ledger_snapshot() -> dict:
        """{task_id(str): active_bytes} plus ``__total__`` from the
        installed adaptor's ledger; empty with no memory runtime."""
        adaptor = _installed_adaptor()
        if adaptor is None:
            return {}
        try:
            led = adaptor.memory_ledger(timeline=0)
        except Exception:
            return {}
        out = {str(tid): int(row.get("active_bytes", 0))
               for tid, row in (led.get("tasks") or {}).items()}
        out["__total__"] = int(led.get("allocated_bytes", 0))
        return out


@dataclass
class RetryPolicy:
    """Bounds one episode.  ``sleep``, ``clock``, and ``rng`` are
    injectable for deterministic tests; backoff is exponential from
    ``base_backoff_s`` with a cap, deadline is wall-clock over the
    WHOLE episode (splits included).

    ``jitter=True`` (the default) applies DECORRELATED jitter: each
    pause is drawn uniformly from ``[base, 3 * previous_pause]`` and
    capped at ``max_backoff_s``.  Deterministic exponential backoff
    synchronizes retry storms — N tenants OOMing off the same pressure
    spike all come back at exactly base*2^k and collide again; jitter
    decorrelates the herd (the AWS "decorrelated jitter" scheme).
    Callers that cannot thread the previous pause through still get
    jitter around the deterministic schedule."""

    max_attempts: int = 8
    base_backoff_s: float = 0.001
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 0.25
    deadline_s: Optional[float] = None
    jitter: bool = True
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    rng: Callable[[], float] = field(default=random.random)

    def backoff_for(self, failed_attempts: int,
                    prev_backoff_s: Optional[float] = None) -> float:
        if failed_attempts <= 0 or self.base_backoff_s <= 0:
            return 0.0
        det = min(self.base_backoff_s
                  * self.backoff_multiplier ** (failed_attempts - 1),
                  self.max_backoff_s)
        if not self.jitter:
            return det
        # decorrelated jitter: U(base, 3*prev), capped.  Stateless
        # callers (no prev) jitter around the deterministic value for
        # this attempt count instead.
        prev = (prev_backoff_s
                if prev_backoff_s is not None and prev_backoff_s > 0
                else det)
        lo = self.base_backoff_s
        hi = max(lo, 3.0 * prev)
        return min(self.max_backoff_s, lo + (hi - lo) * self.rng())


DEFAULT_POLICY = RetryPolicy()


def _installed_adaptor():
    """The installed SparkResourceAdaptor, or None — the drivers must
    work with no memory runtime at all (plain library use)."""
    from spark_rapids_tpu_torch.memory import rmm_spark
    return rmm_spark.installed_adaptor()


def check_injected_oom(name: str) -> None:
    """Attempt-start hook: consume pending forced OOMs
    (``force_retry_oom``/``force_split_and_retry_oom``/
    ``force_cudf_exception``) for the current thread and run the
    fault-injector rules against ``name`` — so injected faults fire
    even for compute-only sections that never touch the allocator
    (reference ``RmmSpark.forceRetryOOM`` semantics)."""
    adaptor = _installed_adaptor()
    if adaptor is not None:
        poll = getattr(adaptor, "check_injected_oom", None)
        if poll is not None:
            poll()
    _fi.maybe_inject(name)


class _Episode:
    """Shared per-invocation bookkeeping for all three drivers."""

    __slots__ = ("name", "policy", "t0", "attempt_t0", "attempts",
                 "history", "max_split_depth", "span", "last_exc",
                 "last_backoff")

    def __init__(self, name: str, policy: Optional[RetryPolicy]):
        self.name = name
        self.policy = policy or DEFAULT_POLICY
        self.t0 = self.policy.clock()
        self.attempt_t0 = time.monotonic_ns()
        self.attempts = 0              # total attempts started
        self.history: List[Attempt] = []
        self.max_split_depth = 0
        self.last_exc: Optional[BaseException] = None
        self.last_backoff = 0.0
        # attach=False: the episode span must never become the traced
        # work's parent; it is simply DISCARDED (never ended) when no
        # failure happened
        self.span = _obs.TRACER.start_span(
            f"retry_episode:{name}", kind="retry", attach=False)

    def before_attempt(self) -> None:
        """Runs INSIDE the driver's try: anything raised here counts
        as this attempt's failure."""
        self.attempts += 1
        self.attempt_t0 = time.monotonic_ns()
        # sign of life for the hung-worker watchdog: every attempt
        # start counts, so a query grinding through a long retry
        # episode is "slow", never "hung"
        _lifeguard.beat(f"retry:{self.name}")
        adaptor = _installed_adaptor()
        if adaptor is not None:
            block = getattr(adaptor, "block_thread_until_ready", None)
            if block is not None:
                block()
        check_injected_oom(self.name)

    def note_failure(self, e: BaseException, kind: str,
                     split_depth: int = 0,
                     batch_size: Optional[int] = None) -> Attempt:
        a = Attempt(index=self.attempts - 1, kind=kind,
                    error=type(e).__name__, message=str(e)[:200],
                    elapsed_ns=time.monotonic_ns() - self.attempt_t0,
                    split_depth=split_depth, batch_size=batch_size)
        self.history.append(a)
        self.max_split_depth = max(self.max_split_depth, split_depth)
        self.last_exc = e
        return a

    def pause(self) -> None:
        """Between attempts: deadline check, then exponential backoff."""
        pol = self.policy
        if pol.deadline_s is not None and \
                pol.clock() - self.t0 >= pol.deadline_s:
            # chain the failure that ate the budget — .last and the
            # traceback must survive for triage, as on the attempts
            # path
            raise self.exhausted("deadline",
                                 self.last_exc) from self.last_exc
        backoff = pol.backoff_for(len(self.history),
                                  self.last_backoff)
        self.last_backoff = backoff
        if backoff > 0:
            pol.sleep(backoff)

    def exhausted(self, reason: str,
                  last: Optional[BaseException] = None) -> RetryExhausted:
        if reason == "split_floor":
            # distinct type + resident-bytes evidence: "can't split
            # further" is actionable (spill / bigger device), "budget
            # exhausted" is not the same story
            ex: RetryExhausted = SplitFloorReached(
                self.name, self.history, last,
                resident_bytes=SplitFloorReached.ledger_snapshot())
        else:
            ex = RetryExhausted(self.name, reason, self.history, last)
        if last is not None and ex.__cause__ is None:
            ex.__cause__ = last
        self.finish("exhausted:" + reason)
        # black-box trigger: an exhausted budget is terminal for the
        # query — freeze the evidence while it is still in the rings
        _obs.trigger_incident(
            "retry_exhausted", cause=ex, name=self.name, reason=reason,
            attempts=self.attempts,
            lost_ns=sum(a.elapsed_ns for a in self.history),
            errors=[a.error for a in self.history[-16:]])
        return ex

    def finish(self, outcome: str) -> None:
        """Fold the episode into metrics/journal/tracer — only when a
        failure actually happened (zero-failure episodes leave no
        trace, so the hot path is unchanged)."""
        if not self.history:
            return
        lost_ns = sum(a.elapsed_ns for a in self.history)
        splits = sum(1 for a in self.history if a.kind == "split")
        _obs.record_retry_episode(
            self.name, attempts=self.attempts,
            retries=len(self.history) - splits, splits=splits,
            max_split_depth=self.max_split_depth, lost_ns=lost_ns,
            outcome=outcome,
            errors=[a.error for a in self.history])
        span = self.span
        span.set_attr("attempts", self.attempts)
        span.set_attr("splits", splits)
        span.set_attr("max_split_depth", self.max_split_depth)
        span.set_attr("lost_ns", lost_ns)
        span.set_attr("outcome", outcome)
        span.end()


def with_retry(fn: Callable, *args, name: Optional[str] = None,
               checkpoint: Optional[Callable[[], Any]] = None,
               restore: Optional[Callable[[Any], None]] = None,
               policy: Optional[RetryPolicy] = None,
               split_escalates: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the retry contract.

    ``checkpoint`` (zero-arg) is called ONCE before the first attempt
    and its result is handed to ``restore(state)`` after every failed
    attempt, so stateful sections re-enter pristine (the
    ``withRestoreOnRetry`` contract).  ``split_escalates=True`` lets
    ``GpuSplitAndRetryOOM`` propagate instead of degrading to a plain
    recompute — use it when a real splitter exists above.

    The driver's control kwargs (``name``/``checkpoint``/``restore``/
    ``policy``/``split_escalates``) share the keyword namespace with
    ``fn``'s — if ``fn`` takes a kwarg by one of those names, bind it
    in a closure/partial instead of passing it through."""
    ep = _Episode(name or getattr(fn, "__name__", "section"), policy)
    state = checkpoint() if checkpoint is not None else None
    while True:
        try:
            ep.before_attempt()
            out = fn(*args, **kwargs)
            ep.finish("success")
            return out
        except RETRYABLE as e:
            if _is_non_retryable(e):
                if ep.history:
                    ep.note_failure(e, "escalate")
                    ep.finish("error")
                raise
            ep.note_failure(e, "retry")
            last = e
        except SPLITTABLE as e:
            if split_escalates:
                ep.note_failure(e, "escalate")
                ep.finish("escalated")
                raise
            # no splitter here and fn is recomputable: a full re-run
            # IS a (degenerate) split of the input
            ep.note_failure(e, "retry")
            last = e
        except BaseException as e:
            # non-retryable escape: an episode that already retried
            # must still fold into the spine before propagating (a
            # clean first-attempt crash records nothing, as ever)
            if ep.history:
                ep.note_failure(e, "escalate")
                ep.finish("error")
            raise
        if restore is not None:
            restore(state)
        if len(ep.history) >= ep.policy.max_attempts:
            raise ep.exhausted("attempts", last) from last
        ep.pause()


def with_collective_retry(fn: Callable, agree: Callable[[bool], bool], *,
                          name: Optional[str] = None,
                          policy: Optional[RetryPolicy] = None):
    """:func:`with_retry` for a section that every rank of a process
    group runs in lockstep (the mesh steps of models/tpcds and
    models/query).  ``agree(flag)`` returns True on every rank when
    ``flag`` is True on any (an all-reduce MAX over the group).

    Each attempt starts as :func:`with_retry`'s does (the adaptor's
    block, the injection hooks) on this rank; then the ranks agree, so
    when any rank failed its start every rank records the attempt and
    retries, before ``fn`` issued a collective: no rank re-runs a
    collective alone.  The budget (attempts, deadline) is agreed the
    same way.  A failure inside ``fn()`` propagates: a rank that stops
    between two collectives cannot re-enter them alone (its peers wait
    in the next one), so the group's owner re-runs the whole call on
    fresh ranks (shim/jni_mesh.run_entry)."""
    ep = _Episode(name or getattr(fn, "__name__", "section"), policy)
    pol = ep.policy
    while True:
        failed: Optional[BaseException] = None
        try:
            ep.before_attempt()
        except RETRYABLE + SPLITTABLE as e:
            if _is_non_retryable(e):
                raise
            failed = e
        if not agree(failed is not None):
            try:
                out = fn()
            except BaseException as e:
                if ep.history:
                    ep.note_failure(e, "escalate")
                    ep.finish("error")
                raise
            ep.finish("success")
            return out
        last = failed or exc.GpuRetryOOM(
            f"{ep.name}: a peer rank's attempt failed at its start")
        ep.note_failure(last, "retry")
        spent = len(ep.history) >= pol.max_attempts
        late = (pol.deadline_s is not None
                and pol.clock() - ep.t0 >= pol.deadline_s)
        if agree(spent or late):
            raise ep.exhausted("attempts" if spent else "deadline",
                               last) from last
        backoff = pol.backoff_for(len(ep.history), ep.last_backoff)
        ep.last_backoff = backoff
        if backoff > 0:
            pol.sleep(backoff)


def with_retry_no_split(fn: Callable, *args, **kwargs):
    """:func:`with_retry` with split-and-retry OOMs escalating to the
    caller (reference ``withRetryNoSplit``)."""
    kwargs["split_escalates"] = True
    return with_retry(fn, *args, **kwargs)


def halve_batch(batch: Sequence) -> Tuple[Sequence, Sequence]:
    """Default splitter: halve any sliceable batch.  Raises on
    one-element batches — the driver turns that into the terminal
    :class:`RetryExhausted` (the one-row floor)."""
    n = len(batch)
    if n < 2:
        raise ValueError("cannot split a batch of size " + str(n))
    mid = (n + 1) // 2
    return batch[:mid], batch[mid:]


def split_and_retry(fn: Callable[[Sequence], Any], batch: Sequence, *,
                    batch_splitter: Callable = halve_batch,
                    combine: Optional[Callable[[List[Any]], Any]] = None,
                    min_size: int = 1,
                    name: Optional[str] = None,
                    policy: Optional[RetryPolicy] = None):
    """Process ``batch`` with ``fn``; on ``GpuSplitAndRetryOOM`` the
    failing part is split via ``batch_splitter`` and the parts are
    processed depth-first (each may split again) until parts reach
    ``min_size`` — a failure there raises :class:`RetryExhausted`.
    Plain retryable OOMs re-run the SAME part under the policy's
    attempt budget.  Per-part results are combined with
    ``combine(results)`` (default: the raw in-order result list).

    Splitter contract: ``batch_splitter(part) -> (left, right)`` with
    ``left + right`` order-equivalent to ``part`` — results are
    combined in order, so a conforming splitter makes the split run
    byte-identical to the unsplit one."""
    ep = _Episode(name or getattr(fn, "__name__", "batch"), policy)
    pending: List[Tuple[Sequence, int]] = [(batch, 0)]
    results: List[Any] = []
    part_failures = 0  # consecutive plain-retry failures on one part
    while pending:
        part, depth = pending[0]
        try:
            ep.before_attempt()
            results.append(fn(part))
            pending.pop(0)
            part_failures = 0
            continue
        except RETRYABLE as e:
            if _is_non_retryable(e):
                if ep.history:
                    ep.note_failure(e, "escalate")
                    ep.finish("error")
                raise
            part_failures += 1
            ep.note_failure(e, "retry", split_depth=depth,
                            batch_size=len(part))
            if part_failures >= ep.policy.max_attempts:
                raise ep.exhausted("attempts", e) from e
        except SPLITTABLE as e:
            ep.note_failure(e, "split", split_depth=depth + 1,
                            batch_size=len(part))
            if len(part) <= min_size:
                raise ep.exhausted("split_floor", e) from e
            try:
                left, right = batch_splitter(part)
            except BaseException:
                ep.finish("error")   # splitter bug: fold, then raise
                raise
            pending[0:1] = [(left, depth + 1), (right, depth + 1)]
            part_failures = 0
        except BaseException as e:
            # non-retryable escape mid-batch (see with_retry)
            if ep.history:
                ep.note_failure(e, "escalate")
                ep.finish("error")
            raise
        ep.pause()
    ep.finish("success")
    return combine(results) if combine is not None else results
