"""Structured hierarchical tracing: query -> stage -> task -> op spans.

The reference answers "where did this query's time go" with NVTX ranges
around every native op plus a 4.9k-LoC CUPTI profiler streaming a
timeline Nsight can render.  The metrics spine counts things (histograms,
per-task rollups, journal events) but its op brackets are flat and
unparented — it cannot say WHY task 17 was slow, only that it was.
This module adds the missing causality: a process-wide :class:`Tracer`
producing spans with

  * identity      — ``trace_id`` / ``span_id`` / ``parent_id`` (64-bit),
  * time          — monotonic ``t_ns`` start + ``dur_ns``,
  * attribution   — the RmmSpark thread->task binding is consulted at
                    span start, so every span is task-attributed with no
                    per-callsite plumbing,
  * causality     — a per-thread context stack parents each new span
                    under the innermost open one; remote contexts
                    (e.g. carried inside the kudo shuffle wire format)
                    can be activated to re-parent work across threads
                    and processes, and spans can carry ``links`` to
                    other spans' contexts (the shuffle merge links back
                    to every writer span it consumed).

Finished spans land in a bounded ring (a long-lived executor can trace
forever; exports see the most recent ``capacity`` spans plus a drop
count) and are handed to an ``on_finish`` hook — the observability
package points that hook at the EventJournal (span records ride the
same JSONL dump) and at a span-duration histogram in MetricsRegistry
(Prometheus exposition picks up per-op latency distributions for free).

Everything is OFF by default.  When disabled, ``start_span`` returns a
shared no-op span after ONE attribute read — no allocation, no lock —
so the instrumented layers (op_range, kudo, exchange, models) can call
unconditionally.

The module is dependency-free within the package: the task lookup and
the finish hook are injected by ``observability/__init__`` (the same
``enabled_ref`` pattern the journal uses), so tests can build isolated
tracers.
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Union

MAX_ATTRS = 16          # bounded attributes per span
MAX_ATTR_STR = 256      # value strings truncated beyond this
ROOT_PARENT = 0         # parent_id of a trace root


class SpanContext(NamedTuple):
    """The portable identity of a span — what crosses thread, process,
    and shuffle-wire boundaries (16 bytes on the kudo wire)."""

    trace_id: int
    span_id: int


# os.urandom-backed and independent of the global Mersenne Twister:
# forked executor processes (or a test's random.seed) must never
# generate colliding id sequences — the multi-process trace merge in
# tools/trace_export keys spans by span_id across all input files
_ID_RNG = random.SystemRandom()


def _new_id() -> int:
    """Non-zero 64-bit id (0 is the ROOT_PARENT sentinel)."""
    while True:
        v = _ID_RNG.getrandbits(64)
        if v:
            return v


def _clean_attr_value(v):
    """Bound one attribute value (strings truncated, objects repr'd)."""
    if not isinstance(v, (int, float, bool)) and v is not None:
        v = str(v)
        if len(v) > MAX_ATTR_STR:
            v = v[:MAX_ATTR_STR] + "..."
    return v


def _clean_attrs(attrs: Optional[dict]) -> Optional[dict]:
    """Bound attribute count and value size (a runaway attribute dict
    must not make the span ring unbounded in bytes)."""
    if not attrs:
        return None
    out = {}
    for i, (k, v) in enumerate(attrs.items()):
        if i >= MAX_ATTRS:
            out["__attrs_dropped__"] = len(attrs) - MAX_ATTRS
            break
        out[str(k)] = _clean_attr_value(v)
    return out


class Span:
    """One open span.  Context-manager friendly; idempotent ``end``."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "span_kind", "t0_ns", "thread", "task", "attrs",
                 "links", "_attached", "_ended", "_remote", "_stack")

    def __init__(self, tracer: "Tracer", trace_id: int, span_id: int,
                 parent_id: int, name: str, span_kind: str,
                 task, attrs: Optional[dict], attached: bool,
                 remote: bool = False):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.span_kind = span_kind
        self.t0_ns = time.monotonic_ns()
        self.thread = threading.get_ident()
        self.task = task
        self.attrs = attrs
        self.links: List[SpanContext] = []
        self._attached = attached
        self._ended = False
        self._remote = remote
        # the context-stack LIST this span was pushed onto (set by the
        # tracer when attach=True): ending a span from a different
        # thread must pop the ORIGIN thread's stack, not the ender's
        self._stack: Optional[List["Span"]] = None

    # ------------------------------------------------------------ api

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value) -> "Span":
        a = dict(self.attrs) if self.attrs else {}
        dropped = a.pop("__attrs_dropped__", 0)
        key = str(key)
        if key not in a and len(a) >= MAX_ATTRS:
            # evict the OLDEST attribute: a late write (the 'error'
            # marker at span exit, byte counts known only at the end of
            # a shuffle write) carries more signal than the first thing
            # recorded at span start
            del a[next(iter(a))]
            dropped += 1
        a[key] = _clean_attr_value(value)
        if dropped:
            a["__attrs_dropped__"] = dropped
        self.attrs = a
        return self

    def add_link(self, ctx: SpanContext) -> "Span":
        if len(self.links) < 64:  # bounded, like attributes
            self.links.append(SpanContext(*ctx))
        return self

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self.tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            self.set_attr("error", getattr(exc[0], "__name__",
                                           str(exc[0])))
        self.end()

    def __repr__(self):
        return (f"Span({self.name!r} kind={self.span_kind} "
                f"trace={self.trace_id:016x} span={self.span_id:016x})")


class _NoopSpan:
    """Returned when tracing is disabled: absorbs the whole Span API."""

    __slots__ = ()
    trace_id = span_id = parent_id = 0
    name = span_kind = ""
    links = ()

    @property
    def context(self):
        return None

    def set_attr(self, key, value):
        return self

    def add_link(self, ctx):
        return self

    def end(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NOOP_SPAN = _NoopSpan()


class _ThreadStack(threading.local):
    def __init__(self):
        self.stack: List[Span] = []


class Tracer:
    """Process-wide span factory + bounded finished-span ring.

    ``task_lookup``: zero-arg callable returning the current thread's
    task-id list (observability wires it to ``TASKS.tasks_for``); None
    leaves spans task-less.  ``on_finish``: called with each finished
    span's record dict (observability wires journal + histogram)."""

    def __init__(self, capacity: int = 65536,
                 task_lookup: Optional[Callable[[], list]] = None,
                 on_finish: Optional[Callable[[dict], None]] = None):
        self.enabled = False
        self.capacity = capacity
        self.task_lookup = task_lookup
        self.on_finish = on_finish
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._ctx = _ThreadStack()

    # ------------------------------------------------------ span start

    def start_span(self, name: str, kind: str = "op",
                   attrs: Optional[dict] = None,
                   parent: Union[Span, SpanContext, None] = None,
                   attach: bool = True):
        """Open a span.  Parent resolution: explicit ``parent`` wins,
        else the innermost open span on this thread, else a fresh trace
        root.  ``attach=False`` records the span without putting it on
        the thread's context stack (episodes that may close out of
        order, e.g. OOM block/unblock)."""
        if not self.enabled:
            return NOOP_SPAN
        stack = self._ctx.stack
        if parent is None and stack:
            parent = stack[-1]
        if parent is None:
            trace_id, parent_id = _new_id(), ROOT_PARENT
        elif isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:  # SpanContext (or any (trace_id, span_id) pair)
            trace_id, parent_id = parent[0], parent[1]
        task = None
        if self.task_lookup is not None:
            try:
                ids = self.task_lookup()
                if ids:
                    task = ids[0] if len(ids) == 1 else list(ids)
            except Exception:
                task = None
        span = Span(self, trace_id, _new_id(), parent_id, name, kind,
                    task, _clean_attrs(attrs), attach)
        if attach:
            span._stack = stack
            stack.append(span)
        return span

    def span(self, name: str, kind: str = "op",
             attrs: Optional[dict] = None,
             parent: Union[Span, SpanContext, None] = None):
        """``with tracer.span(...)`` sugar (start_span is the long
        form; both return the Span which is its own context manager)."""
        return self.start_span(name, kind=kind, attrs=attrs,
                               parent=parent)

    # --------------------------------------------------------- context

    def current_context(self) -> Optional[SpanContext]:
        """The innermost open span's context on this thread (what the
        kudo writer embeds in the wire header), or None."""
        stack = self._ctx.stack
        return stack[-1].context if stack else None

    def activate(self, ctx: Optional[SpanContext]):
        """Adopt a remote context as this thread's current parent for
        the duration of the ``with`` block — the shuffle-read side uses
        this to re-parent its spans under the writing task's span.  A
        None ctx (or disabled tracer) is a no-op placeholder so callers
        never branch."""
        if not self.enabled or ctx is None:
            return NOOP_SPAN
        span = Span(self, ctx[0], ctx[1], ROOT_PARENT, "<remote>",
                    "remote", None, None, attached=True, remote=True)
        # a remote placeholder reuses the remote span's OWN id as its
        # span_id so children parent directly to the remote span
        span._stack = self._ctx.stack
        span._stack.append(span)
        return span

    # ---------------------------------------------------------- finish

    def _finish(self, span: Span) -> None:
        stack = span._stack
        if stack is not None:
            # tolerate out-of-order (and cross-thread) ends: remove the
            # span from the stack it was PUSHED onto, wherever it sits
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is span:
                    del stack[i]
                    break
        if span._remote:
            return  # placeholder: nothing to record
        rec = {
            "kind": "span",
            "name": span.name,
            "span_kind": span.span_kind,
            "trace_id": f"{span.trace_id:016x}",
            "span_id": f"{span.span_id:016x}",
            "parent_id": (f"{span.parent_id:016x}"
                          if span.parent_id else None),
            "t_ns": span.t0_ns,
            "dur_ns": time.monotonic_ns() - span.t0_ns,
            "thread": span.thread,
        }
        if span.task is not None:
            rec["task"] = span.task
        if span.attrs:
            rec["attrs"] = span.attrs
        if span.links:
            rec["links"] = [{"trace_id": f"{c.trace_id:016x}",
                             "span_id": f"{c.span_id:016x}"}
                            for c in span.links]
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(rec)
        hook = self.on_finish
        if hook is not None:
            try:
                hook(rec)
            except Exception:
                pass  # exporters must never break the traced code path

    # ------------------------------------------------------------ read

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def drain(self) -> List[Dict]:
        """Return AND clear the finished-span ring (the flush verb the
        shim's ``tracing_flush`` uses between export intervals)."""
        with self._lock:
            recs = list(self._ring)
            self._ring.clear()
            return recs

    def requeue(self, recs: List[Dict]) -> None:
        """Put drained records back AHEAD of anything recorded since —
        a failed flush (disk full mid-write) must not lose spans.  If
        the combined set overflows capacity, the oldest fall off and
        are counted dropped, like any ring append."""
        with self._lock:
            total = recs + list(self._ring)
            overflow = len(total) - self._ring.maxlen
            if overflow > 0:
                self._dropped += overflow
            self._ring.clear()
            self._ring.extend(total)  # deque(maxlen) keeps the newest

    def depth(self) -> int:
        """Open-span depth on the calling thread (tests)."""
        return len(self._ctx.stack)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    # ------------------------------------------------------------ dump

    def dump_jsonl(self, path_or_file) -> int:
        """Write the finished-span ring as JSON Lines (one process's
        input file for tools/trace_export.py).  Path writes are atomic
        (tmp + rename).  Returns record count."""
        from spark_rapids_tpu_torch.observability.dumpio import dump_via

        recs = self.records()

        def _write(f):
            for r in recs:
                f.write(json.dumps(r) + "\n")
            return len(recs)

        return dump_via(path_or_file, _write)
