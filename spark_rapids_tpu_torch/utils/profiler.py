"""In-process profiler (reference profiler/ 4.9k LoC: CUPTI activity ->
flatbuffers -> JVM DataWriter callback, Profiler.java:36-120 control
surface + NVTX ranges in every op).

Port mapping: device tracing goes through ``torch.profiler`` (its
Chrome trace is what Nsight's timeline shows for the reference); every
op range is a ``torch.profiler.record_function`` annotation and, on a
machine with a card, an NVTX range (``torch.cuda.nvtx``), so both
profilers show the op names.  The in-process activity stream (op
ranges, allocations) is recorded here and pushed to a DataWriter
callback as length-prefixed JSON records (the flatbuffers analog;
self-describing so the Java shim can decode without a schema compiler).
The stream's bytes are the JAX package's: either package's
``iter_records`` and ``tools/profile_converter`` read the other's.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Optional

import torch

from spark_rapids_tpu_torch import observability as _obs


class Config:
    """Profiler.Config.Builder analog (Profiler.java:133-145)."""

    def __init__(self, write_buffer_size: int = 1 << 20,
                 flush_period_millis: int = 0,
                 alloc_capture: bool = False,
                 device_trace_dir: Optional[str] = None):
        self.write_buffer_size = write_buffer_size
        self.flush_period_millis = flush_period_millis
        self.alloc_capture = alloc_capture
        self.device_trace_dir = device_trace_dir


class Profiler:
    """Singleton-style control surface: init/start/stop/shutdown."""

    _instance: Optional["Profiler"] = None

    def __init__(self, data_writer: Callable[[bytes], None],
                 config: Config):
        self.writer = data_writer
        self.config = config
        self._buffer: List[bytes] = []
        self._buffered_bytes = 0
        self._lock = threading.Lock()
        self._running = False
        self._device_trace = None
        self._flusher: Optional[threading.Thread] = None

    # --------------------------------------------------------- lifecycle

    @classmethod
    def init(cls, data_writer, config: Optional[Config] = None
             ) -> "Profiler":
        if cls._instance is not None:
            raise RuntimeError("profiler already initialized")
        cls._instance = Profiler(data_writer, config or Config())
        return cls._instance

    @classmethod
    def get(cls) -> Optional["Profiler"]:
        return cls._instance

    @classmethod
    def shutdown(cls):
        inst = cls._instance
        if inst is not None:
            inst.stop()
            inst.flush()
            cls._instance = None
            # optional sink teardown (file-backed DataWriters set
            # sink_close so EVERY shutdown path releases the file)
            closer = getattr(inst, "sink_close", None)
            if closer is not None:
                try:
                    closer()
                except Exception:
                    pass

    def start(self):
        if self._running:
            return
        self._running = True
        if self.config.device_trace_dir:
            self._device_trace = _start_device_trace(
                self.config.device_trace_dir)
        if self.config.flush_period_millis > 0:
            self._flusher = threading.Thread(target=self._flush_loop,
                                             daemon=True)
            self._flusher.start()
        self.record("profiler_start", {})

    def stop(self):
        if not self._running:
            return
        self.record("profiler_stop", {})
        self._running = False
        if self._flusher is not None:
            self._flusher.join(
                self.config.flush_period_millis / 1000.0 * 4 + 1)
            self._flusher = None
        if self._device_trace is not None:
            try:
                self._device_trace.stop()
            except Exception:
                pass
            self._device_trace = None
        self.flush()

    # --------------------------------------------------------- recording

    def record(self, kind: str, payload: dict):
        """Append one activity record (KernelActivity/ApiActivity/... in
        the reference fbs schema, profiler.fbs:136-287)."""
        if not self._running and kind not in ("profiler_stop",):
            return
        rec = json.dumps({"kind": kind, "t_ns": time.monotonic_ns(),
                          **payload}).encode()
        framed = struct.pack("<I", len(rec)) + rec
        blob = None
        with self._lock:
            self._buffer.append(framed)
            self._buffered_bytes += len(framed)
            if self._buffered_bytes >= self.config.write_buffer_size:
                blob = self._take_locked()
        if blob:
            self.writer(blob)  # outside the lock: writer may re-enter

    def flush(self):
        with self._lock:
            blob = self._take_locked()
        if blob:
            self.writer(blob)

    def _take_locked(self) -> bytes:
        blob = b"".join(self._buffer)
        self._buffer = []
        self._buffered_bytes = 0
        return blob

    def _flush_loop(self):
        period = self.config.flush_period_millis / 1000.0
        while self._running:
            time.sleep(period)
            self.flush()


def _start_device_trace(trace_dir: str):
    """A ``torch.profiler`` session writing its Chrome trace under
    ``trace_dir`` when stopped (the card's activities when one is
    present, the host's always); None when the build cannot trace."""
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                trace_dir))
        prof.start()
        return prof
    except Exception:  # a build without the profiler's backends
        return None


_NVTX: Optional[bool] = None

# an NVTX range reaches only a tool that NVTX loaded through this
# variable (Nsight Systems and Nsight Compute set it in the process
# they launch); without one, NVTX's push and pop do nothing.  So an
# attached tool counts as a sidecar that is on (utils/tracing)
NVTX_TOOL = bool(os.environ.get("NVTX_INJECTION64_PATH"))


def _nvtx_on() -> bool:
    """NVTX ranges only where a card is present: a CPU build of torch
    has no NVTX library behind ``torch.cuda.nvtx``."""
    global _NVTX
    if _NVTX is None:
        _NVTX = bool(torch.cuda.is_available())
    return _NVTX


@contextmanager
def op_range(name: str, **attrs):
    """NVTX3_FUNC_RANGE analog (nvtx_ranges.hpp): wraps an op in a
    ``torch.profiler.record_function`` annotation (and an NVTX range on
    a machine with a card), emits a range record to the in-process
    profiler when one is running, and opens a child span on the process
    tracer when tracing is enabled (the span parents under the
    innermost open query/stage/op span on this thread).

    Every bracket records its own range/span: the shim's bracket plus
    the op layer's `traced` wrapper around ONE logical call is skipped
    at the `traced` layer, keyed by the owning frame; a genuinely
    recursive op call is a real nested range and is recorded as such."""
    owner = sys._getframe(2)  # frame containing the `with` statement
    stack = _bracket_stack()
    stack.append((name, id(owner)))
    prof = Profiler.get()
    tracer = _obs.TRACER
    span = (tracer.start_span(name, kind="op", attrs=attrs or None)
            if tracer.enabled else None)
    nvtx = _nvtx_on()
    t0 = time.monotonic_ns()
    try:
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
    finally:
        stack.pop()
        dur_ns = time.monotonic_ns() - t0
        if span is not None:
            span.end()
        if prof is not None:
            prof.record("op_range",
                        {"name": name,
                         "dur_ns": dur_ns,
                         "thread": threading.get_ident(),
                         **attrs})
        # observability spine: per-op latency histogram + per-task
        # attribution + the lifeguard's heartbeat (no-op behind one
        # bool when disabled)
        _obs.record_op(name, dur_ns)


_active_ranges = threading.local()


def _bracket_stack() -> list:
    """Thread-local stack of (op name, owner frame id) for brackets
    currently open on this thread."""
    s = getattr(_active_ranges, "stack", None)
    if s is None:
        s = []
        _active_ranges.stack = s
    return s


def active_op_names() -> set:
    """Op names currently inside an op_range on this thread."""
    return {n for n, _ in _bracket_stack()}


def bracket_owned_by(name: str, frame_id: int) -> bool:
    """True when an open bracket for `name` on this thread was entered
    by the frame with id `frame_id` — i.e. the caller asking IS the
    code lexically inside that bracket's `with` statement.  This is the
    shim-over-op double-bracket signature `utils/tracing.traced` must
    suppress (and the ONLY thing it suppresses: a recursive call to the
    same op from a different frame brackets normally)."""
    for n, fid in _bracket_stack():
        if n == name and fid == frame_id:
            return True
    return False


def iter_records(blob: bytes):
    """Decode a DataWriter blob back into record dicts (the
    spark_rapids_profile_converter role for tests/tools)."""
    pos = 0
    while pos < len(blob):
        (n,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        yield json.loads(blob[pos:pos + n])
        pos += n


def record_alloc(kind: str, num_bytes: int) -> None:
    """Allocator hook (reference alloc-capture activity records,
    profiler.fbs AllocActivity): called by the memory adaptor on every
    device alloc/free; no-op unless a running profiler asked for
    alloc_capture."""
    prof = Profiler.get()
    if prof is not None and prof.config.alloc_capture:
        prof.record(kind, {"bytes": int(num_bytes),
                           "thread": threading.get_ident()})
