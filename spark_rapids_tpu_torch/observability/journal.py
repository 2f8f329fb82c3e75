"""Structured event journal: append-only, ring-buffered, JSONL-dumpable.

The reference's explain-why-it-was-slow surface is event-shaped, not
gauge-shaped: RmmSpark logs every OOM retry/split/block transition to a
CSV state log, the CUPTI profiler streams activity records, kudo counts
writes/merges.  This journal is the unified host for those discrete
events here: OOM retry/split/block/remove, shuffle writes/merges,
exchange capacity-doublings, task completion rollups.

Records are plain dicts with the same ``kind``/``t_ns`` envelope as the
profiler's DataWriter records (utils/profiler.py), so
tools/profile_converter.py can interleave a journal dump with a
profiler stream on one timeline.  The buffer is a bounded ring — a
long-lived executor can emit forever; readers get the most recent
`capacity` events plus a count of how many were overwritten.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class EventJournal:
    def __init__(self, capacity: int = 8192, enabled_ref=None,
                 on_drop=None):
        """`enabled_ref`: object with a truthy `.enabled` attribute
        consulted on every emit (the shared observability switch);
        None means always-on (tests).  `on_drop(n)`: called (outside
        the ring lock) each time `n` events are overwritten by ring
        wrap-around — observability points it at the
        ``srt_journal_dropped_total`` counter so drops are no longer
        silent."""
        self.capacity = capacity
        self._enabled_ref = enabled_ref
        self._on_drop = on_drop
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0

    # ------------------------------------------------------------- write

    def emit(self, kind: str, **fields) -> None:
        """Append one event.  Near-zero cost when the shared switch is
        off: a single attribute read and return."""
        ref = self._enabled_ref
        if ref is not None and not ref.enabled:
            return
        rec = {"kind": kind, "t_ns": time.monotonic_ns(), **fields}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            dropping = len(self._ring) == self._ring.maxlen
            self._ring.append(rec)
        if dropping and self._on_drop is not None:
            try:
                self._on_drop(1)
            except Exception:
                pass  # accounting must never break the emitting layer

    # -------------------------------------------------------------- read

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_emitted(self) -> int:
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap-around."""
        with self._lock:
            return self._seq - len(self._ring)

    def records(self, kind: Optional[str] = None) -> List[Dict]:
        with self._lock:
            recs = list(self._ring)
        if kind is not None:
            recs = [r for r in recs if r.get("kind") == kind]
        return recs

    def counts_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records():
            k = r.get("kind", "?")
            out[k] = out.get(k, 0) + 1
        return out

    # -------------------------------------------------------------- dump

    def dump_jsonl(self, path_or_file) -> int:
        """Write the current ring as JSON Lines; returns record count.
        Accepts a path or an open text file object; path writes are
        atomic (tmp + rename) so a crash mid-dump never leaves a
        truncated file."""
        from spark_rapids_tpu_torch.observability.dumpio import dump_via

        recs = self.records()

        def _write(f):
            for r in recs:
                f.write(json.dumps(r) + "\n")
            return len(recs)

        return dump_via(path_or_file, _write)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
