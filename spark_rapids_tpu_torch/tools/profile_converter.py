"""Offline profile converter (reference:
profiler/src/spark_rapids_profile_converter.cpp:1-1356 — the tool that
turns the profiler's binary activity stream into analyst-facing
artifacts).

Input: one or more files containing the DataWriter stream of
length-prefixed JSON records emitted by utils/profiler.py.  Outputs:

  * Chrome trace-event JSON (``--chrome out.json``): op ranges as
    complete ("X") events on their thread track, alloc/free as a
    running counter track — loadable in chrome://tracing / Perfetto,
    the role nsys-ui plays for the reference's converted traces.
  * A per-op summary table (``--summary``): calls, total/avg/max ns —
    the converter's text report mode.

Usage:
    python -m spark_rapids_tpu_torch.tools.profile_converter prof.bin \
        --chrome trace.json --summary
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List

from spark_rapids_tpu_torch.utils.profiler import iter_records


def _iter_jsonl(blob: bytes):
    for line in blob.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # a journal dump may be torn mid-write
        if isinstance(rec, dict):
            yield rec


def _looks_like_jsonl(blob: bytes) -> bool:
    """A journal dump's first line is a complete JSON object; a
    DataWriter stream's first 'line' starts with a binary length prefix
    (which can itself look like '{' — 123 == 0x7b — so sniffing a byte
    is not enough) and never parses."""
    first = blob.split(b"\n", 1)[0].strip()
    if not first:
        return False
    try:
        return isinstance(json.loads(first), dict)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return False


def load_records(paths: Iterable[str]) -> List[dict]:
    """Load profiler DataWriter streams AND observability journal JSONL
    dumps (spark_rapids_tpu_torch.observability.dump_journal_jsonl) onto one
    timeline.  Format is sniffed per file by parsing the first line.
    Unknown record kinds pass through — downstream renderers skip or
    mark them instead of raising."""
    records: List[dict] = []
    for p in paths:
        with open(p, "rb") as f:
            blob = f.read()
        if _looks_like_jsonl(blob):
            records.extend(_iter_jsonl(blob))
        else:
            records.extend(iter_records(blob))
    records.sort(key=lambda r: r.get("t_ns", 0))
    return records


def to_chrome_trace(records: List[dict]) -> dict:
    """Chrome trace-event format (catapult spec): op_range -> "X"
    complete events; alloc/free -> a memory counter track."""
    events = []
    mem = 0
    for r in records:
        kind = r.get("kind")
        ts_us = r.get("t_ns", 0) / 1000.0
        if kind == "op_range":
            dur_us = r.get("dur_ns", 0) / 1000.0
            events.append({
                "name": r.get("name", "?"), "ph": "X", "cat": "op",
                "ts": ts_us - dur_us, "dur": dur_us,
                "pid": 1, "tid": r.get("thread", 0),
            })
        elif kind in ("alloc", "free"):
            mem += r.get("bytes", 0) * (1 if kind == "alloc" else -1)
            events.append({
                "name": "device_memory", "ph": "C", "ts": ts_us,
                "pid": 1, "args": {"bytes": mem},
            })
        elif kind in ("profiler_start", "profiler_stop"):
            events.append({
                "name": kind, "ph": "i", "ts": ts_us, "pid": 1,
                "tid": 0, "s": "g",
            })
        elif kind in ("task_rollup", "registry_snapshot"):
            pass  # journal-dump summary records: no timeline point
        elif "t_ns" in r:
            # journal events (oom_retry, shuffle_write, exchange
            # doublings, future kinds): instant events on the emitting
            # thread's track
            events.append({
                "name": kind or "?", "ph": "i", "ts": ts_us, "pid": 1,
                "tid": r.get("thread", 0), "s": "t",
                "args": {k: v for k, v in r.items()
                         if k not in ("kind", "t_ns", "thread")},
            })
    return {"traceEvents": events, "displayTimeUnit": "ns"}


def summarize(records: List[dict]) -> List[dict]:
    """Per-op aggregate rows, busiest first."""
    agg: Dict[str, dict] = {}
    for r in records:
        if r.get("kind") != "op_range":
            continue
        a = agg.setdefault(r.get("name", "?"),
                           {"calls": 0, "total_ns": 0, "max_ns": 0})
        d = r.get("dur_ns", 0)
        a["calls"] += 1
        a["total_ns"] += d
        a["max_ns"] = max(a["max_ns"], d)
    rows = [{"op": k, **v,
             "avg_ns": v["total_ns"] // max(v["calls"], 1)}
            for k, v in agg.items()]
    rows.sort(key=lambda r: -r["total_ns"])
    return rows


def alloc_stats(records: List[dict]) -> dict:
    cur = peak = total_allocs = 0
    for r in records:
        if r.get("kind") == "alloc":
            cur += r.get("bytes", 0)
            peak = max(peak, cur)
            total_allocs += 1
        elif r.get("kind") == "free":
            cur -= r.get("bytes", 0)
    return {"allocs": total_allocs, "peak_bytes": peak,
            "leaked_bytes": cur}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert spark_rapids_tpu_torch profiler streams")
    ap.add_argument("inputs", nargs="+", help="profiler stream files")
    ap.add_argument("--chrome", metavar="OUT.json",
                    help="write Chrome trace-event JSON")
    ap.add_argument("--summary", action="store_true",
                    help="print per-op summary table")
    args = ap.parse_args(argv)

    records = load_records(args.inputs)
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(to_chrome_trace(records), f)
        print(f"wrote {args.chrome} ({len(records)} records)")
    if args.summary or not args.chrome:
        rows = summarize(records)
        if rows:
            w = max(len(r["op"]) for r in rows)
            print(f"{'op':<{w}}  calls  total_ms  avg_us  max_us")
            for r in rows:
                print(f"{r['op']:<{w}}  {r['calls']:>5}  "
                      f"{r['total_ns'] / 1e6:>8.3f}  "
                      f"{r['avg_ns'] / 1e3:>6.1f}  "
                      f"{r['max_ns'] / 1e3:>6.1f}")
        a = alloc_stats(records)
        if a["allocs"]:
            print(f"allocs: {a['allocs']}  peak: {a['peak_bytes']}B  "
                  f"leaked: {a['leaked_bytes']}B")
        known = {"op_range", "alloc", "free", "profiler_start",
                 "profiler_stop", "task_rollup", "registry_snapshot"}
        other: Dict[str, int] = {}
        for r in records:
            k = r.get("kind", "?")
            if k not in known:
                other[k] = other.get(k, 0) + 1
        if other:
            print("journal events: " + "  ".join(
                f"{k}={n}" for k, n in sorted(other.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
