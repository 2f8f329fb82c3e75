"""Span -> Perfetto/Chrome trace-event exporter (the analyst-facing
half of the tracing story; the reference's counterpart is nsys-ui /
TensorBoard over the converted CUPTI stream).

Input: one or more JSONL files of span records — either pure span dumps
(``observability.dump_spans_jsonl`` / the shim's ``tracing_dump``) or
full journal dumps (``dump_journal_jsonl``; only ``kind == "span"``
records are used, everything else passes through as instant events).
Each FILE is treated as one process: files from different executors
merge onto one timeline keyed by trace_id, which is how a distributed
query's spans (query root on the driver, op spans on executors, merge
spans re-parented through the kudo trace extension) land in one
Perfetto view.

Output: Chrome trace-event JSON (the catapult format Perfetto and
chrome://tracing load):

  * spans            -> "X" complete events (pid = input file ordinal,
                        tid = emitting thread), args carry
                        trace/span/parent ids, task attribution, attrs;
  * span links       -> flow events ("s" at the linked span's end,
                        "f" at the linking span's start) — the shuffle
                        write->merge causality renders as arrows;
  * non-span journal -> "i" instant events on their thread track.

Timestamps are per-process monotonic clocks; cross-process alignment is
best-effort (the trace groups by pid, so skew shows as offset tracks,
never as wrong nesting).

Usage:
    python -m spark_rapids_tpu_torch.tools.trace_export spans.jsonl \
        [more.jsonl ...] -o trace.json [--stats]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional, Tuple


def load_files(paths: Iterable[str]) -> List[Tuple[str, List[dict]]]:
    """[(path, records)] — one entry per input file (= per process).
    A flight-recorder incident bundle directory stands in for its
    spans.jsonl, so existing viewers load frozen incidents as-is."""
    from spark_rapids_tpu_torch.tools import expand_bundle_input, read_jsonl

    out = []
    for p0 in paths:
        for p in expand_bundle_input(p0, "spans"):
            out.append((p, read_jsonl(p)))
    return out


def spans_of(records: List[dict]) -> List[dict]:
    return [r for r in records if r.get("kind") == "span"
            and "span_id" in r]


# ------------------------------------------------------------ tree checks


def build_index(span_records: List[dict]) -> Dict[str, dict]:
    """span_id -> record across all processes (ids are 64-bit random,
    collision-free for any realistic trace)."""
    return {r["span_id"]: r for r in span_records}


def find_orphans(span_records: List[dict]) -> List[dict]:
    """Spans whose parent_id resolves to no known span — a broken tree
    (a root has parent_id None and is NOT an orphan)."""
    idx = build_index(span_records)
    return [r for r in span_records
            if r.get("parent_id") and r["parent_id"] not in idx]


def root_of(rec: dict, idx: Dict[str, dict],
            max_depth: int = 1000) -> Optional[dict]:
    """Walk parent links to the root span (None on a broken chain)."""
    seen = 0
    while rec.get("parent_id"):
        rec = idx.get(rec["parent_id"])
        if rec is None or seen > max_depth:
            return None
        seen += 1
    return rec


def fusion_counts(files: List[Tuple[str, List[dict]]]
                  ) -> Dict[str, Dict[str, int]]:
    """Per-stage fused/unfused/compile dispatch counts read back from
    ``srt_stage_fusion_total`` in any ``registry_snapshot`` record in
    the inputs (journal dumps carry one; pure span dumps don't) —
    a trace alone then shows whether fusion engaged.  Multiple input
    files (one per process) sum."""
    out: Dict[str, Dict[str, int]] = {}
    for _path, records in files:
        for r in records:
            if r.get("kind") != "registry_snapshot":
                continue
            fam = (r.get("registry") or {}).get(
                "srt_stage_fusion_total") or {}
            for s in fam.get("series", []):
                labels = s.get("labels") or ()
                stage = labels[0] if len(labels) > 0 else "?"
                outcome = labels[1] if len(labels) > 1 else "?"
                row = out.setdefault(stage, {})
                row[outcome] = row.get(outcome, 0) \
                    + int(s.get("value", 0))
    return out


def trace_summary(span_records: List[dict]) -> Dict[str, dict]:
    """Per-trace_id rollup: span counts by kind, root names, orphan
    count — the --stats view and the smoke gate's assertion surface."""
    idx = build_index(span_records)
    out: Dict[str, dict] = {}
    for r in span_records:
        t = out.setdefault(r.get("trace_id", "?"), {
            "spans": 0, "by_kind": {}, "roots": [], "orphans": 0})
        t["spans"] += 1
        k = r.get("span_kind", "?")
        t["by_kind"][k] = t["by_kind"].get(k, 0) + 1
        if not r.get("parent_id"):
            t["roots"].append(r.get("name", "?"))
        elif r["parent_id"] not in idx:
            t["orphans"] += 1
    return out


# ---------------------------------------------------------------- export


def to_chrome_trace(files: List[Tuple[str, List[dict]]]) -> dict:
    """Merge per-process record files into one Chrome trace-event JSON
    (loadable in Perfetto / chrome://tracing)."""
    events: List[dict] = []
    all_spans: List[dict] = []
    span_pid: Dict[str, int] = {}
    for pid0, (path, records) in enumerate(files):
        pid = pid0 + 1
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": path}})
        for r in records:
            if r.get("kind") == "span" and "span_id" in r:
                all_spans.append(r)
                span_pid[r["span_id"]] = pid
                args = {"trace_id": r.get("trace_id"),
                        "span_id": r.get("span_id"),
                        "parent_id": r.get("parent_id")}
                if "task" in r:
                    args["task"] = r["task"]
                if r.get("attrs"):
                    args.update(r["attrs"])
                events.append({
                    "name": r.get("name", "?"), "ph": "X",
                    "cat": r.get("span_kind", "span"),
                    "ts": r.get("t_ns", 0) / 1000.0,
                    "dur": max(r.get("dur_ns", 0) / 1000.0, 0.001),
                    "pid": pid, "tid": r.get("thread", 0),
                    "args": args,
                })
            elif "t_ns" in r and r.get("kind") not in (
                    "task_rollup", "registry_snapshot"):
                events.append({
                    "name": r.get("kind", "?"), "ph": "i",
                    "ts": r["t_ns"] / 1000.0, "pid": pid,
                    "tid": r.get("thread", 0), "s": "t",
                    "args": {k: v for k, v in r.items()
                             if k not in ("kind", "t_ns", "thread")},
                })
    # flow arrows for span links (shuffle write -> merge causality);
    # only drawable when the linked span is present in some input file
    idx = build_index(all_spans)
    for r in all_spans:
        for link in r.get("links", ()):
            src = idx.get(link.get("span_id"))
            if src is None:
                continue
            # flow id unique per (source, target): Perfetto binds flows
            # by (cat, id), so two merges linking the SAME writer span
            # must not share an id (they would chain into one arrow)
            fid = f"{link['span_id']}:{r['span_id']}"
            events.append({
                "name": "span_link", "ph": "s", "cat": "link",
                "id": fid,
                "ts": (src.get("t_ns", 0) + src.get("dur_ns", 0))
                / 1000.0,
                "pid": span_pid[src["span_id"]],
                "tid": src.get("thread", 0),
            })
            events.append({
                "name": "span_link", "ph": "f", "cat": "link",
                "id": fid, "bp": "e",
                "ts": r.get("t_ns", 0) / 1000.0,
                "pid": span_pid[r["span_id"]],
                "tid": r.get("thread", 0),
            })
    return {"traceEvents": events, "displayTimeUnit": "ns"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Merge span JSONL dumps into a Perfetto-loadable "
                    "Chrome trace (one input file per process)")
    ap.add_argument("inputs", nargs="+", help="span/journal JSONL files")
    ap.add_argument("-o", "--output", metavar="TRACE.json",
                    help="write Chrome trace-event JSON here")
    ap.add_argument("--stats", action="store_true",
                    help="print per-trace span/tree summary")
    args = ap.parse_args(argv)

    files = load_files(args.inputs)
    all_spans = [r for _, recs in files for r in spans_of(recs)]
    if args.output:
        trace = to_chrome_trace(files)
        with open(args.output, "w") as f:
            json.dump(trace, f)
        print(f"wrote {args.output} ({len(trace['traceEvents'])} events, "
              f"{len(all_spans)} spans)")
    if args.stats or not args.output:
        summary = trace_summary(all_spans)
        if not summary:
            print("(no span records in input)")
        for tid_, t in sorted(summary.items(),
                              key=lambda kv: -kv[1]["spans"]):
            kinds = " ".join(f"{k}={n}"
                             for k, n in sorted(t["by_kind"].items()))
            roots = ",".join(t["roots"]) or "-"
            print(f"trace {tid_}: {t['spans']} spans  roots=[{roots}]  "
                  f"{kinds}  orphans={t['orphans']}")
        fusion = fusion_counts(files)
        if fusion:
            print("stage fusion (srt_stage_fusion_total):")
            for stage, row in sorted(fusion.items()):
                cells = "  ".join(f"{k}={row[k]}"
                                  for k in ("fused", "unfused",
                                            "compile") if k in row)
                print(f"  {stage}: {cells}")
        orphans = find_orphans(all_spans)
        if orphans:
            print(f"WARNING: {len(orphans)} orphan spans "
                  "(parent not in any input file)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
