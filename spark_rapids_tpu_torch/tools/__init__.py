"""Offline tooling (reference profiler/ converter + tools/ analogs)."""

from __future__ import annotations

import json
import os
import sys
from typing import List


def read_jsonl(path: str) -> List[dict]:
    """Tolerant JSONL load shared by the report/export tools: blank
    lines skipped, unparseable lines warned to stderr (never fatal —
    a truncated line must not hide the rest of a dump), non-dict
    records dropped."""
    records: List[dict] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                print(f"{path}:{i + 1}: skipping unparseable line",
                      file=sys.stderr)
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records

# flight-recorder bundle layout (observability/flight_recorder.py)
_BUNDLE_FILES = {"spans": "spans.jsonl", "journal": "journal.jsonl",
                 "profile": "profile.json"}


def expand_bundle_input(path: str, prefer: str) -> List[str]:
    """Let every JSONL-eating tool accept a flight-recorder incident
    bundle directory directly: a directory input resolves to the
    bundle file matching ``prefer`` ("spans", "journal" or
    "profile").  Only the spans consumer may fall back to
    journal.jsonl (span records also ride the journal dump); the
    reverse would hand the metrics report a spans-only file it
    silently renders empty, and a bundle frozen before any query was
    profiled has no profile.json at all — both fail loudly instead.
    Non-directory inputs pass through untouched."""
    if not os.path.isdir(path):
        return [path]
    want = _BUNDLE_FILES[prefer]
    names = [want, _BUNDLE_FILES["journal"]] if prefer == "spans" \
        else [want]
    for name in names:
        cand = os.path.join(path, name)
        if os.path.isfile(cand):
            return [cand]
    raise FileNotFoundError(
        f"{path}: directory holds no {' or '.join(names)} "
        f"(not a flight-recorder incident bundle?)")
