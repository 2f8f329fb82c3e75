"""``srt-doctor``: offline triage of flight-recorder incident bundles.

Loads a bundle written by ``observability/flight_recorder.py``,
cross-references its three evidence planes — spans (where time went),
journal (what happened), memory ledger (who holds what) — and prints a
ranked diagnosis, e.g.::

    1. [95] root cause: fault-injection rule match='exchange.step'
            (GpuRetryOOM) matches the exhausted section
    2. [90] task 7 exhausted retries in 'exchange.step' (attempts)
            after 4 failed attempts [GpuRetryOOM x4]
    3. [70] thread 3 (task 7, THREAD_BLOCKED) holds 1.2 GiB device
            memory (watermark 1.5 GiB)
    4. [60] stage 'exchange.step' p99 9.8x p50 over 42 tasks

Output is purely bundle-derived (no "now" stamps), so the same bundle
always prints the same diagnosis — the golden-output test in
tests/test_flight_recorder.py holds the CLI to that.

Usage:
    python -m spark_rapids_tpu_torch.tools.doctor BUNDLE_DIR [--json]

``BUNDLE_DIR`` may also be the recorder's output directory (the one
holding ``incident-*`` subdirectories): the most recent complete
bundle is diagnosed and the rest are listed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import datetime, timezone
from typing import Dict, List, Optional

MANIFEST = "MANIFEST.json"

# how journal retry activity is judged a storm offline (mirrors the
# live RetryStormDetector defaults)
STORM_THRESHOLD = 10
STRAGGLER_RATIO = 5.0
STRAGGLER_MIN_SAMPLES = 8
# Monitor-thread sample age (s) at which the telemetry plane is
# declared stalled rather than idle
STALLED_SAMPLER_S = 15.0


def _fmt_bytes(n) -> str:
    n = int(n)
    for unit, width in (("GiB", 1 << 30), ("MiB", 1 << 20),
                        ("KiB", 1 << 10)):
        if n >= width:
            return f"{n / width:.1f} {unit}"
    return f"{n} B"


def _fmt_unix_ms(ms) -> str:
    return datetime.fromtimestamp(int(ms) / 1000.0, tz=timezone.utc) \
        .strftime("%Y-%m-%dT%H:%M:%SZ")


def _load_json(path: str, default):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return default


def _load_jsonl(path: str) -> List[dict]:
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


class Bundle:
    """One loaded incident bundle; every file is optional (a partial
    bundle still gets a best-effort diagnosis)."""

    def __init__(self, path: str):
        self.path = path
        self.manifest = _load_json(os.path.join(path, MANIFEST), {})
        self.trigger = _load_json(os.path.join(path, "trigger.json"), {})
        self.metrics = _load_json(os.path.join(path, "metrics.json"), {})
        self.ledger = _load_json(
            os.path.join(path, "memory_ledger.json"), {})
        self.threads = _load_json(os.path.join(path, "threads.json"), {})
        self.fault_rules = _load_json(
            os.path.join(path, "fault_rules.json"), [])
        self.env = _load_json(os.path.join(path, "env.json"), {})
        records = _load_jsonl(os.path.join(path, "journal.jsonl"))
        self.journal = [r for r in records
                        if r.get("kind") not in ("task_rollup",
                                                 "registry_snapshot")]
        self.task_rollups = {r.get("task"): r for r in records
                             if r.get("kind") == "task_rollup"}
        self.spans = _load_jsonl(os.path.join(path, "spans.jsonl"))
        if not self.spans:  # fall back to span records in the journal
            self.spans = [r for r in self.journal
                          if r.get("kind") == "span"]
        # the most recent per-query EXPLAIN ANALYZE
        # artifact rides the bundle — the "slowest plan node"
        # evidence plane (absent in profiler-off processes)
        self.profile = _load_json(os.path.join(path, "profile.json"),
                                  {})
        # the last query's time-attribution ledger (absent
        # in attribution-off processes — findings built from it only
        # appear when the bundle carries it)
        self.attribution = _load_json(
            os.path.join(path, "attribution.json"), {})


def is_bundle_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST)) \
        or os.path.isfile(os.path.join(path, "trigger.json"))


def find_bundles(root: str) -> List[str]:
    """Complete (manifest-bearing) bundle dirs under a recorder output
    directory, oldest first."""
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    return [os.path.join(root, n) for n in names
            if not n.endswith(".tmp")  # half-written crash leftovers
            and os.path.isfile(os.path.join(root, n, MANIFEST))]


# ------------------------------------------------------------- analysis


def _retry_span_for(bundle: Bundle, name: str) -> Optional[dict]:
    for r in reversed(bundle.spans):
        if r.get("span_kind") == "retry" \
                and r.get("name") == f"retry_episode:{name}":
            return r
    return None


def _task_of_exhausted(bundle: Bundle, name: str):
    """Task attribution for an exhausted section: its retry span's
    task, else the task on the most recent OOM journal event, else the
    busiest task in the ledger."""
    span = _retry_span_for(bundle, name)
    if span is not None and span.get("task") is not None:
        return span["task"]
    for r in reversed(bundle.journal):
        if r.get("kind") in ("oom_retry", "oom_split_retry") \
                and r.get("task", -1) >= 0:
            return r["task"]
    tasks = bundle.ledger.get("tasks") or {}
    best = None
    for tid, row in tasks.items():
        if best is None or row.get("retry_oom", 0) > \
                tasks[best].get("retry_oom", 0):
            best = tid
    return best


def _err_counts(errors: List[str]) -> str:
    counts: Dict[str, int] = {}
    for e in errors:
        counts[e] = counts.get(e, 0) + 1
    return ", ".join(f"{e} x{n}" for e, n in sorted(counts.items()))


def analyze(bundle: Bundle) -> List[dict]:
    """Ranked findings (most severe first); each is
    {severity, kind, message}."""
    findings: List[dict] = []
    trig = bundle.trigger
    kind = trig.get("kind", "?")
    detail = trig.get("detail") or {}
    ledger_threads = bundle.ledger.get("threads") or {}

    # ---- the trigger itself, cross-referenced -----------------------
    if kind == "retry_exhausted":
        name = detail.get("name", "?")
        errors = [e for e in detail.get("errors", [])]
        task = _task_of_exhausted(bundle, name)
        task_txt = f"task {task}" if task is not None else "unknown task"
        msg = (f"{task_txt} exhausted retries in {name!r} "
               f"({detail.get('reason', '?')}) after "
               f"{len(errors) or detail.get('attempts', '?')} failed "
               f"attempts [{_err_counts(errors) or 'no history'}]")
        holders = [(tid, row) for tid, row in sorted(
            ledger_threads.items())
            if row.get("active_bytes", 0) > 0]
        if holders:
            tid, row = max(holders,
                           key=lambda kv: kv[1]["active_bytes"])
            msg += (f"; thread {tid} held "
                    f"{_fmt_bytes(row['active_bytes'])} at incident "
                    f"time")
        if detail.get("reason") == "split_floor":
            # the one-element split floor is a DIFFERENT
            # failure from a spent budget — the batch cannot shrink
            # further, so the fix is spilling / a bigger device, not
            # more retries
            msg += ("; SPLIT FLOOR: the batch is down to one element "
                    "and still does not fit — register the build side "
                    "with the spill store or raise the device budget")
        findings.append({"severity": 90, "kind": "retry_exhausted",
                         "message": msg})
        injected = [r for r in bundle.fault_rules
                    if r.get("match") in (name, "*")
                    or r.get("exception") in errors]
        for rule in injected:
            findings.append({
                "severity": 95, "kind": "fault_injection",
                "message": (f"root cause: fault-injection rule "
                            f"match={rule.get('match')!r} "
                            f"({rule.get('exception')}, "
                            f"remaining={rule.get('remaining')}) "
                            f"matches the exhausted section "
                            f"{name!r}")})
    elif kind == "memory_leak":
        findings.append({
            "severity": 88, "kind": "memory_leak",
            "message": (f"task {detail.get('task')} finished still "
                        f"holding "
                        f"{_fmt_bytes(detail.get('leaked_bytes', 0))} "
                        f"device memory")})
    elif kind == "kudo_corrupt":
        findings.append({
            "severity": 85, "kind": "kudo_corrupt",
            "message": (f"kudo stream corruption "
                        f"({detail.get('reason', '?')}): "
                        f"{detail.get('detail', '')}")})
    elif kind == "straggler":
        findings.append({
            "severity": 80, "kind": "straggler",
            "message": (f"stage {detail.get('stage')!r} task "
                        f"{detail.get('task')} ran "
                        f"{detail.get('dur_ns', 0) / 1e6:.1f} ms vs "
                        f"median "
                        f"{detail.get('median_ns', 0) / 1e6:.1f} ms "
                        f"(robust z {detail.get('robust_z')})")})
    elif kind == "retry_storm":
        findings.append({
            "severity": 80, "kind": "retry_storm",
            "message": (f"retry storm: "
                        f"{detail.get('episodes_in_window')} failed "
                        f"episodes in {detail.get('window_s')}s "
                        f"(sections: "
                        f"{', '.join(detail.get('recent_sections', []))}"
                        f")")})
    elif kind == "hbm_pressure":
        findings.append({
            "severity": 78, "kind": "hbm_pressure",
            "message": (f"device {detail.get('device')} HBM held "
                        f"{_fmt_bytes(detail.get('bytes_in_use', 0))} "
                        f">= threshold "
                        f"{_fmt_bytes(detail.get('threshold_bytes', 0))}"
                        f" for {detail.get('sustained_s')}s")})
    elif kind == "fleet_incident":
        dead = detail.get("dead", [])
        moved = detail.get("shards_moved") or {}
        heirs = sorted(set(moved.values()))
        findings.append({
            "severity": 84, "kind": "fleet_incident",
            "message": (f"fleet membership change on rank "
                        f"{detail.get('rank')}: dead rank(s) "
                        f"{dead} at epoch {detail.get('epoch')}; "
                        f"shard(s) {sorted(moved)} rebalanced to "
                        f"rank(s) {heirs}; live={detail.get('live')}"
                        )})
    elif kind == "query_hang":
        tenant = detail.get("tenant", "?")
        query = detail.get("query", "?")
        ident = detail.get("worker_ident")
        msg = (f"query server worker hung: tenant {tenant!r} query "
               f"{query!r} ({detail.get('query_id')}) silent "
               f"{detail.get('silent_ms', '?')} ms in op "
               f"{detail.get('last_op', '?')!r} "
               f"(worker thread {ident}, task "
               f"{detail.get('task_id')}, {detail.get('reason')})")
        findings.append({"severity": 92, "kind": "query_hang",
                         "message": msg})
        # where exactly it is stuck: the trigger's own stack capture,
        # else the bundle-wide python stack dump for that ident
        stack = detail.get("stack") or []
        if not stack and ident is not None:
            for t in (bundle.threads.get("python") or []):
                if t.get("ident") == ident:
                    stack = t.get("stack") or []
                    break
        if stack:
            findings.append({
                "severity": 74, "kind": "hung_stack",
                "message": ("hung worker's last frame: "
                            + str(stack[-1]).strip().splitlines()[0]
                            .strip())})
        q = detail.get("quarantine") or {}
        sig = detail.get("signature")
        if sig and q.get("quarantined"):
            findings.append({
                "severity": 88, "kind": "poison_query",
                "message": (f"poison query quarantined: signature "
                            f"{sig} after {q.get('strikes', '?')} "
                            f"death(s), retry after "
                            f"{q.get('retry_after_s', '?')}s")})
        elif sig:
            findings.append({
                "severity": 55, "kind": "poison_query",
                "message": (f"signature {sig} has "
                            f"{q.get('strikes', 0)} recent death(s) "
                            f"(quarantine not yet open)")})
    elif kind == "admission_stall":
        tenant = detail.get("tenant", "?")
        findings.append({
            "severity": 82, "kind": "admission_stall",
            "message": (f"query server admission stalled: tenant "
                        f"{tenant!r} query {detail.get('query_id')} "
                        f"waited {detail.get('queue_wait_ms', 0)} ms "
                        f"in queue (depth "
                        f"{detail.get('queue_depth', '?')})")})
        # name the tenant holding the device while others wait — the
        # per-tenant byte fold frozen at trigger time, else the ledger
        tenant_bytes = {str(t): int(b) for t, b in
                        (detail.get("tenant_device_bytes")
                         or {}).items() if int(b) > 0}
        if tenant_bytes:
            holder = max(tenant_bytes, key=lambda t: tenant_bytes[t])
            qualifier = "the stalled tenant itself" \
                if holder == tenant else f"while {tenant!r} waits"
            findings.append({
                "severity": 80, "kind": "tenant_memory",
                "message": (f"tenant {holder!r} holds "
                            f"{_fmt_bytes(tenant_bytes[holder])} "
                            f"device memory ({qualifier})")})
        else:
            held_tasks = [(tid, row) for tid, row in sorted(
                (bundle.ledger.get("tasks") or {}).items())
                if row.get("active_bytes", 0) > 0]
            if held_tasks:
                tid, row = max(held_tasks,
                               key=lambda kv: kv[1]["active_bytes"])
                findings.append({
                    "severity": 80, "kind": "tenant_memory",
                    "message": (f"task {tid} holds "
                                f"{_fmt_bytes(row['active_bytes'])} "
                                f"device memory while {tenant!r} "
                                f"admission stalls (no tenant map in "
                                f"bundle)")})
    elif kind == "lockdep_cycle":
        cycle = detail.get("cycle") or []
        findings.append({
            "severity": 86, "kind": "lockdep_cycle",
            "message": (f"lock-order cycle "
                        f"{' -> '.join(str(c) for c in cycle)} "
                        f"(ABBA deadlock potential — two threads "
                        f"taking these lock classes in opposite "
                        f"orders can wedge)")})
        fwd = (detail.get("evidence") or {}).get("forward") or {}
        stack = fwd.get("stack") or []
        # bundles are untrusted JSON off disk: a truncated/blank stack
        # entry must degrade to the top finding, not IndexError
        frame_lines = (str(stack[-1]).strip().splitlines()
                       if stack else [])
        if frame_lines:
            findings.append({
                "severity": 60, "kind": "lockdep_cycle",
                "message": ("reversing acquisition came from: "
                            + frame_lines[0].strip())})
    elif kind == "slo_burn":
        tenant = detail.get("tenant", "?")
        findings.append({
            "severity": 87, "kind": "slo_burn",
            "message": (f"tenant {tenant!r} is burning its error "
                        f"budget: burn {detail.get('burn_fast', '?')}x "
                        f"over the fast {detail.get('fast_window_s', '?')}s "
                        f"window and {detail.get('burn_slow', '?')}x "
                        f"over the slow "
                        f"{detail.get('slow_window_s', '?')}s window "
                        f"(threshold {detail.get('threshold', '?')}x; "
                        f"objective {detail.get('objective', '?')} at "
                        f"{detail.get('latency_target_ms', '?')} ms; "
                        f"attainment "
                        f"{detail.get('attainment', '?')})")})
        # the hot stage behind the burn: the profile frozen into this
        # bundle is the offending tenant's most recent EXPLAIN ANALYZE
        prof = bundle.profile or {}
        pstages = prof.get("stages") or []
        if pstages:
            hot = max(pstages, key=lambda s: int(s.get("wall_ns", 0)))
            findings.append({
                "severity": 70, "kind": "slo_hot_stage",
                "message": (f"hot stage behind the burn: "
                            f"{hot.get('stage')!r} "
                            f"[{hot.get('engine', '?')}] "
                            f"{int(hot.get('wall_ns', 0)) / 1e6:.1f} "
                            f"ms in query {prof.get('query_id')!r} "
                            f"(tenant {prof.get('tenant') or '?'})")})
        tail = detail.get("timeseries_tail") or []
        if tail:
            findings.append({
                "severity": 30, "kind": "slo_burn",
                "message": (f"ring tail frozen: {len(tail)} recent "
                            f"window(s) of telemetry in trigger.json "
                            f"(last window seq "
                            f"{tail[-1].get('window', '?')})")})
    elif kind == "cardinality_misestimate":
        node = detail.get("node", "?")
        stage = detail.get("stage", "?")
        findings.append({
            "severity": 55, "kind": "cardinality_misestimate",
            "message": (f"cardinality misestimate at node {node!r} of "
                        f"stage {stage!r}: estimated "
                        f"{detail.get('est', '?')} rows, observed "
                        f"{detail.get('actual', '?')} "
                        f"(x{detail.get('ratio', '?')} off; threshold "
                        f"SPARK_RAPIDS_TPU_STATS_MISEST_RATIO) — "
                        f"refresh the estimate source or re-plan: a "
                        f"cost-based choice keyed on this estimate is "
                        f"operating on wrong data")})
        ss = detail.get("stage_stats") or {}
        nodes = [n for n in (ss.get("nodes") or ())
                 if n.get("est") is not None]
        if nodes:
            split = ", ".join(
                f"{n['node']} est={n['est']} actual={n.get('rows')}"
                for n in nodes[:6])
            findings.append({
                "severity": 25, "kind": "cardinality_misestimate",
                "message": (f"stage {stage!r} est-vs-actual at "
                            f"trigger time: {split}")})
    elif kind == "manual":
        findings.append({
            "severity": 10, "kind": "manual",
            "message": (f"manual dump "
                        f"({detail.get('reason', 'no reason given')}) "
                        f"— no failure trigger")})

    # ---- time attribution ------------------------------------------
    # on the latency-shaped triggers, name the dominant wall-clock
    # bucket of the last profiled query: "where the time went" is the
    # first question an operator asks a slo_burn/query_hang bundle
    if kind in ("slo_burn", "query_hang", "admission_stall") \
            and bundle.attribution:
        led = bundle.attribution
        buckets = {b: int(v) for b, v in
                   (led.get("buckets") or {}).items() if int(v) > 0}
        dom = led.get("dominant")
        if dom and buckets:
            wall = max(int(led.get("wall_ns", 0)), 1)
            top = sorted(buckets.items(), key=lambda kv: -kv[1])[:3]
            split = ", ".join(
                f"{b} {v / 1e6:.1f} ms ({100 * v / wall:.0f}%)"
                for b, v in top)
            msg = (f"where the wall went (query "
                   f"{led.get('query_id', '?')!r}, tenant "
                   f"{led.get('tenant', '?')!r}): dominant bucket "
                   f"{dom} — {split}")
            if not led.get("conserved", True):
                msg += (f"; CONSERVATION BROKEN (overcount "
                        f"{int(led.get('overcount_ns', 0)) / 1e6:.1f}"
                        f" ms) — bucket seams double-counted")
            findings.append({"severity": 71, "kind": "attribution",
                             "message": msg})

    # ---- memory-leak journal history --------------------------------
    for r in bundle.journal:
        if r.get("kind") == "memory_leak" and kind != "memory_leak":
            findings.append({
                "severity": 85, "kind": "memory_leak",
                "message": (f"task {r.get('task')} finished still "
                            f"holding "
                            f"{_fmt_bytes(r.get('leaked_bytes', 0))} "
                            f"device memory")})

    # ---- lifeguard journal history ----------------------------------
    opened = [r for r in bundle.journal
              if r.get("kind") == "server_quarantine"
              and r.get("event") in ("opened", "reopened")]
    if opened and kind != "query_hang":
        last = opened[-1]
        findings.append({
            "severity": 72, "kind": "poison_query",
            "message": (f"poison query quarantined earlier: signature "
                        f"{last.get('signature')} "
                        f"({last.get('reason', '?')} x"
                        f"{last.get('strikes', '?')})")})
    watchdog = [r for r in bundle.journal
                if r.get("kind") == "server_watchdog"]
    hangs = [r for r in watchdog if r.get("action") == "hang_release"]
    if hangs and kind != "query_hang":
        last = hangs[-1]
        findings.append({
            "severity": 70, "kind": "query_hang",
            "message": (f"{len(hangs)} hung worker(s) released by the "
                        f"lifeguard (last: tenant "
                        f"{last.get('tenant')!r} query "
                        f"{last.get('query')!r} silent "
                        f"{last.get('silent_ms', '?')} ms)")})

    # ---- blocked threads + held memory from the ledger --------------
    for tid, row in sorted(ledger_threads.items()):
        if row.get("state") in ("THREAD_BLOCKED", "THREAD_BUFN"):
            task = row.get("task")
            findings.append({
                "severity": 75, "kind": "blocked_thread",
                "message": (f"thread {tid} (task {task}) is "
                            f"{row['state']} in the OOM state machine "
                            f"holding "
                            f"{_fmt_bytes(row.get('active_bytes', 0))}"
                            )})
    held = [(tid, row) for tid, row in sorted(ledger_threads.items())
            if row.get("active_bytes", 0) > 0
            and row.get("state") not in ("THREAD_BLOCKED",
                                         "THREAD_BUFN")]
    for tid, row in sorted(held, key=lambda kv:
                           -kv[1]["active_bytes"])[:4]:
        findings.append({
            "severity": 70, "kind": "held_memory",
            "message": (f"thread {tid} (task {row.get('task')}, "
                        f"{row.get('state')}) holds "
                        f"{_fmt_bytes(row['active_bytes'])} device "
                        f"memory (watermark "
                        f"{_fmt_bytes(row.get('watermark_bytes', 0))}, "
                        f"{row.get('allocs', 0)} allocs / "
                        f"{row.get('frees', 0)} frees)")})

    # ---- lockdep journal history ------------------------------------
    ld_cycles = [r for r in bundle.journal
                 if r.get("kind") == "lockdep"
                 and r.get("event") == "cycle"]
    if ld_cycles and kind != "lockdep_cycle":
        last = ld_cycles[-1]
        path = " -> ".join(str(c) for c in (last.get("cycle") or []))
        findings.append({
            "severity": 76, "kind": "lockdep_cycle",
            "message": (f"{len(ld_cycles)} lock-order cycle(s) in the "
                        f"journal (last: {path}) — ABBA deadlock "
                        f"potential")})
    ld_blocking = [r for r in bundle.journal
                   if r.get("kind") == "lockdep"
                   and r.get("event") == "blocking"]
    if ld_blocking:
        ops: Dict[str, int] = {}
        for r in ld_blocking:
            ops[str(r.get("op", "?"))] = \
                ops.get(str(r.get("op", "?")), 0) + 1
        summary = ", ".join(f"{op} x{n}"
                            for op, n in sorted(ops.items()))
        held = sorted({str(h) for r in ld_blocking
                       for h in (r.get("held") or [])})
        findings.append({
            "severity": 55, "kind": "lockdep_blocking",
            "message": (f"{len(ld_blocking)} lock-held-across-"
                        f"blocking event(s) ({summary}; locks: "
                        f"{', '.join(held[:4])}) — contending "
                        f"threads stall behind I/O")})

    # ---- spill-store history ---------------------------------------
    spills = [r for r in bundle.journal if r.get("kind") == "spill"]
    if spills:
        by_task: Dict[str, int] = {}
        tiers: Dict[str, int] = {}
        for r in spills:
            by_task[str(r.get("task"))] = \
                by_task.get(str(r.get("task")), 0) + \
                int(r.get("bytes", 0))
            tiers[str(r.get("tier", "?"))] = \
                tiers.get(str(r.get("tier", "?")), 0) + 1
        top_task, top_bytes = max(by_task.items(), key=lambda kv: kv[1])
        restores = sum(1 for r in bundle.journal
                       if r.get("kind") == "spill_restore")
        tier_s = ", ".join(f"{t} x{n}" for t, n in sorted(tiers.items()))
        findings.append({
            "severity": 60, "kind": "spill_pressure",
            "message": (f"{len(spills)} spill(s) through the tiered "
                        f"store ({tier_s}; {restores} restore(s)) — "
                        f"top spiller task {top_task} pushed "
                        f"{_fmt_bytes(top_bytes)} down-tier; the query "
                        f"ran THROUGH memory pressure (out-of-core), "
                        f"raise SPARK_RAPIDS_TPU_DEVICE_BUDGET_BYTES "
                        f"or add device memory to run in-core")})
    spill_corrupt = [r for r in bundle.journal
                     if r.get("kind") == "spill_corrupt"]
    if spill_corrupt:
        last = spill_corrupt[-1]
        findings.append({
            "severity": 78, "kind": "spill_corrupt",
            "message": (f"{len(spill_corrupt)} corrupt spill "
                        f"payload(s) on read-back (last: "
                        f"{last.get('path') or last.get('name', '?')} "
                        f"generation {last.get('generation', '?')}, "
                        f"outcome {last.get('outcome', '?')}) — "
                        f"recomputed from source when possible; check "
                        f"the spill volume for failing media")})

    # ---- kudo corruption history ------------------------------------
    corrupt = [r for r in bundle.journal
               if r.get("kind") == "kudo_corrupt"]
    if corrupt and kind != "kudo_corrupt":
        skipped = sum(r.get("skipped_bytes", 0) for r in corrupt)
        findings.append({
            "severity": 65, "kind": "kudo_corrupt",
            "message": (f"{len(corrupt)} kudo corruption event(s) in "
                        f"the journal ({_fmt_bytes(skipped)} resync-"
                        f"skipped)")})

    # ---- fleet journal history (dead / slow / hot) ------------------
    deaths = [r for r in bundle.journal
              if r.get("kind") == "fleet_membership"
              and r.get("change") == "death"]
    if deaths and kind != "fleet_incident":
        last = deaths[-1]
        findings.append({
            "severity": 72, "kind": "fleet_incident",
            "message": (f"{len(deaths)} fleet death event(s) in the "
                        f"journal — dead rank(s) "
                        f"{sorted({d for r in deaths for d in (r.get('dead') or [])})} "
                        f"(last at epoch {last.get('epoch')}, moved "
                        f"{last.get('moved') or {}})")})
    specs = [r for r in bundle.journal
             if r.get("kind") == "fleet_speculation"]
    if specs:
        by_owner: Dict[str, List[dict]] = {}
        for r in specs:
            by_owner.setdefault(str(r.get("owner")), []).append(r)
        slowest = max(by_owner.items(), key=lambda kv: len(kv[1]))
        won = sum(1 for r in specs if r.get("outcome") == "won")
        findings.append({
            "severity": 62, "kind": "fleet_straggler",
            "message": (f"slow rank {slowest[0]}: "
                        f"{len(slowest[1])} partition(s) "
                        f"speculatively re-executed ({won} "
                        f"speculation(s) won fleet-wide; evidence: "
                        f"{slowest[1][-1].get('evidence', {})})")})
    resplits = [r for r in bundle.journal
                if r.get("kind") == "fleet_resplit"]
    if resplits:
        last = resplits[-1]
        findings.append({
            "severity": 48, "kind": "fleet_skew",
            "message": (f"{len(resplits)} hot partition(s) re-split "
                        f"(last: op {last.get('op')} part "
                        f"{last.get('part')} -> {last.get('nsub')} "
                        f"sub-partitions, {last.get('bytes', 0)} "
                        f"bytes)")})

    # ---- stage stragglers from the span ring ------------------------
    stages: Dict[str, List[int]] = {}
    for r in bundle.spans:
        if r.get("span_kind") == "stage":
            stages.setdefault(r.get("name", "?"), []).append(
                int(r.get("dur_ns", 0)))
    for name, durs in sorted(stages.items()):
        if len(durs) < STRAGGLER_MIN_SAMPLES:
            continue
        xs = sorted(durs)
        p50 = xs[len(xs) // 2]
        p99 = xs[min(len(xs) - 1, int(len(xs) * 0.99))]
        if p50 > 0 and p99 / p50 >= STRAGGLER_RATIO:
            findings.append({
                "severity": 60, "kind": "straggler_stage",
                "message": (f"stage {name!r} p99 {p99 / p50:.1f}x p50 "
                            f"({p99 / 1e6:.1f} ms vs "
                            f"{p50 / 1e6:.1f} ms over {len(xs)} "
                            f"spans)")})

    # ---- slowest plan node from the frozen query profile ------------
    prof = bundle.profile or {}
    pstages = prof.get("stages") or []
    if pstages:
        hot = max(pstages, key=lambda s: int(s.get("wall_ns", 0)))
        wall = int(prof.get("wall_ns", 0))
        stage_ns = int(hot.get("wall_ns", 0))
        pct = (f" ({100 * stage_ns // wall}% of the "
               f"{wall / 1e6:.1f} ms query wall)" if wall else "")
        heavy = ""
        kinds = {}
        for n in hot.get("nodes") or ():
            k = str(n.get("kind", "?"))
            kinds[k] = kinds.get(k, 0) + 1
        if kinds:
            top = sorted(kinds.items(), key=lambda kv: -kv[1])[:3]
            heavy = ("; nodes: "
                     + ", ".join(f"{k} x{v}" for k, v in top))
        findings.append({
            "severity": 58, "kind": "slow_plan_node",
            "message": (f"slowest plan node: stage "
                        f"{hot.get('stage')!r} "
                        f"[{hot.get('engine', '?')}] "
                        f"{stage_ns / 1e6:.1f} ms{pct} in query "
                        f"{prof.get('query_id')!r} "
                        f"({prof.get('query') or '?'})"
                        f"{heavy}")})

    # ---- retry pressure short of the trigger ------------------------
    episodes = [r for r in bundle.journal
                if r.get("kind") == "retry_episode"]
    if len(episodes) >= STORM_THRESHOLD and kind != "retry_storm":
        sections = sorted({str(r.get("name", "?")) for r in episodes})
        findings.append({
            "severity": 50, "kind": "retry_pressure",
            "message": (f"{len(episodes)} failed retry episodes in "
                        f"the journal window (sections: "
                        f"{', '.join(sections[:6])})")})

    # ---- monitor sampler liveness -----------------------------------
    # srt_monitor_last_sample_age_s is recomputed at exposition time
    # (bundle freeze included), so a dead/stalled Monitor thread shows
    # a GROWING age here — stale gauges must not masquerade as a
    # healthy-but-idle system.  No series at all means no Monitor ran,
    # which is not itself a fault.
    reg = (bundle.metrics or {}).get("registry") or {}
    age_fam = reg.get("srt_monitor_last_sample_age_s") or {}
    for s in age_fam.get("series", []):
        age = float(s.get("value", 0.0))
        if age >= STALLED_SAMPLER_S:
            findings.append({
                "severity": 68, "kind": "stalled_sampler",
                "message": (f"telemetry sampler stalled: the Monitor "
                            f"thread last sampled {age:.1f}s before "
                            f"this freeze — every gauge and window "
                            f"after that is stale, not calm")})

    # ---- evidence-quality notes -------------------------------------
    jstats = (bundle.metrics or {}).get("journal") or {}
    if jstats.get("dropped", 0) > 0:
        findings.append({
            "severity": 15, "kind": "evidence",
            "message": (f"journal dropped {jstats['dropped']} events "
                        f"before the freeze — earliest history is "
                        f"incomplete")})

    findings.sort(key=lambda f: (-f["severity"], f["kind"],
                                 f["message"]))
    return findings


# -------------------------------------------------------------- render


def render(bundle: Bundle, findings: List[dict]) -> List[str]:
    out: List[str] = []
    trig = bundle.trigger
    out.append(f"srt-doctor: bundle {os.path.basename(bundle.path)}")
    t = trig.get("t_unix_ms")
    out.append(
        f"trigger : {trig.get('kind', '?')} "
        f"severity={trig.get('severity', '?')} "
        f"seq={trig.get('seq', '?')}"
        + (f" at {_fmt_unix_ms(t)}" if t else "")
        + (f" (pid {trig['pid']})" if trig.get("pid") else ""))
    chain = trig.get("cause_chain") or []
    for i, c in enumerate(chain):
        prefix = "cause   : " if i == 0 else "          <- "
        out.append(f"{prefix}{c.get('type')}: {c.get('message')}")
    files = bundle.manifest.get("files") or {}
    if files:
        out.append(f"files   : {len(files)} files, "
                   f"{bundle.manifest.get('total_bytes', 0)} bytes")
    out.append("")
    if not findings:
        out.append("diagnosis: nothing anomalous in this bundle")
        return out
    out.append("diagnosis (most severe first):")
    for i, f in enumerate(findings, 1):
        out.append(f"  {i}. [{f['severity']:>2}] {f['message']}")
    out.append("")
    out.append(f"summary: {findings[0]['message']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srt-doctor",
        description="Diagnose a flight-recorder incident bundle")
    ap.add_argument("bundle",
                    help="incident bundle directory (or the recorder "
                         "output directory holding incident-* dirs)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable findings")
    args = ap.parse_args(argv)

    path = args.bundle
    if not os.path.isdir(path):
        print(f"srt-doctor: {path}: not a directory", file=sys.stderr)
        return 2
    if not is_bundle_dir(path):
        bundles = find_bundles(path)
        if not bundles:
            print(f"srt-doctor: {path}: no incident bundles found",
                  file=sys.stderr)
            return 2
        if len(bundles) > 1 and not args.json:
            print(f"({len(bundles)} bundles in {path}; diagnosing the "
                  f"most recent)")
        path = bundles[-1]

    bundle = Bundle(path)
    findings = analyze(bundle)
    if args.json:
        print(json.dumps({"bundle": path,
                          "trigger": bundle.trigger,
                          "findings": findings},
                         indent=2, sort_keys=True))
    else:
        print("\n".join(render(bundle, findings)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
