"""Render a per-task / per-op summary from an observability journal
dump (the analyst-facing half of the exposition story; the
reference's counterpart is the profile converter's text report mode
plus the task-level numbers Spark pulls through RmmSpark.getAndReset*).

Input: JSONL files written by
``spark_rapids_tpu_torch.observability.dump_journal_jsonl`` (or the shim's
``metrics_journal_dump``): raw journal events interleaved with one
``task_rollup`` record per task and a final ``registry_snapshot``.
Unknown kinds are counted, never fatal — the journal schema is allowed
to grow ahead of this tool.

Usage:
    python -m spark_rapids_tpu_torch.tools.metrics_report journal.jsonl
    python -m spark_rapids_tpu_torch.tools.metrics_report journal.jsonl --json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional


def load_jsonl(paths: Iterable[str]) -> List[dict]:
    from spark_rapids_tpu_torch.tools import expand_bundle_input, read_jsonl

    records: List[dict] = []
    for p0 in paths:
        # a flight-recorder incident bundle directory stands in for
        # its journal.jsonl — frozen incidents feed the same report
        for p in expand_bundle_input(p0, "journal"):
            records.extend(read_jsonl(p))
    return records


def split_records(records: List[dict]):
    """(task_rollups, registry_snapshot, events)."""
    rollups: Dict[int, dict] = {}
    registry = None
    events: List[dict] = []
    for r in records:
        kind = r.get("kind")
        if kind == "task_rollup":
            rollups[int(r.get("task", -1))] = r
        elif kind == "registry_snapshot":
            registry = r.get("registry")
        elif kind in ("timeseries_snapshot", "slo_status"):
            pass  # telemetry-plane records: extract_telemetry reads them
        else:
            events.append(r)
    return rollups, registry, events


def extract_telemetry(records: List[dict]):
    """(timeseries_snapshot, slo_status) from a journal dump — the
    records dump_journal_jsonl appends when the telemetry
    plane is armed.  Either may be None; the slo status embedded in a
    timeseries snapshot is honored when no standalone record exists."""
    timeseries = None
    slo = None
    for r in records:
        kind = r.get("kind")
        if kind == "timeseries_snapshot":
            timeseries = r
            if slo is None and r.get("slo"):
                slo = r["slo"]
        elif kind == "slo_status":
            slo = r.get("slo")
    return timeseries, slo


def _ms(ns: int) -> str:
    return f"{ns / 1e6:.3f}"


def histogram_quantile(buckets: List[float], bucket_counts: List[int],
                       q: float) -> float:
    """Estimate the q-quantile (0..1) from PER-BUCKET (non-cumulative)
    counts, the registry snapshot's `bucket_counts` format — NOT the
    cumulative `_bucket` values of Prometheus text exposition.  Same
    estimation rule as `histogram_quantile`: linear interpolation
    within the target bucket; the +Inf bucket clamps to the largest
    finite bound, an underestimate by construction."""
    total = sum(bucket_counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, n in enumerate(bucket_counts):
        if cum + n >= target and n > 0:
            if i >= len(buckets):          # +Inf bucket
                return float(buckets[-1]) if buckets else 0.0
            lo = float(buckets[i - 1]) if i > 0 else 0.0
            hi = float(buckets[i])
            return lo + (hi - lo) * (target - cum) / n
        cum += n
    return float(buckets[-1]) if buckets else 0.0


def histogram_rows(registry: Optional[dict]) -> List[dict]:
    """Flatten every histogram family in a registry snapshot into rows
    with count/sum and p50/p95/p99 estimates (ns)."""
    rows: List[dict] = []
    for name, fam in sorted((registry or {}).items()):
        if fam.get("kind") != "histogram":
            continue
        buckets = fam.get("buckets", [])
        for s in fam.get("series", []):
            if not s.get("count"):
                continue
            bc = s.get("bucket_counts", [])
            rows.append({
                "family": name,
                "labels": dict(zip(fam.get("labels", []),
                                   s.get("labels", []))),
                "count": s["count"],
                "sum_ns": s.get("sum", 0),
                "p50_ns": histogram_quantile(buckets, bc, 0.50),
                "p95_ns": histogram_quantile(buckets, bc, 0.95),
                "p99_ns": histogram_quantile(buckets, bc, 0.99),
            })
    return rows


def empty_histogram_families(registry: Optional[dict]) -> List[str]:
    """Histogram families present in the snapshot with NO counted
    series (registered but never fired)."""
    out = []
    for name, fam in sorted((registry or {}).items()):
        if fam.get("kind") != "histogram":
            continue
        if not any(s.get("count") for s in fam.get("series", [])):
            out.append(name)
    return out


def render_histogram_table(registry: Optional[dict]) -> List[str]:
    """Latency-distribution table: one row per histogram series —
    op-latency and the span-duration families both land here.
    Families that exist but never fired render as '-' rows instead of
    vanishing, so a golden diff over two runs stays stable when a
    family is registered in one and fired only in the other."""
    rows = histogram_rows(registry)
    empty = empty_histogram_families(registry)
    out = ["", "latency histograms (p50/p95/p99 estimated from buckets)",
           ""]
    if not rows and not empty:
        out.append("(no histogram series recorded)")
        return out
    names = ["{}{{{}}}".format(
        r["family"],
        ",".join(f"{k}={v}" for k, v in r["labels"].items()))
        if r["labels"] else r["family"] for r in rows]
    w = max(len(n) for n in names + empty)
    out.append(f"{'series':<{w}}  {'count':>7}  {'p50_us':>9}  "
               f"{'p95_us':>9}  {'p99_us':>9}  {'total_ms':>10}")
    order = sorted(range(len(rows)),
                   key=lambda i: -rows[i]["sum_ns"])
    for i in order:
        r = rows[i]
        out.append(f"{names[i]:<{w}}  {r['count']:>7}  "
                   f"{r['p50_ns'] / 1e3:>9.1f}  "
                   f"{r['p95_ns'] / 1e3:>9.1f}  "
                   f"{r['p99_ns'] / 1e3:>9.1f}  "
                   f"{_ms(r['sum_ns']):>10}")
    for name in empty:   # stable alphabetical tail after live rows
        out.append(f"{name:<{w}}  {'-':>7}  {'-':>9}  {'-':>9}  "
                   f"{'-':>9}  {'-':>10}")
    return out


def render_task_table(rollups: Dict[int, dict]) -> List[str]:
    out = ["per-task summary", ""]
    hdr = (f"{'task':>6}  {'op_calls':>8}  {'op_ms':>10}  "
           f"{'shuf_wr_B':>10}  {'mrg_rows':>8}  {'retry':>5}  "
           f"{'split':>5}  {'blocked_ms':>10}  {'max_mem_B':>10}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for task in sorted(rollups):
        r = rollups[task]
        ops = r.get("ops", {})
        calls = sum(o.get("calls", 0) for o in ops.values())
        op_ns = sum(o.get("time_ns", 0) for o in ops.values())
        name = "driver" if task == -1 else str(task)
        out.append(
            f"{name:>6}  {calls:>8}  {_ms(op_ns):>10}  "
            f"{r.get('shuffle_write_bytes', 0):>10}  "
            f"{r.get('shuffle_merge_rows', 0):>8}  "
            f"{r.get('retry_oom', 0):>5}  "
            f"{r.get('split_retry_oom', 0):>5}  "
            f"{_ms(r.get('blocked_time_ns', 0)):>10}  "
            f"{r.get('max_device_memory', 0):>10}")
    return out


def render_op_table(rollups: Dict[int, dict]) -> List[str]:
    """Per-op rows aggregated across tasks, busiest first."""
    agg: Dict[str, dict] = {}
    for r in rollups.values():
        for op, o in r.get("ops", {}).items():
            a = agg.setdefault(op, {"calls": 0, "time_ns": 0})
            a["calls"] += o.get("calls", 0)
            a["time_ns"] += o.get("time_ns", 0)
    out = ["", "per-op summary (all tasks)", ""]
    if not agg:
        out.append("(no op activity recorded)")
        return out
    w = max(len(op) for op in agg)
    out.append(f"{'op':<{w}}  {'calls':>6}  {'total_ms':>10}  {'avg_us':>8}")
    for op, a in sorted(agg.items(), key=lambda kv: -kv[1]["time_ns"]):
        avg_us = a["time_ns"] / max(a["calls"], 1) / 1e3
        out.append(f"{op:<{w}}  {a['calls']:>6}  "
                   f"{_ms(a['time_ns']):>10}  {avg_us:>8.1f}")
    return out


def jit_cache_rows(registry: Optional[dict]) -> List[dict]:
    """Per-kernel compile-cache counters (srt_jit_cache_*) from a
    registry snapshot, busiest kernel first, with a derived hit rate.
    Compile-time distributions live in the srt_jit_compile_ns rows of
    the histogram table."""
    agg: Dict[str, dict] = {}
    for metric, field in (("srt_jit_cache_hits_total", "hits"),
                          ("srt_jit_cache_misses_total", "misses"),
                          ("srt_jit_cache_evictions_total", "evictions")):
        fam = (registry or {}).get(metric)
        if not fam:
            continue
        for s in fam.get("series", []):
            kernel = s["labels"][0] if s.get("labels") else "?"
            a = agg.setdefault(kernel, {"kernel": kernel, "hits": 0,
                                        "misses": 0, "evictions": 0})
            a[field] = int(s.get("value", 0))
    rows = []
    for a in agg.values():
        total = a["hits"] + a["misses"]
        a["hit_rate"] = a["hits"] / total if total else 0.0
        rows.append(a)
    return sorted(rows, key=lambda a: -(a["hits"] + a["misses"]))


def render_jit_cache_table(registry: Optional[dict]) -> List[str]:
    """Kernel compile-cache summary: a cold cache (hit rate ~0) on a
    steady workload is the shape-bucketing regression signal."""
    rows = jit_cache_rows(registry)
    out = ["", "jit compile cache (srt_jit_cache_*)", ""]
    if not rows:
        out.append("(no compile-cache activity recorded)")
        return out
    w = max(len(r["kernel"]) for r in rows)
    hdr = (f"{'kernel':<{w}}  {'hits':>7}  {'misses':>7}  "
           f"{'evict':>6}  {'hit_rate':>8}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in rows:
        out.append(f"{r['kernel']:<{w}}  {r['hits']:>7}  "
                   f"{r['misses']:>7}  {r['evictions']:>6}  "
                   f"{r['hit_rate']:>8.2f}")
    return out


def result_cache_rows(registry: Optional[dict]) -> List[dict]:
    """Per-(scope, tenant) semantic-cache counters
    (srt_result_cache_*) from a registry snapshot, busiest row first,
    with a derived hit rate.  Result-scope rows carry real tenants
    (the per-tenant warm-hit attribution the soak gate reads);
    stage/subplan rows aggregate under '-'."""
    agg: Dict[tuple, dict] = {}
    for metric, field in (("srt_result_cache_hits_total", "hits"),
                          ("srt_result_cache_misses_total", "misses")):
        fam = (registry or {}).get(metric)
        if not fam:
            continue
        for s in fam.get("series", []):
            labels = s.get("labels") or ("?", "?")
            scope = labels[0] if len(labels) > 0 else "?"
            tenant = labels[1] if len(labels) > 1 else "-"
            a = agg.setdefault((scope, tenant),
                               {"scope": scope, "tenant": tenant,
                                "hits": 0, "misses": 0})
            a[field] = int(s.get("value", 0))
    rows = []
    for a in agg.values():
        total = a["hits"] + a["misses"]
        a["hit_rate"] = a["hits"] / total if total else 0.0
        rows.append(a)
    rows.sort(key=lambda a: -(a["hits"] + a["misses"]))
    # cache-wide totals ride along so --json consumers see folds and
    # evictions without re-deriving them from other families
    folds = sum(int(s.get("value", 0)) for s in
                ((registry or {}).get(
                    "srt_result_cache_incremental_folds_total")
                 or {}).get("series", []))
    evictions = sum(int(s.get("value", 0)) for s in
                    ((registry or {}).get(
                        "srt_result_cache_evictions_total")
                     or {}).get("series", []))
    if rows or folds or evictions:
        rows.append({"scope": "(total)", "tenant": "-",
                     "hits": sum(r["hits"] for r in rows),
                     "misses": sum(r["misses"] for r in rows),
                     "hit_rate": 0.0, "folds": folds,
                     "evictions": evictions})
        t = rows[-1]
        tot = t["hits"] + t["misses"]
        t["hit_rate"] = t["hits"] / tot if tot else 0.0
    return rows


def render_result_cache_table(registry: Optional[dict]) -> List[str]:
    """Semantic result/subplan cache summary: per-tenant warm-hit
    rates plus the incremental-fold and eviction totals."""
    rows = result_cache_rows(registry)
    out = ["", "result cache (srt_result_cache_*)", ""]
    if not rows:
        out.append("(no result-cache activity recorded)")
        return out
    w = max(len(f"{r['scope']}/{r['tenant']}") for r in rows)
    hdr = (f"{'scope/tenant':<{w}}  {'hits':>7}  {'misses':>7}  "
           f"{'hit_rate':>8}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in rows:
        name = f"{r['scope']}/{r['tenant']}"
        out.append(f"{name:<{w}}  {r['hits']:>7}  {r['misses']:>7}  "
                   f"{r['hit_rate']:>8.2f}")
    total = rows[-1]
    if "folds" in total:
        out.append(f"incremental folds: {total['folds']}  "
                   f"evictions: {total['evictions']}")
    return out


def kernel_path_rows(registry: Optional[dict]) -> List[dict]:
    """Per-op execution counts by the kernel path actually taken
    (srt_kernel_path_total) — the calibrated join/JSON routing
    evidence: an op stuck on ``host``/``host_rank`` at scale is the
    "dead calibration" regression signal."""
    rows: List[dict] = []
    fam = (registry or {}).get("srt_kernel_path_total")
    for s in (fam or {}).get("series", []):
        labels = s.get("labels") or ("?", "?")
        op = labels[0] if len(labels) > 0 else "?"
        path = labels[1] if len(labels) > 1 else "?"
        rows.append({"op": op, "path": path,
                     "count": int(s.get("value", 0))})
    return sorted(rows, key=lambda r: (r["op"], -r["count"], r["path"]))


def render_kernel_path_table(registry: Optional[dict]) -> List[str]:
    rows = kernel_path_rows(registry)
    out = ["", "kernel paths (srt_kernel_path_total)", ""]
    if not rows:
        out.append("(no calibrated kernel-path activity recorded)")
        return out
    w_op = max(len(r["op"]) for r in rows)
    w_p = max(max(len(r["path"]) for r in rows), len("path"))
    hdr = f"{'op':<{w_op}}  {'path':<{w_p}}  {'count':>8}"
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in rows:
        out.append(f"{r['op']:<{w_op}}  {r['path']:<{w_p}}  "
                   f"{r['count']:>8}")
    return out


def stage_rows(events: List[dict]) -> List[dict]:
    """Whole-stage fusion accounting from ``stage_fusion`` journal
    events, one row per (stage, plan digest): executions by engine,
    fused-executable compiles vs cache hits, and the measured
    fused-vs-unfused wall ratio (>1 means fusion is winning).  The
    ``srt_stage_fusion_total{stage,outcome}`` counter carries the same
    outcomes to Prometheus."""
    agg: Dict[tuple, dict] = {}
    for e in events:
        if e.get("kind") != "stage_fusion":
            continue
        key = (str(e.get("stage", "?")), str(e.get("digest", "?")))
        a = agg.setdefault(key, {
            "stage": key[0], "digest": key[1], "nodes": 0,
            "fused": 0, "fused_timed": 0, "unfused": 0,
            "compiles": 0, "fused_ns": 0, "unfused_ns": 0})
        a["nodes"] = max(a["nodes"], int(e.get("nodes", 0)))
        outcome = str(e.get("outcome", "?"))
        if outcome == "fused":
            a["fused"] += 1
            # a run that BUILT its executable has lower+compile inside
            # its wall; folding that into the mean would make a 7x win
            # render as ratio << 1 — only steady-state walls count
            if not e.get("compiled"):
                a["fused_timed"] += 1
                a["fused_ns"] += int(e.get("wall_ns", 0))
        elif outcome == "unfused":
            a["unfused"] += 1
            a["unfused_ns"] += int(e.get("wall_ns", 0))
        if e.get("compiled"):
            a["compiles"] += 1
    rows = []
    for a in agg.values():
        a["cache_hits"] = max(a["fused"] - a["compiles"], 0)
        fused_mean = (a["fused_ns"] / a["fused_timed"]
                      if a["fused_timed"] else 0.0)
        unfused_mean = (a["unfused_ns"] / a["unfused"]
                        if a["unfused"] else 0.0)
        a["ratio"] = (unfused_mean / fused_mean
                      if fused_mean and unfused_mean else 0.0)
        rows.append(a)
    return sorted(rows, key=lambda a: (a["stage"], a["digest"]))


def render_stage_table(events: List[dict]) -> List[str]:
    """Stage-fusion table: one executable per stage, zero compiles on
    repeats, and unfused/fused wall ratio > 1 are the healthy signals;
    a stage stuck on the unfused engine at scale is the 'fusion went
    dead' regression signal."""
    rows = stage_rows(events)
    out = ["", "stage fusion (per stage digest)", ""]
    if not rows:
        out.append("(no stage-fusion activity recorded)")
        return out
    w = max(len(r["stage"]) for r in rows)
    hdr = (f"{'stage':<{w}}  {'digest':<16}  {'nodes':>5}  "
           f"{'fused':>5}  {'unfus':>5}  {'cmpl':>4}  {'hits':>4}  "
           f"{'fused_ms':>9}  {'unfus_ms':>9}  {'ratio':>6}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in rows:
        fused_ms = (r["fused_ns"] / r["fused_timed"] / 1e6
                    if r["fused_timed"] else 0.0)
        unfused_ms = (r["unfused_ns"] / r["unfused"] / 1e6
                      if r["unfused"] else 0.0)
        # run digests are "plan|operands"; show a slice of BOTH
        # halves or same-plan rows at different buckets look identical
        dig = r["digest"]
        if "|" in dig:
            plan_d, ops_d = dig.split("|", 1)
            dig = f"{plan_d[:7]}|{ops_d[:8]}"
        out.append(
            f"{r['stage']:<{w}}  {dig[:16]:<16}  "
            f"{r['nodes']:>5}  {r['fused']:>5}  {r['unfused']:>5}  "
            f"{r['compiles']:>4}  {r['cache_hits']:>4}  "
            f"{fused_ms:>9.3f}  {unfused_ms:>9.3f}  "
            f"{r['ratio']:>6.2f}")
    return out


def retry_episode_rows(events: List[dict]) -> List[dict]:
    """Aggregate retry_episode journal events per driver name:
    episodes, attempts, splits, max split depth, time lost, and the
    outcome breakdown."""
    agg: Dict[str, dict] = {}
    for e in events:
        if e.get("kind") != "retry_episode":
            continue
        name = str(e.get("name", "?"))
        a = agg.setdefault(name, {
            "name": name, "episodes": 0, "attempts": 0, "splits": 0,
            "max_split_depth": 0, "lost_ns": 0, "outcomes": {}})
        a["episodes"] += 1
        a["attempts"] += int(e.get("attempts", 0))
        a["splits"] += int(e.get("splits", 0))
        a["max_split_depth"] = max(a["max_split_depth"],
                                   int(e.get("max_split_depth", 0)))
        a["lost_ns"] += int(e.get("lost_ns", 0))
        out = str(e.get("outcome", "?"))
        a["outcomes"][out] = a["outcomes"].get(out, 0) + 1
    return sorted(agg.values(), key=lambda a: -a["lost_ns"])


def render_retry_table(events: List[dict]) -> List[str]:
    """Retry-episode summary (robustness/retry.py drivers): how often
    sections retried/split, how deep, and what the failures cost."""
    rows = retry_episode_rows(events)
    out = ["", "retry episodes", ""]
    if not rows:
        out.append("(no retry episodes recorded)")
        return out
    w = max(len(r["name"]) for r in rows)
    hdr = (f"{'section':<{w}}  {'episodes':>8}  {'attempts':>8}  "
           f"{'splits':>6}  {'depth':>5}  {'lost_ms':>10}  outcomes")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in rows:
        outcomes = ",".join(f"{k}={v}"
                            for k, v in sorted(r["outcomes"].items()))
        out.append(
            f"{r['name']:<{w}}  {r['episodes']:>8}  "
            f"{r['attempts']:>8}  {r['splits']:>6}  "
            f"{r['max_split_depth']:>5}  {_ms(r['lost_ns']):>10}  "
            f"{outcomes}")
    return out


def server_rows(events: List[dict],
                registry: Optional[dict]) -> List[dict]:
    """Per-(tenant, query) query-server accounting from the
    ``server_*`` journal events, enriched with the registry's
    per-tenant queue-wait p95 and device-byte gauges.  A row with
    query '*' is the tenant rollup."""
    agg: Dict[tuple, dict] = {}

    def row(tenant: str, query: str) -> dict:
        return agg.setdefault((tenant, query), {
            "tenant": tenant, "query": query, "admitted": 0,
            "rejected": 0, "requeued": 0, "success": 0, "failed": 0,
            "cancelled": 0, "shed": 0, "hung": 0, "deadline": 0,
            "dur_ns": 0, "wait_ns": 0})

    for e in events:
        kind = e.get("kind")
        if kind not in ("server_admit", "server_reject",
                        "server_requeue", "server_complete"):
            continue
        tenant = str(e.get("tenant", "?"))
        query = str(e.get("query", "?"))
        targets = [row(tenant, "*")]
        if kind != "server_requeue":   # requeues carry no query name
            targets.append(row(tenant, query))
        for a in targets:
            if kind == "server_admit":
                a["admitted"] += 1
            elif kind == "server_reject":
                a["rejected"] += 1
            elif kind == "server_requeue":
                a["requeued"] += 1
            elif kind == "server_complete":
                outcome = str(e.get("outcome", "?"))
                if outcome in a:
                    a[outcome] += 1
                a["dur_ns"] += int(e.get("dur_ns", 0))
                a["wait_ns"] += int(e.get("wait_ns", 0))
    # registry enrichment: queue-wait p95 + live gauges per tenant
    reg = registry or {}
    waits = reg.get("srt_server_queue_wait_ns") or {}
    buckets = waits.get("buckets", [])
    for s in waits.get("series", []):
        tenant = s["labels"][0] if s.get("labels") else "?"
        a = row(tenant, "*")
        a["p95_wait_ns"] = histogram_quantile(
            buckets, s.get("bucket_counts", []), 0.95)
    for metric, field in (("srt_server_tenant_device_bytes",
                           "device_bytes"),
                          ("srt_server_running", "running"),
                          ("srt_server_queued", "queued")):
        fam = reg.get(metric) or {}
        for s in fam.get("series", []):
            tenant = s["labels"][0] if s.get("labels") else "?"
            row(tenant, "*")[field] = int(s.get("value", 0))
    return sorted(agg.values(),
                  key=lambda a: (a["tenant"], a["query"] != "*",
                                 a["query"]))


def render_server_table(events: List[dict],
                        registry: Optional[dict]) -> List[str]:
    """Query-server tenancy table: admission outcomes, fair-share
    wait, and held device bytes per tenant (rollup row '*') and per
    query — the 'is anyone starved / hogging' one-pager."""
    rows = server_rows(events, registry)
    out = ["", "query server (per tenant / per query)", ""]
    if not rows:
        out.append("(no server activity recorded)")
        return out
    w = max(len(f"{r['tenant']}:{r['query']}") for r in rows)
    hdr = (f"{'tenant:query':<{w}}  {'admit':>5}  {'rej':>4}  "
           f"{'requ':>4}  {'ok':>4}  {'fail':>4}  {'cncl':>4}  "
           f"{'shed':>4}  {'hung':>4}  {'ddl':>3}  {'run':>3}  "
           f"{'p95_wait_ms':>11}  {'dev_bytes':>10}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in rows:
        name = f"{r['tenant']}:{r['query']}"
        p95 = r.get("p95_wait_ns")
        out.append(
            f"{name:<{w}}  {r['admitted']:>5}  {r['rejected']:>4}  "
            f"{r['requeued']:>4}  {r['success']:>4}  "
            f"{r['failed']:>4}  {r['cancelled']:>4}  {r['shed']:>4}  "
            f"{r.get('hung', 0):>4}  {r.get('deadline', 0):>3}  "
            f"{r.get('running', 0):>3}  "
            f"{(p95 / 1e6 if p95 is not None else 0.0):>11.3f}  "
            f"{r.get('device_bytes', 0):>10}")
    return out


def io_rows(events: List[dict],
            registry: Optional[dict]) -> List[dict]:
    """Per-source ingest accounting from ``io_file`` journal events
    (files, pages, rows, bytes, decode throughput), with the
    registry's ``srt_io_read_ns`` p95 on the total row.  A row with
    source '*' is the whole-process rollup."""
    agg: Dict[str, dict] = {}

    def row(source: str) -> dict:
        return agg.setdefault(source, {
            "source": source, "files": 0, "pages": 0, "rows": 0,
            "read_bytes": 0, "decode_ns": 0})

    for e in events:
        if e.get("kind") != "io_file":
            continue
        src = str(e.get("source", "?")).rsplit("/", 1)[-1]
        for a in (row("*"), row(src)):
            a["files"] += 1
            a["pages"] += int(e.get("pages", 0))
            a["rows"] += int(e.get("rows", 0))
            a["read_bytes"] += int(e.get("read_bytes", 0))
            a["decode_ns"] += int(e.get("decode_ns", 0))
    reads = (registry or {}).get("srt_io_read_ns") or {}
    for s in reads.get("series", []):
        a = row("*")
        a["p95_read_ns"] = histogram_quantile(
            reads.get("buckets", []), s.get("bucket_counts", []), 0.95)
        a["reads"] = s.get("count", 0)
    # derived AFTER every row exists (the registry loop above can
    # create the '*' rollup on its own when no io_file event landed)
    for a in agg.values():
        a["decode_mb_s"] = (a["read_bytes"] / 1e6
                            / (a["decode_ns"] / 1e9)
                            if a["decode_ns"] else 0.0)
    return sorted(agg.values(),
                  key=lambda a: (a["source"] != "*", a["source"]))


def render_io_table(events: List[dict],
                    registry: Optional[dict]) -> List[str]:
    """Ingest table: what storage cost per source file (rollup row
    '*') — files, pages, rows, bytes, read p95, decode throughput."""
    rows = io_rows(events, registry)
    out = ["", "io ingest (per source file)", ""]
    if not rows:
        out.append("(no io activity recorded)")
        return out
    w = max(len(r["source"]) for r in rows)
    hdr = (f"{'source':<{w}}  {'files':>5}  {'pages':>5}  "
           f"{'rows':>9}  {'MB':>8}  {'p95_read_ms':>11}  "
           f"{'decode_MB/s':>11}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in rows:
        p95 = r.get("p95_read_ns")
        out.append(
            f"{r['source']:<{w}}  {r['files']:>5}  {r['pages']:>5}  "
            f"{r['rows']:>9}  {r['read_bytes'] / 1e6:>8.2f}  "
            f"{(p95 / 1e6 if p95 is not None else 0.0):>11.3f}  "
            f"{r['decode_mb_s']:>11.1f}")
    return out


def fleet_rows(events: List[dict],
               registry: Optional[dict]) -> dict:
    """Elastic-fleet accounting: per-peer link bytes (+ dup drops and
    observed deaths), the fleet skew ratio (max/median of per-peer
    recv bytes), speculation outcomes, rebalances, re-splits, and the
    membership epoch — the fleet's evidence surface."""
    reg = registry or {}

    def series(name: str) -> List[dict]:
        return (reg.get(name) or {}).get("series", [])

    peers: Dict[str, dict] = {}

    def peer(p: str) -> dict:
        return peers.setdefault(p, {
            "peer": p, "send_bytes": 0, "recv_bytes": 0,
            "dup_dropped": 0, "deaths": 0, "stale_naks": 0})

    for s in series("srt_shuffle_link_bytes_total"):
        d, p = (list(s.get("labels", ())) + ["?", "?"])[:2]
        key = "send_bytes" if d == "send" else "recv_bytes"
        peer(p)[key] += int(s.get("value", 0))
    for name, key in (("srt_shuffle_dup_dropped_total",
                       "dup_dropped"),
                      ("srt_fleet_deaths_total", "deaths"),
                      ("srt_fleet_stale_naks_total", "stale_naks")):
        for s in series(name):
            p = (list(s.get("labels", ())) + ["?"])[0]
            peer(p)[key] += int(s.get("value", 0))
    recv = sorted(r["recv_bytes"] for r in peers.values()
                  if r["recv_bytes"] > 0)
    med = recv[(len(recv) - 1) // 2] if recv else 0  # lower median
    skew = (round(recv[-1] / med, 2)
            if len(recv) >= 2 and med > 0 else None)
    spec = {"won": 0, "lost": 0, "cancelled": 0}
    for s in series("srt_fleet_speculations_total"):
        lab = (list(s.get("labels", ())) + ["?"])[0]
        if lab in spec:
            spec[lab] += int(s.get("value", 0))
    epoch_series = series("srt_fleet_epoch")
    epoch = int(epoch_series[0]["value"]) if epoch_series else 0
    rebalances = sum(int(s.get("value", 0)) for s in
                     series("srt_fleet_rebalances_total"))
    resplits = sum(int(s.get("value", 0)) for s in
                   series("srt_fleet_resplits_total"))
    memberships = [
        {"change": e.get("change"), "dead": e.get("dead"),
         "joined": e.get("joined"), "epoch": e.get("epoch"),
         "moved": e.get("moved")}
        for e in events if e.get("kind") == "fleet_membership"]
    return {
        "peers": sorted(peers.values(), key=lambda r: r["peer"]),
        "skew_ratio": skew,
        "speculations": spec,
        "rebalances": rebalances,
        "resplits": resplits,
        "epoch": epoch,
        "memberships": memberships,
    }


def render_fleet_table(events: List[dict],
                       registry: Optional[dict]) -> List[str]:
    """Fleet table: per-peer wire bytes + dedup/death evidence, then
    the one-line elasticity summary (epoch, rebalances, speculation
    won/lost, re-splits, skew)."""
    f = fleet_rows(events, registry)
    out = ["", "fleet (elastic shuffle)", ""]
    if not f["peers"] and not f["memberships"]:
        out.append("(no fleet activity recorded)")
        return out
    hdr = (f"{'peer':>4}  {'send_MB':>8}  {'recv_MB':>8}  "
           f"{'dup_drop':>8}  {'deaths':>6}  {'stale':>5}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in f["peers"]:
        out.append(
            f"{r['peer']:>4}  {r['send_bytes'] / 1e6:>8.2f}  "
            f"{r['recv_bytes'] / 1e6:>8.2f}  {r['dup_dropped']:>8}  "
            f"{r['deaths']:>6}  {r['stale_naks']:>5}")
    spec = f["speculations"]
    out.append("")
    out.append(
        f"epoch {f['epoch']}  rebalances {f['rebalances']}  "
        f"speculations won/lost/cancelled "
        f"{spec['won']}/{spec['lost']}/{spec['cancelled']}  "
        f"resplits {f['resplits']}  "
        f"skew_ratio {f['skew_ratio'] if f['skew_ratio'] else '-'}")
    for m in f["memberships"][:8]:
        what = (f"dead={m['dead']}" if m["change"] == "death"
                else f"joined={m['joined']}")
        out.append(f"  membership: {m['change']} {what} "
                   f"epoch={m['epoch']} moved={m['moved'] or {}}")
    return out


def render_event_table(events: List[dict]) -> List[str]:
    counts: Dict[str, int] = {}
    for e in events:
        k = e.get("kind", "?")
        counts[k] = counts.get(k, 0) + 1
    out = ["", "journal events", ""]
    if not counts:
        out.append("(journal empty)")
        return out
    w = max(len(k) for k in counts)
    for k in sorted(counts, key=lambda k: -counts[k]):
        out.append(f"{k:<{w}}  {counts[k]}")
    ooms = [e for e in events
            if e.get("kind") in ("oom_retry", "oom_split_retry")]
    if ooms:
        out.append("")
        out.append("oom events (most recent last):")
        for e in ooms[-10:]:
            out.append(
                f"  {e.get('kind')}: task={e.get('task')} "
                f"thread={e.get('thread')} device={e.get('device')}"
                f"{' injected' if e.get('injected') else ''}")
    return out


def window_rows(timeseries: Optional[dict],
                registry: Optional[dict],
                n: int = 12) -> List[dict]:
    """Recent-rate rows: for every counter family that moved in the
    last ``n`` windows, the windowed delta + per-second rate NEXT TO
    the since-boot total (the distinction this PR exists to surface).
    Histogram families get windowed p50/p99 alongside the cumulative
    estimates — recent percentiles from per-window buckets, never the
    diluted since-boot distribution.  A registry histogram family with
    ZERO samples in the window still gets a row, with ``None``
    percentiles (rendered ``-``): quiet-right-now is a reading, and
    substituting the since-boot distribution would claim recency the
    data does not have."""
    if timeseries is None:
        return []
    windows = (timeseries.get("windows") or [])[-n:]
    if not windows:
        return []
    dur = max(sum(w.get("dur_s", 0.0) for w in windows), 1e-9)
    counters: Dict[str, float] = {}
    hists: Dict[str, dict] = {}
    for w in windows:
        for fam, vals in w.get("counters", {}).items():
            counters[fam] = counters.get(fam, 0) + sum(vals.values())
        for fam, h in w.get("histograms", {}).items():
            acc = hists.setdefault(fam, {
                "buckets": h["buckets"],
                "bucket_counts": [0] * (len(h["buckets"]) + 1),
                "sum": 0, "count": 0})
            for s in h["series"].values():
                for i, c in enumerate(s["bucket_counts"]):
                    acc["bucket_counts"][i] += c
                acc["sum"] += s["sum"]
                acc["count"] += s["count"]
    rows: List[dict] = []
    for fam in sorted(counters):
        total = None
        f = (registry or {}).get(fam)
        if f and f.get("kind") == "counter":
            total = sum(s.get("value", 0)
                        for s in f.get("series", []))
        rows.append({"family": fam, "kind": "counter",
                     "recent": counters[fam],
                     "rate_s": round(counters[fam] / dur, 3),
                     "since_boot": total})
    hist_fams = set(hists)
    for fam, f in (registry or {}).items():
        if f.get("kind") == "histogram":
            hist_fams.add(fam)
    for fam in sorted(hist_fams):
        h = hists.get(fam)
        cum_p99 = None
        f = (registry or {}).get(fam)
        if f and f.get("kind") == "histogram":
            bc = [0] * (len(f.get("buckets", [])) + 1)
            for s in f.get("series", []):
                for i, c in enumerate(s.get("bucket_counts", [])):
                    bc[i] += c
            if sum(bc):
                cum_p99 = histogram_quantile(f.get("buckets", []),
                                             bc, 0.99)
        count = h["count"] if h else 0
        rows.append({
            "family": fam, "kind": "histogram",
            "recent": count,
            # zero window samples -> None, NOT a since-boot stand-in
            "recent_p50_ns": (histogram_quantile(
                h["buckets"], h["bucket_counts"], 0.50)
                if h and count else None),
            "recent_p99_ns": (histogram_quantile(
                h["buckets"], h["bucket_counts"], 0.99)
                if h and count else None),
            "since_boot_p99_ns": cum_p99})
    return rows


def render_window_table(timeseries: Optional[dict],
                        registry: Optional[dict],
                        n: int = 12) -> List[str]:
    rows = window_rows(timeseries, registry, n)
    out = ["", f"recent window (last {n} windows of the timeseries "
               "ring; rates are per second)", ""]
    if not rows:
        out.append("(no timeseries_snapshot record in input — run "
                   "with SPARK_RAPIDS_TPU_TIMESERIES=1)")
        return out
    w = max(len(r["family"]) for r in rows)
    out.append(f"{'family':<{w}}  {'recent':>10}  {'rate/s':>10}  "
               f"{'since_boot':>12}  {'w_p50_us':>9}  {'w_p99_us':>9}  "
               f"{'boot_p99_us':>11}")
    for r in rows:
        if r["kind"] == "counter":
            boot = "-" if r["since_boot"] is None \
                else f"{r['since_boot']}"
            out.append(f"{r['family']:<{w}}  {r['recent']:>10}  "
                       f"{r['rate_s']:>10.2f}  {boot:>12}  "
                       f"{'-':>9}  {'-':>9}  {'-':>11}")
        else:
            boot99 = "-" if r["since_boot_p99_ns"] is None \
                else f"{r['since_boot_p99_ns'] / 1e3:.1f}"
            p50 = "-" if r["recent_p50_ns"] is None \
                else f"{r['recent_p50_ns'] / 1e3:.1f}"
            p99 = "-" if r["recent_p99_ns"] is None \
                else f"{r['recent_p99_ns'] / 1e3:.1f}"
            out.append(f"{r['family']:<{w}}  {r['recent']:>10}  "
                       f"{'-':>10}  {'-':>12}  "
                       f"{p50:>9}  "
                       f"{p99:>9}  "
                       f"{boot99:>11}")
    return out


def stats_rows(events: List[dict],
               registry: Optional[dict]) -> dict:
    """Data-statistics plane fold: per-(stage, node)
    misestimates (latest journal event wins) + per-tenant delivered
    rows from the registry."""
    latest: Dict[tuple, dict] = {}
    for e in events:
        if e.get("kind") != "cardinality_misestimate":
            continue
        latest[(str(e.get("stage", "?")), str(e.get("node", "?")))] = {
            "est": e.get("est"), "actual": e.get("actual"),
            "ratio": e.get("ratio")}
    fam = (registry or {}).get("srt_stats_rows_total") or {}
    tenant_rows = {s["labels"][0]: s.get("value", 0)
                   for s in fam.get("series", []) if s.get("labels")}
    return {
        "observations": sum(1 for e in events
                            if e.get("kind") == "node_stats"),
        "misestimates": [
            {"stage": k[0], "node": k[1], **v}
            for k, v in sorted(latest.items())],
        "tenant_rows": tenant_rows,
    }


def render_stats_table(events: List[dict],
                       registry: Optional[dict]) -> List[str]:
    d = stats_rows(events, registry)
    out = ["", "data statistics (cardinality est vs actual; rows past "
               "SPARK_RAPIDS_TPU_STATS_MISEST_RATIO are misestimates)",
           ""]
    mis = d["misestimates"]
    if mis:
        w = max(max(len(m["stage"]) for m in mis), len("stage"))
        wn = max(max(len(m["node"]) for m in mis), len("node"))
        hdr = (f"{'stage':<{w}}  {'node':<{wn}}  {'est':>12}  "
               f"{'actual':>12}  {'ratio':>8}")
        out.append(hdr)
        out.append("-" * len(hdr))
        for m in mis:
            out.append(f"{m['stage']:<{w}}  {m['node']:<{wn}}  "
                       f"{m.get('est', 0):>12}  "
                       f"{m.get('actual', 0):>12}  "
                       f"x{m.get('ratio', 0):>7}")
    else:
        out.append(f"(no misestimates; {d['observations']} "
                   f"node_stats observation event(s))")
    if d["tenant_rows"]:
        out.append("rows delivered: " + "  ".join(
            f"{t}={v}" for t, v in sorted(d["tenant_rows"].items())))
    return out


def render_slo_table(slo: Optional[dict]) -> List[str]:
    out = ["", "per-tenant SLO (burn = bad fraction / error budget; "
               "fires when fast AND slow exceed threshold)", ""]
    if not slo:
        out.append("(no SLO status in input — run with "
                   "SPARK_RAPIDS_TPU_SLO=1)")
        return out
    w = max(max(len(t) for t in slo), len("tenant"))
    hdr = (f"{'tenant':<{w}}  {'target_ms':>9}  {'objective':>9}  "
           f"{'events':>7}  {'attainment':>10}  {'burn_fast':>9}  "
           f"{'burn_slow':>9}  {'breaches':>8}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for t in sorted(slo):
        r = slo[t]
        out.append(f"{t:<{w}}  {r.get('latency_target_ms', 0):>9.1f}  "
                   f"{r.get('objective', 0):>9.3f}  "
                   f"{r.get('events', 0):>7}  "
                   f"{r.get('attainment', 0):>10.4f}  "
                   f"{r.get('burn_fast', 0):>9.2f}  "
                   f"{r.get('burn_slow', 0):>9.2f}  "
                   f"{r.get('breaches', 0):>8}")
    return out


def build_report(records: List[dict]) -> dict:
    """Machine-readable report (the --json output)."""
    rollups, registry, events = split_records(records)
    timeseries, slo = extract_telemetry(records)
    counts: Dict[str, int] = {}
    for e in events:
        k = e.get("kind", "?")
        counts[k] = counts.get(k, 0) + 1
    return {
        "tasks": {str(t): {k: v for k, v in r.items() if k != "kind"}
                  for t, r in rollups.items()},
        "event_counts": counts,
        "has_registry_snapshot": registry is not None,
        "histograms": histogram_rows(registry),
        "retry_episodes": retry_episode_rows(events),
        "jit_cache": jit_cache_rows(registry),
        "cache": result_cache_rows(registry),
        "kernel_paths": kernel_path_rows(registry),
        "stages": stage_rows(events),
        "server": server_rows(events, registry),
        "io": io_rows(events, registry),
        "fleet": fleet_rows(events, registry),
        "stats": stats_rows(events, registry),
        "slo": slo,
        "window": window_rows(timeseries, registry),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-task/per-op report from an observability "
                    "journal dump")
    ap.add_argument("inputs", nargs="+", help="journal JSONL files")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of tables")
    ap.add_argument("--window", type=int, nargs="?", const=12,
                    default=None, metavar="N",
                    help="render recent-rate/windowed-percentile "
                         "columns from the timeseries ring (last N "
                         "windows, default 12)")
    args = ap.parse_args(argv)

    records = load_jsonl(args.inputs)
    if args.json:
        print(json.dumps(build_report(records), indent=2, sort_keys=True))
        return 0
    rollups, registry, events = split_records(records)
    timeseries, slo = extract_telemetry(records)
    lines: List[str] = []
    if rollups:
        lines += render_task_table(rollups)
        lines += render_op_table(rollups)
    else:
        lines.append("(no task_rollup records in input)")
    lines += render_event_table(events)
    lines += render_retry_table(events)
    if any(e.get("kind", "").startswith("server_") for e in events) \
            or (registry or {}).get("srt_server_queue_wait_ns"):
        lines += render_server_table(events, registry)
    if any(e.get("kind") == "io_file" for e in events):
        lines += render_io_table(events, registry)
    if any(e.get("kind", "").startswith("fleet_") for e in events) \
            or (registry or {}).get("srt_fleet_rebalances_total",
                                    {}).get("series") \
            or (registry or {}).get("srt_shuffle_dup_dropped_total",
                                    {}).get("series"):
        lines += render_fleet_table(events, registry)
    if any(e.get("kind") == "stage_fusion" for e in events):
        lines += render_stage_table(events)
    if any(e.get("kind") in ("node_stats", "cardinality_misestimate")
           for e in events) \
            or (registry or {}).get("srt_stats_rows_total",
                                    {}).get("series"):
        lines += render_stats_table(events, registry)
    if args.window is not None:
        lines += render_window_table(timeseries, registry,
                                     args.window)
    if slo is not None or args.window is not None:
        lines += render_slo_table(slo)
    if registry is not None:
        lines += render_jit_cache_table(registry)
        if (registry or {}).get("srt_result_cache_hits_total") \
                or (registry or {}).get(
                    "srt_result_cache_misses_total"):
            lines += render_result_cache_table(registry)
        if (registry or {}).get("srt_kernel_path_total"):
            lines += render_kernel_path_table(registry)
        lines += render_histogram_table(registry)
        lines.append("")
        lines.append(f"registry snapshot: {len(registry)} metric families")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
