"""``srt-explain``: render per-query EXPLAIN ANALYZE profiles
(the analyst-facing half of observability/profile.py; the
reference's counterpart is the profiler sidecar's
``profile_converter`` text mode).

Input: one or more profile JSON files — written by the query server's
``profile`` door, the distributed runner's ``profile_<op>_rank<r>.json``
dumps, or frozen into a flight-recorder bundle as ``profile.json`` (a
bundle directory is accepted directly).  MULTIPLE inputs merge into
ONE fleet profile via :func:`observability.profile.merge_profiles`:
per-stage wall is the max over ranks (the critical path) and the
per-rank walls render as a skew table.

Output: the plan tree with per-stage attribution — wall ns, engine
(fused/unfused), compile-vs-cache-hit, dispatch count, per-input
rows/bucket/pad-waste — with the hot path highlighted, plus the
task-scoped op deltas, retry/OOM episodes, per-peer shuffle-link
bytes and jit-cache activity the profiler folded in.

``--diff BASELINE`` compares per-stage mean walls against a baseline
profile and EXITS NONZERO when any stage regressed beyond
``--threshold`` — the per-node guardrail the bench-trajectory BENCH_*
files cannot give.  Stages present in the baseline but absent from the
current profile render as ``removed`` rows (informational: a vanished
stage is a plan change, not a regression, so it never fails the gate).
When both sides carry time-attribution ledgers the diff ALSO names
which bucket absorbed the extra wall (``diff_attribution``).

``--where`` renders the time-attribution waterfall: the
admission-to-result wall split into the exhaustive bucket set from
``observability/attribution.py``, with the conservation verdict.
``--critical-path`` switches the inputs to per-rank span JSONL dumps
(or bundle dirs) and renders the cross-rank critical path — the chain
of spans the wall actually waited on — plus the exchange-edge
leaderboard with the hot link flagged.

Usage:
    python -m spark_rapids_tpu_torch.tools.srt_explain PROFILE.json \
        [more_rank_profiles.json ...] [--nodes] [--json] [--where] \
        [--diff BASELINE.profile.json] [--threshold 1.5]
    python -m spark_rapids_tpu_torch.tools.srt_explain --critical-path \
        spans_rank0.jsonl spans_rank1.jsonl [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from spark_rapids_tpu_torch.observability.attribution import (
    OVERHEAD_BUCKETS, attribute_many, diff_attribution, hot_rank)
from spark_rapids_tpu_torch.observability.critical_path import critical_path
from spark_rapids_tpu_torch.observability.profile import (diff_profiles,
                                                    merge_profiles)


def load_profiles(paths) -> List[dict]:
    """One profile dict per input path; a flight-recorder bundle
    directory stands in for its ``profile.json``."""
    from spark_rapids_tpu_torch.tools import expand_bundle_input

    out: List[dict] = []
    for p0 in paths:
        for p in expand_bundle_input(p0, "profile"):
            with open(p) as f:
                prof = json.load(f)
            if not isinstance(prof, dict) or "stages" not in prof:
                raise ValueError(f"{p}: not a query profile "
                                 f"(no 'stages')")
            out.append(prof)
    return out


def load_spans(paths) -> Dict[int, List[dict]]:
    """rank -> span records for ``--critical-path``.  Each input is a
    tracer/journal JSONL dump (or a bundle dir standing in for its
    spans.jsonl); the rank comes from the records themselves when
    stamped, else from the input ordinal — so both the distributed
    runner's ``spans_rank<r>.jsonl`` layout and anonymous dumps work."""
    from spark_rapids_tpu_torch.tools import expand_bundle_input, read_jsonl

    by_rank: Dict[int, List[dict]] = {}
    for ordinal, p0 in enumerate(paths):
        for p in expand_bundle_input(p0, "spans"):
            records = read_jsonl(p)
            rank = ordinal
            for r in records:
                if isinstance(r.get("rank"), int):
                    rank = r["rank"]
                    break
            by_rank.setdefault(rank, []).extend(records)
    return by_rank


# ---------------------------------------------------------------- render


def _ms(ns) -> str:
    return f"{(ns or 0) / 1e6:.3f}"


def _kb(n) -> str:
    n = int(n)
    if n >= 1 << 20:
        return f"{n / (1 << 20):.1f}MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KiB"
    return f"{n}B"


def _node_summary(nodes: List[dict]) -> str:
    counts: Dict[str, int] = {}
    for n in nodes or ():
        k = str(n.get("kind", "?"))
        counts[k] = counts.get(k, 0) + 1
    return ", ".join(f"{k} x{v}" if v > 1 else k
                     for k, v in sorted(counts.items()))


def _input_summary(inputs: List[dict]) -> str:
    parts = []
    for i in inputs or ():
        s = f"{i.get('name', '?')} rows={i.get('rows', 0)}"
        pad = int(i.get("pad_rows", 0))
        if pad:
            s += f"/{i.get('bucket', 0)} pad={pad}"
        parts.append(s)
    return "; ".join(parts)


def render_profile(profile: dict, *, nodes: bool = False
                   ) -> List[str]:
    """The EXPLAIN ANALYZE tree as text lines.  Purely
    profile-derived (no "now" stamps): the same artifact always
    renders the same text — the golden test holds the CLI to that."""
    out: List[str] = []
    fleet = bool(profile.get("fleet"))
    head = (f"srt-explain: {profile.get('query') or '?'}"
            f"  (query_id {profile.get('query_id') or '?'}"
            + (f", tenant {profile['tenant']}"
               if profile.get("tenant") else "")
            + (f", trace {profile['trace_id']}"
               if profile.get("trace_id") else "") + ")")
    out.append(head)
    if fleet:
        out.append(
            f"fleet: world={profile.get('world')} "
            f"ranks={profile.get('ranks')}  trace "
            + ("consistent" if profile.get("trace_consistent")
               else "UNVERIFIED — inputs may be unrelated runs"))
    stages = profile.get("stages") or []
    out.append(f"wall {_ms(profile.get('wall_ns'))} ms"
               + (" (max over ranks)" if fleet else "")
               + f"   stages {len(stages)}"
               + (f"   hot {profile['hot_stage']}"
                  if profile.get("hot_stage") else ""))
    wall = max(int(profile.get("wall_ns") or 0), 1)
    hot = profile.get("hot_stage")
    out.append("plan tree (stage-IR attribution):")
    for s in stages:
        tags = [str(s.get("engine", "?"))]
        if s.get("compiled"):
            tags.append("compiled")
        else:
            tags.append("cache-hit")
        calls = int(s.get("calls", 1))
        tags.append(f"{int(s.get('dispatches', 0))} dispatch / "
                    f"{int(s.get('nodes_total', 0))} nodes")
        if calls > 1:
            tags.append(f"{calls} calls")
        pct = min(100 * int(s.get("wall_ns", 0)) // wall, 100)
        line = (f"  {s.get('stage', '?'):<16} "
                f"[{', '.join(tags)}]  "
                f"{_ms(s.get('wall_ns')):>9} ms  ({pct:>2}%)")
        if hot and s.get("stage") == hot:
            line += "  <-- HOT"
        out.append(line)
        ins = _input_summary(s.get("inputs"))
        if ins:
            out.append(f"      inputs: {ins}")
        summary = _node_summary(s.get("nodes"))
        if summary:
            out.append(f"      nodes: {summary}")
        if nodes:
            for n in s.get("nodes") or ():
                out.append(f"        {n.get('kind', '?'):<12} -> "
                           + ",".join(n.get("outs") or ()))
        prw = s.get("per_rank_wall_ns")
        if prw:
            ranks = " ".join(f"r{r}={_ms(w)}ms"
                             for r, w in sorted(
                                 prw.items(),
                                 key=lambda kv: int(kv[0])))
            out.append(f"      per-rank: {ranks}")
        # per-node cardinalities: est vs actual, sketch
        # NDV, selectivity, and the misestimate highlight
        st = s.get("stats")
        if st and st.get("nodes"):
            out.append("      stats (est vs actual rows):")
            for n in st["nodes"]:
                if n.get("est") is not None:
                    bits = [f"rows est={n['est']} "
                            f"actual={n.get('rows')}"]
                    if n.get("ratio"):
                        bits.append(f"(x{n['ratio']:g} off)")
                else:
                    bits = [f"rows actual={n.get('rows')}"]
                if n.get("selectivity") is not None:
                    bits.append(f"sel={n['selectivity']:.4f}")
                if n.get("ndv") is not None:
                    bits.append(f"ndv={n['ndv']}")
                if n.get("null_frac"):
                    bits.append(f"null={n['null_frac']:.3f}")
                prr = n.get("per_rank_rows")
                if prr:
                    bits.append("per-rank " + " ".join(
                        f"r{r}={v}" for r, v in sorted(
                            prr.items(),
                            key=lambda kv: int(kv[0]))))
                line = (f"        {n.get('node', '?'):<14} "
                        + "  ".join(bits))
                if n.get("misestimate"):
                    line += "  <-- MISESTIMATE"
                out.append(line)
    # ---- skew table (fleet merges only) ----------------------------
    skew = profile.get("skew") or []
    worst = [r for r in skew if r.get("skew_ratio")
             and r["skew_ratio"] > 1.0]
    if worst:
        out.append("rank skew (max/min wall per stage):")
        for r in sorted(worst, key=lambda r: -r["skew_ratio"]):
            out.append(f"  {r.get('stage', '?'):<16} "
                       f"x{r['skew_ratio']:.2f}  "
                       f"(max {_ms(r.get('max_wall_ns'))} ms, "
                       f"min {_ms(r.get('min_wall_ns'))} ms)")
    # ---- cross-cutting sections ------------------------------------
    links = profile.get("shuffle_links") or {}
    if links.get("bytes"):
        parts = []
        for direction in ("send", "recv"):
            for peer, n in sorted(
                    (links["bytes"].get(direction) or {}).items()):
                parts.append(f"{direction}[{peer}]={_kb(n)}")
        if parts:
            out.append("shuffle links: " + "  ".join(parts))
    if links.get("per_rank"):
        for rank, rl in sorted(links["per_rank"].items(),
                               key=lambda kv: int(kv[0])):
            parts = []
            for direction in ("send", "recv"):
                for peer, n in sorted(
                        ((rl.get("bytes") or {}).get(direction)
                         or {}).items()):
                    parts.append(f"{direction}[{peer}]={_kb(n)}")
            if parts:
                out.append(f"shuffle links r{rank}: "
                           + "  ".join(parts))
    ops = profile.get("ops") or {}
    if ops:
        top = sorted(ops.items(),
                     key=lambda kv: -kv[1].get("time_ns", 0))[:8]
        out.append("task-scoped ops: " + "  ".join(
            f"{op}={_ms(o.get('time_ns'))}ms/{o.get('calls', 0)}"
            for op, o in top))
    r = profile.get("retries") or {}
    o = profile.get("oom") or {}
    if r.get("episodes") or o.get("retry") or o.get("split_retry") \
            or o.get("blocked_ns"):
        out.append(
            f"retries: {r.get('episodes', 0)} episodes "
            f"({r.get('attempts', 0)} attempts, "
            f"{r.get('splits', 0)} splits, "
            f"{_ms(r.get('lost_ns'))} ms lost)   "
            f"oom: {o.get('retry', 0)} retry / "
            f"{o.get('split_retry', 0)} split, blocked "
            f"{_ms(o.get('blocked_ns'))} ms")
    kp = profile.get("kernel_paths") or {}
    if kp:
        out.append("kernel paths: " + "  ".join(
            f"{k}={v}" for k, v in sorted(kp.items())))
    jit = profile.get("jit") or {}
    if jit:
        out.append("jit cache: " + "  ".join(
            f"{k}(hits={d.get('hits', 0)},misses={d.get('misses', 0)})"
            for k, d in sorted(jit.items())))
    rc = profile.get("cache") or {}
    if any(rc.get(k) for k in ("hits", "misses", "puts", "folds")):
        out.append(
            f"result cache: hits={rc.get('hits', 0)} "
            f"misses={rc.get('misses', 0)} puts={rc.get('puts', 0)} "
            f"folds={rc.get('folds', 0)} "
            f"lookup={_ms(rc.get('lookup_ns'))}ms")
    spans = profile.get("spans") or {}
    if spans.get("count"):
        kinds = " ".join(f"{k}={v}" for k, v in
                         sorted(spans.get("by_kind", {}).items()))
        out.append(f"trace-scoped spans: {spans['count']} ({kinds})")
    return out


def render_where(ledger: dict) -> List[str]:
    """The time-attribution waterfall as text lines.  Like the plan
    tree, purely ledger-derived — same ledger, same text."""
    out: List[str] = []
    wall = max(int(ledger.get("wall_ns") or 0), 1)
    out.append(f"where did the time go: "
               f"{ledger.get('query') or '?'}"
               f"  (query_id {ledger.get('query_id') or '?'}"
               + (f", tenant {ledger['tenant']}"
                  if ledger.get("tenant") else "")
               + f", wall {_ms(ledger.get('wall_ns'))} ms"
               + (" over "
                  f"{len(ledger.get('per_rank') or ())} ranks"
                  if ledger.get("fleet") else "") + ")")
    buckets = ledger.get("buckets") or {}
    dom = ledger.get("dominant")
    for b, v in sorted(buckets.items(), key=lambda kv: -kv[1]):
        if v <= 0:
            continue
        pct = min(100 * int(v) // max(sum(buckets.values()), 1), 100)
        line = f"  {b:<16} {_ms(v):>10} ms  ({pct:>2}%)"
        if b == dom:
            line += "  <-- dominant"
        out.append(line)
    dov = ledger.get("dominant_overhead")
    if dov:
        hr = hot_rank(ledger, dov)
        out.append(f"  dominant overhead: {dov}"
                   + (f" (hot rank {hr})" if hr is not None else ""))
    if ledger.get("conserved"):
        out.append("  conservation: OK")
    else:
        oc = ledger.get("overcount_ns")
        if oc is None:  # fleet rollup: find the broken rank(s)
            oc = max((led.get("overcount_ns", 0) for led in
                      (ledger.get("per_rank") or {}).values()),
                     default=0)
        out.append(f"  conservation: BROKEN — buckets overcount the "
                   f"wall by {_ms(oc)} ms (double-counted seams)")
    return out


def render_critical_path(result: dict) -> List[str]:
    """The cross-rank critical path + exchange-edge leaderboard.  The
    hottest segment (largest dur + inbound gap) and the hottest
    exchange edge carry ``<-- HOT`` markers."""
    out: List[str] = []
    path = result.get("path") or []
    out.append(f"critical path: {len(path)} segment(s), "
               f"{_ms(result.get('total_ns'))} ms covered"
               + (f", {result['clamped_edges']} edge(s) clamped"
                  if result.get("clamped_edges") else ""))
    offs = result.get("clock_offsets") or {}
    if any(int(v) for v in offs.values()):
        out.append("  clock offsets: " + "  ".join(
            f"r{r}={int(v)}ns" for r, v in
            sorted(offs.items(), key=lambda kv: int(kv[0]))))
    for rk in result.get("truncated_ranks") or ():
        out.append(f"  WARNING: rank {rk} span dump truncated — "
                   f"path may be partial")
    hot_i = max(range(len(path)),
                key=lambda i: path[i]["dur_ns"] + path[i]["gap_in_ns"],
                default=None) if path else None
    for i, seg in enumerate(path):
        if seg["edge_in"] == "exchange":
            out.append(f"    ~~> exchange hop "
                       f"(wire+wait {_ms(seg['gap_in_ns'])} ms)")
        elif seg["gap_in_ns"] > 0:
            out.append(f"    ... lane idle {_ms(seg['gap_in_ns'])} ms")
        line = (f"  r{seg['rank']} {seg['name']:<24} "
                f"[{seg['span_kind']}/{seg['bucket']}]  "
                f"{_ms(seg['dur_ns']):>10} ms")
        if i == hot_i:
            line += "  <-- HOT"
        out.append(line)
    edges = result.get("exchange_edges") or []
    if edges:
        out.append("exchange edges (largest gap first):")
        for j, e in enumerate(edges):
            line = (f"  r{e['from_rank']}:{e['from']} -> "
                    f"r{e['to_rank']}:{e['to']}  "
                    f"gap {_ms(e['gap_ns'])} ms"
                    + ("  [on path]" if e.get("on_path") else ""))
            if j == 0:
                line += "  <-- HOT"
            out.append(line)
    return out


def render_diff(findings: List[dict], threshold: float,
                attribution_rows: List[dict] = None,
                hot: str = None) -> List[str]:
    out = []
    regressed = [f for f in findings
                 if f.get("kind", "regression") != "removed"]
    removed = [f for f in findings if f.get("kind") == "removed"]
    if not regressed:
        out.append(f"diff: no per-stage regression beyond "
                   f"x{threshold}")
    else:
        out.append(f"diff: {len(regressed)} stage(s) regressed "
                   f"beyond x{threshold}:")
        for f in regressed:
            out.append(f"  {f['stage']:<16} x{f['ratio']:.2f}  "
                       f"({f['base_mean_ms']} ms -> "
                       f"{f['cur_mean_ms']} ms)")
    for f in removed:
        out.append(f"  {f['stage']:<16} removed  "
                   f"(was {f['base_mean_ms']} ms x"
                   f"{f['base_calls']} calls in baseline)")
    if attribution_rows:
        out.append("where the delta went (per bucket):")
        for r in attribution_rows:
            share = (f"  ({r['share_of_delta'] * 100:.0f}% of "
                     f"wall delta)"
                     if r.get("share_of_delta") is not None else "")
            out.append(f"  {r['bucket']:<16} "
                       f"{r['base_ms']} ms -> {r['cur_ms']} ms  "
                       f"({r['delta_ms']:+} ms){share}")
        if hot is not None:
            out.append(f"  hot rank: {hot}")
    return out


# ------------------------------------------------------------------ CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srt-explain",
        description="Render per-query EXPLAIN ANALYZE profiles "
                    "(multiple rank profiles merge into one fleet "
                    "profile)")
    ap.add_argument("inputs", nargs="+",
                    help="profile JSON files or flight-recorder "
                         "bundle dirs")
    ap.add_argument("--nodes", action="store_true",
                    help="list every plan node under its stage")
    ap.add_argument("--json", action="store_true",
                    help="emit the (merged) profile as JSON")
    ap.add_argument("--where", action="store_true",
                    help="render the time-attribution waterfall "
                         "(where the admission-to-result wall went)")
    ap.add_argument("--critical-path", action="store_true",
                    help="treat inputs as per-rank span JSONL dumps "
                         "and solve the cross-rank critical path")
    ap.add_argument("--diff", metavar="BASELINE", default=None,
                    help="baseline profile (file or bundle dir); "
                         "exits 1 on any per-stage, whole-wall, or "
                         "overhead-bucket regression")
    ap.add_argument("--threshold", type=float, default=1.5,
                    help="regression ratio threshold (default 1.5)")
    ap.add_argument("--min-delta-ms", type=float, default=1.0,
                    help="ignore regressions smaller than this "
                         "absolute per-call delta (default 1 ms)")
    args = ap.parse_args(argv)

    if args.critical_path:
        try:
            spans_by_rank = load_spans(args.inputs)
        except (OSError, ValueError, KeyError) as e:
            print(f"srt-explain: {e}", file=sys.stderr)
            return 2
        result = critical_path(spans_by_rank)
        if args.json:
            print(json.dumps(result, indent=2, sort_keys=True,
                             default=str))
        else:
            print("\n".join(render_critical_path(result)))
        return 0

    try:
        profiles = load_profiles(args.inputs)
    except (OSError, ValueError) as e:
        print(f"srt-explain: {e}", file=sys.stderr)
        return 2
    profile = merge_profiles(profiles)
    ledger = None
    if args.where or args.diff:
        # recomputing from the artifact matches any embedded ledger
        # (attribution is a pure function of the profile), and also
        # serves profiles captured with the switch off
        ledger = attribute_many(profiles)

    if args.where:
        if args.json:
            print(json.dumps(ledger, indent=2, sort_keys=True,
                             default=str))
        else:
            print("\n".join(render_where(ledger)))
    elif args.json:
        print(json.dumps(profile, indent=2, sort_keys=True,
                         default=str))
    else:
        print("\n".join(render_profile(profile, nodes=args.nodes)))

    if args.diff:
        try:
            base_profiles = load_profiles([args.diff])
        except (OSError, ValueError) as e:
            print(f"srt-explain: --diff {e}", file=sys.stderr)
            return 2
        baseline = merge_profiles(base_profiles)
        min_delta_ns = int(args.min_delta_ms * 1e6)
        findings = diff_profiles(
            baseline, profile, threshold=args.threshold,
            min_delta_ns=min_delta_ns)
        base_ledger = attribute_many(base_profiles)
        rows = diff_attribution(base_ledger, ledger,
                                min_delta_ns=min_delta_ns)
        # regressions with no single guilty stage are still
        # regressions: time lost BETWEEN stages (exchange wire/wait,
        # retries, admission) lands in the overhead buckets, and a
        # compile-jitter swing in the wall can HIDE it — so the gate
        # also fails when the whole wall or any overhead bucket grows
        # past the threshold
        findings = list(findings)
        base_wall = int(base_ledger.get("wall_ns", 0))
        cur_wall = int(ledger.get("wall_ns", 0))
        if (base_wall > 0 and cur_wall >= base_wall * args.threshold
                and cur_wall - base_wall >= min_delta_ns):
            findings.append({
                "kind": "wall_regression", "stage": "(wall)",
                "ratio": round(cur_wall / base_wall, 3),
                "base_mean_ms": round(base_wall / 1e6, 3),
                "cur_mean_ms": round(cur_wall / 1e6, 3),
            })
        base_b = base_ledger.get("buckets") or {}
        cur_b = ledger.get("buckets") or {}
        for bucket in OVERHEAD_BUCKETS:
            bv = int(base_b.get(bucket, 0))
            cv = int(cur_b.get(bucket, 0))
            if cv >= bv * args.threshold and cv - bv >= min_delta_ns:
                findings.append({
                    "kind": "overhead_regression",
                    "stage": f"({bucket})",
                    "ratio": round(cv / max(bv, 1), 3),
                    "base_mean_ms": round(bv / 1e6, 3),
                    "cur_mean_ms": round(cv / 1e6, 3),
                })
        print("\n".join(render_diff(
            findings, args.threshold, attribution_rows=rows,
            hot=hot_rank(ledger) if ledger.get("fleet") else None)))
        # removed stages are informational (a plan change, not a
        # regression) — only true regressions fail the gate
        return 1 if any(f.get("kind", "regression") != "removed"
                        for f in findings) else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
