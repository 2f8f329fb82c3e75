"""Cross-rank critical-path solver over the stitched fleet trace.

The merged fleet profile says WHICH stage was slow per rank; this
module says which CHAIN of spans — across ranks — the query wall
actually waited on.  Input is the per-rank span dumps the distributed
runner already writes (``spans_rank{r}.jsonl``): rank-local span
records with monotonic ``t_ns`` starts, plus the kudo KTRX ``links``
(merge span -> writer spans) that are the only physical cross-rank
ordering evidence.

Clock normalization: each rank's monotonic clock has an arbitrary
epoch, so raw cross-rank gaps are meaningless and can even be negative
(skew "time travel").  For every rank pair with link edges in BOTH
directions the true one-way gaps are unknowable, but their SUM is
skew-free — so the midpoint rule ``o = (min_gap_ba - min_gap_ab) / 2``
exactly cancels the skew term and never fabricates a negative edge.
One-directional pairs get the weaker min-gap-zero correction (only
applied when the raw minimum is negative, so honest wire latency on a
well-behaved clock survives).  Offsets propagate from the lowest rank
by BFS; any residual negative edge after normalization is clamped to
zero and COUNTED (``clamped_edges``) — the smoke and the skew test
gate on zero.

The DAG: leaf spans (containers — process/query roots and any span
that encloses another selected span on its own rank+thread — are
dropped) are nodes; consecutive leaves on one (rank, thread) lane are
sequential edges whose gap is lane idle time; KTRX links are exchange
edges whose gap is wire + peer wait.  The longest path by covered time
(sum of span durations plus edge gaps) is the critical path; exchange
edges are ALSO emitted as a ranked list, largest gap first — under an
injected ``slow:dst:ms`` link fault the slowed link's edge ranks
first, which is exactly the evidence the smoke gates on.

Pure functions over span dicts: no singletons, no clocks, no I/O —
tools and tests feed it loaded JSONL records.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# span kinds that are pure containers: they enclose the spans that do
# the work, so they never become path nodes themselves
_CONTAINER_KINDS = ("process", "query")

# span kind -> attribution bucket for path segments (the ledger's
# vocabulary, so --where and --critical-path tell one story)
_KIND_BUCKET = {
    "compile": "compile",
    "shuffle_write": "shuffle_wire",
    "shuffle_merge": "shuffle_wire",
    "shuffle_send": "shuffle_wire",
    "stage": "compute",
    "op": "compute",
    "io": "compute",
}

# backstop against pathological dumps: per-rank span cap (the solver
# is O(n^2) per lane for containment) — excess spans are dropped
# LOUDLY via the result's ``truncated_ranks``
_MAX_SPANS_PER_RANK = 20_000


def _span_rows(records: List[dict], rank: int) -> List[dict]:
    rows = []
    for r in records:
        if r.get("kind") != "span":
            continue
        try:
            rows.append({
                "rank": rank,
                "name": str(r.get("name", "?")),
                "span_kind": str(r.get("span_kind", "?")),
                "span_id": r.get("span_id"),
                "thread": r.get("thread", 0),
                "t_ns": int(r.get("t_ns", 0)),
                "dur_ns": max(int(r.get("dur_ns", 0)), 0),
                "links": [l.get("span_id")
                          for l in (r.get("links") or [])
                          if isinstance(l, dict)],
            })
        except (TypeError, ValueError):
            continue  # a torn record must not sink the whole solve
    return rows


def _link_edges(spans: List[dict]) -> List[Tuple[dict, dict]]:
    """(writer_span, linking_span) pairs resolved through the KTRX
    ``links`` extension.  Links to span ids the dump never saw (a
    truncated ring) are skipped — absence of evidence, not negative
    evidence."""
    by_id = {s["span_id"]: s for s in spans
             if s.get("span_id") is not None}
    out = []
    for s in spans:
        for lid in s["links"]:
            src = by_id.get(lid)
            if src is not None and src is not s:
                out.append((src, s))
    return out


def normalize_clocks(spans_by_rank: Dict[int, List[dict]],
                     links: List[Tuple[dict, dict]]
                     ) -> Dict[int, int]:
    """Per-rank additive clock offsets (ns) from the cross-rank link
    evidence.  The lowest rank anchors at zero; pairs connected in
    both directions use the skew-cancelling midpoint rule, one-way
    pairs the min-gap-zero floor; unconnected ranks stay at zero
    (nothing orders them, so nothing can mis-order them either)."""
    ranks = sorted(spans_by_rank)
    offsets = {r: 0 for r in ranks}
    if len(ranks) < 2:
        return offsets
    # min raw gap per ordered pair (src_rank -> dst_rank)
    min_gap: Dict[Tuple[int, int], int] = {}
    for src, dst in links:
        a, b = src["rank"], dst["rank"]
        if a == b:
            continue
        gap = dst["t_ns"] - (src["t_ns"] + src["dur_ns"])
        key = (a, b)
        if key not in min_gap or gap < min_gap[key]:
            min_gap[key] = gap
    # pair deltas: d[(a, b)] = offset(b) - offset(a)
    deltas: Dict[Tuple[int, int], int] = {}
    for (a, b), g_ab in min_gap.items():
        if (b, a) in deltas or (a, b) in deltas:
            continue
        g_ba = min_gap.get((b, a))
        if g_ba is not None:
            # both directions: midpoint exactly cancels the skew
            deltas[(a, b)] = (g_ba - g_ab) // 2
        else:
            # one way: only repair a negative minimum
            deltas[(a, b)] = max(0, -g_ab)
    # BFS from the lowest connected rank; first assignment wins
    adj: Dict[int, List[Tuple[int, int]]] = {}
    for (a, b), d in deltas.items():
        adj.setdefault(a, []).append((b, d))
        adj.setdefault(b, []).append((a, -d))
    seen = set()
    for root in ranks:
        if root in seen or root not in adj:
            continue
        seen.add(root)
        frontier = [root]
        while frontier:
            nxt = []
            for a in frontier:
                for b, d in adj.get(a, ()):
                    if b in seen:
                        continue
                    seen.add(b)
                    offsets[b] = offsets[a] + d
                    nxt.append(b)
            frontier = nxt
    return offsets


def _leaves(spans: List[dict]) -> List[dict]:
    """Drop containers: declared container kinds, plus any span that
    encloses another surviving span on its own (rank, thread) lane."""
    cands = [s for s in spans
             if s["span_kind"] not in _CONTAINER_KINDS]
    lanes: Dict[Tuple[int, int], List[dict]] = {}
    for s in cands:
        lanes.setdefault((s["rank"], s["thread"]), []).append(s)
    out = []
    for lane in lanes.values():
        lane.sort(key=lambda s: (s["t_ns"], -s["dur_ns"]))
        for i, s in enumerate(lane):
            end = s["t_ns"] + s["dur_ns"]
            contains = False
            for o in lane[i + 1:]:
                if o["t_ns"] >= end:
                    break
                if o["t_ns"] + o["dur_ns"] <= end \
                        and o is not s:
                    contains = True
                    break
            if not contains:
                out.append(s)
    return out


def critical_path(spans_by_rank: Dict[int, List[dict]],
                  *, top_edges: int = 8) -> dict:
    """Solve the cross-rank critical path.  ``spans_by_rank`` maps
    rank -> raw tracer records (span and non-span kinds mixed is
    fine).  Returns the ranked path, the exchange-edge leaderboard,
    the clock offsets and the clamp count."""
    truncated = []
    spans: List[dict] = []
    per_rank: Dict[int, List[dict]] = {}
    for rank in sorted(spans_by_rank):
        rows = _span_rows(spans_by_rank[rank], int(rank))
        if len(rows) > _MAX_SPANS_PER_RANK:
            rows = rows[:_MAX_SPANS_PER_RANK]
            truncated.append(int(rank))
        per_rank[int(rank)] = rows
        spans.extend(rows)
    if not spans:
        return {"path": [], "exchange_edges": [],
                "clock_offsets": {}, "clamped_edges": 0,
                "total_ns": 0, "truncated_ranks": truncated}

    links = _link_edges(spans)
    offsets = normalize_clocks(per_rank, links)
    for s in spans:
        s["n_start"] = s["t_ns"] + offsets[s["rank"]]
        s["n_end"] = s["n_start"] + s["dur_ns"]

    nodes = _leaves(spans)
    node_ids = {id(s) for s in nodes}
    # edges: (src, dst, gap, kind)
    clamped = 0
    edges: List[Tuple[dict, dict, int, str]] = []
    lanes: Dict[Tuple[int, int], List[dict]] = {}
    for s in nodes:
        lanes.setdefault((s["rank"], s["thread"]), []).append(s)
    for lane in lanes.values():
        lane.sort(key=lambda s: s["n_start"])
        for a, b in zip(lane, lane[1:]):
            gap = b["n_start"] - a["n_end"]
            if gap < 0:
                gap, clamped = 0, clamped + 1
            edges.append((a, b, gap, "sequential"))
    exchange_edges = []
    for src, dst in links:
        # a link may point at a container (the write span survived
        # but the merge got folded): lift to whichever side is a node
        if id(src) not in node_ids or id(dst) not in node_ids:
            continue
        gap = dst["n_start"] - src["n_end"]
        if gap < 0:
            gap, clamped = 0, clamped + 1
        edges.append((src, dst, gap, "exchange"))
        exchange_edges.append({
            "kind": "exchange_edge",
            "from_rank": src["rank"], "to_rank": dst["rank"],
            "from": src["name"], "to": dst["name"],
            "gap_ns": gap,
        })
    exchange_edges.sort(key=lambda e: -e["gap_ns"])

    # longest covered-time path: DP in normalized-start order (every
    # edge points forward in normalized time once gaps are clamped)
    nodes.sort(key=lambda s: (s["n_start"], s["n_end"]))
    index = {id(s): i for i, s in enumerate(nodes)}
    incoming: Dict[int, List[Tuple[int, int, str]]] = {}
    for a, b, gap, kind in edges:
        incoming.setdefault(index[id(b)], []).append(
            (index[id(a)], gap, kind))
    score = [0] * len(nodes)
    best_pred: List[Optional[Tuple[int, int, str]]] = \
        [None] * len(nodes)
    for i, s in enumerate(nodes):
        base = 0
        for j, gap, kind in incoming.get(i, ()):
            if j >= i:
                continue  # clamp artifact: never walk backwards
            cand = score[j] + gap
            if cand > base:
                base = cand
                best_pred[i] = (j, gap, kind)
        score[i] = base + s["dur_ns"]
    if not nodes:
        return {"path": [], "exchange_edges": exchange_edges,
                "clock_offsets": {str(r): o
                                  for r, o in offsets.items()},
                "clamped_edges": clamped, "total_ns": 0,
                "truncated_ranks": truncated}
    tail = max(range(len(nodes)), key=lambda i: score[i])
    chain: List[Tuple[int, int, str]] = []  # (node, gap_in, kind_in)
    i: Optional[int] = tail
    gap_in, kind_in = 0, "start"
    while i is not None:
        chain.append((i, gap_in, kind_in))
        pred = best_pred[i]
        if pred is None:
            break
        i, gap_in, kind_in = pred
    chain.reverse()
    t0 = nodes[chain[0][0]]["n_start"] if chain else 0
    path = []
    for i, gap, kind in chain:
        s = nodes[i]
        path.append({
            "rank": s["rank"],
            "thread": s["thread"],
            "name": s["name"],
            "span_kind": s["span_kind"],
            "bucket": _KIND_BUCKET.get(s["span_kind"], "other"),
            "start_ns": s["n_start"] - t0,
            "dur_ns": s["dur_ns"],
            "gap_in_ns": gap,
            "edge_in": kind,
        })
    # the path's own exchange hops get flagged on the leaderboard
    on_path = set()
    for seg in path:
        if seg["edge_in"] == "exchange":
            on_path.add((seg["rank"], seg["name"]))
    for e in exchange_edges:
        e["on_path"] = (e["to_rank"], e["to"]) in on_path
    return {
        "path": path,
        "exchange_edges": exchange_edges[:max(top_edges, 0)],
        "clock_offsets": {str(r): o for r, o in offsets.items()},
        "clamped_edges": clamped,
        "total_ns": score[tail],
        "truncated_ranks": truncated,
    }
