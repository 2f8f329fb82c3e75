"""Per-query wall-clock attribution: where did the time go.

Query profiles say what each stage cost and the SLO monitor says
whether a tenant's SLO is burning, but neither answers the operator's question
on a p99 miss: which nanoseconds of THIS query's admission-to-result
wall were queue wait vs compile vs fused compute vs shuffle wire vs
blocked-on-memory vs straggler wait?  This module classifies a
finished profile artifact (``observability/profile.py``) into an
exhaustive, non-overlapping bucket set:

  queue_wait        server admission -> dispatch (``queue_wait_ns``
                    stamped into the profile by the server)
  compile           ``stage_compile`` build time inside stage walls
                    (``compile_ns`` on stage records; a cache hit is 0)
  compute_fused     fused-engine stage wall minus its compile share
  compute_unfused   every other engine's stage wall minus compile
  shuffle_wire      serialize+send segments (``shuffle_wire`` journal
                    events from distributed/service.py) and kudo
                    write/merge work
  shuffle_wait      inbox idle: blocked waiting on peers' frames
  speculation_wait  gather idle attributable to parts with a live
                    speculation decision (fleet stragglers)
  spill_wait        synchronous tiered-store work on this thread:
                    ensure_headroom victim spills + restore round
                    trips (memory/spill.py)
  cache_lookup      semantic result/subplan cache consults
                    (perf/result_cache.py): a warm hit's whole wall
                    IS this bucket; stage/subplan consults happen
                    outside the timed stage walls, so the bucket is
                    counted directly, never carved from compute
  oom_blocked       BUFN time (``thread_unblocked`` blocked_ns)
  retry_lost        failed retry attempts' wall (episodes' lost_ns)
  other             the residual — reported, never silently dropped

Conservation contract (the timeseries idiom, adapted): the buckets sum to
the measured admission-to-result wall within a smoke-gated tolerance.
The residual is ``other``; when the known buckets OVERCOUNT the wall
(double-attributed seams are a bug, not a rounding error) the excess
is reported as ``overcount_ns`` and ``conserved`` goes false past the
tolerance.  ``attribution-smoke`` gates both directions on clean and
chaos runs.

OOM-blocked and retry-lost nanoseconds happen ON the query thread
inside stage execution, so a naive sum would double-count them against
compute.  The ledger carves them out of the compute buckets
(proportionally, clamped at zero) so the bucket set stays
non-overlapping; whatever cannot be carved (a retry outside any stage)
surfaces as overcount instead of vanishing.

Dependency-free and pure: ledger in, ledger out — the module never
touches the live singletons, so tests and tools feed it synthetic
profiles.  ``observability/__init__`` owns the enabled switch and the
``srt_attribution_*`` accounting.
"""

from __future__ import annotations

from typing import Dict, List, Optional

ATTRIBUTION_VERSION = 1

# every ledger carries ALL buckets, zeros included — a reader must
# never wonder whether a bucket was measured-zero or not-implemented
BUCKETS = (
    "queue_wait",
    "compile",
    "compute_fused",
    "compute_unfused",
    "shuffle_wire",
    "shuffle_wait",
    "speculation_wait",
    "spill_wait",
    "cache_lookup",
    "oom_blocked",
    "retry_lost",
    "other",
)

# the waste buckets an operator hunts on a tail-latency miss — the
# chaos smoke asserts the injected cause dominates THIS set (compute
# legitimately dominates most walls; that is not a finding)
OVERHEAD_BUCKETS = (
    "queue_wait",
    "shuffle_wire",
    "shuffle_wait",
    "speculation_wait",
    "spill_wait",
    "cache_lookup",
    "oom_blocked",
    "retry_lost",
)

# fraction of the measured wall the known buckets may overcount before
# the ledger declares conservation broken (clock granularity + seam
# jitter live below this; double-counted seams blow through it)
DEFAULT_TOLERANCE = 0.25


def _stage_split(stages: List[dict]) -> Dict[str, int]:
    """(compile, compute_fused, compute_unfused) from the folded stage
    rows.  ``compile_ns`` is carved out of the stage's own wall so the
    two never overlap; records from before the stamp existed simply
    report compile 0 (the bucket degrades, the sum still conserves)."""
    compile_ns = 0
    fused = 0
    unfused = 0
    for s in stages or ():
        if str(s.get("engine", "")) == "cached":
            # a cache-hit stage's "wall" is its lookup, already owned
            # by the cache_lookup bucket — counting it here would
            # double-attribute those nanoseconds
            continue
        wall = int(s.get("wall_ns", 0))
        c = min(int(s.get("compile_ns", 0)), wall)
        compile_ns += c
        if str(s.get("engine", "")) == "fused":
            fused += wall - c
        else:
            unfused += wall - c
    return {"compile": compile_ns, "compute_fused": fused,
            "compute_unfused": unfused}


def _carve(buckets: Dict[str, int], amount: int,
           victims: tuple) -> int:
    """Remove ``amount`` ns from ``victims`` proportionally to their
    size (largest absorbs most), clamped at zero.  Returns what could
    NOT be carved — the caller reports it as overcount rather than
    letting the ledger double-claim those nanoseconds."""
    remaining = amount
    while remaining > 0:
        live = [v for v in victims if buckets.get(v, 0) > 0]
        if not live:
            break
        total = sum(buckets[v] for v in live)
        progress = False
        for v in live:
            take = min(buckets[v],
                       max(1, remaining * buckets[v] // total))
            take = min(take, remaining)
            if take > 0:
                buckets[v] -= take
                remaining -= take
                progress = True
            if remaining <= 0:
                break
        if not progress:
            break
    return remaining


def attribute_profile(profile: dict, *,
                      tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Build the time-attribution ledger for ONE rank's profile
    artifact.  Total wall = admission queue wait (when the server
    stamped it) + the profile's execution wall."""
    exec_wall = int(profile.get("wall_ns", 0))
    queue_wait = max(int(profile.get("queue_wait_ns", 0) or 0), 0)
    wall = queue_wait + exec_wall

    buckets: Dict[str, int] = {b: 0 for b in BUCKETS}
    buckets["queue_wait"] = queue_wait
    buckets.update(_stage_split(profile.get("stages") or []))

    shuffle = profile.get("shuffle") or {}
    buckets["shuffle_wire"] = int(shuffle.get("wire_ns", 0))
    buckets["shuffle_wait"] = int(shuffle.get("wait_ns", 0))
    buckets["speculation_wait"] = int(shuffle.get("spec_wait_ns", 0))

    oom_blocked = int((profile.get("oom") or {}).get("blocked_ns", 0))
    retry_lost = int((profile.get("retries") or {}).get("lost_ns", 0))
    spill_wait = int((profile.get("spill") or {}).get("wait_ns", 0))
    # cache consults run OUTSIDE the timed stage walls (and a warm
    # hit has no stages at all), so the bucket counts directly —
    # carving it from compute would break conservation exactly on the
    # warm-hit profiles it exists to explain
    buckets["cache_lookup"] = int(
        (profile.get("cache") or {}).get("lookup_ns", 0))
    # blocked/lost/spill time happened inside stage walls on this
    # thread: carve it out of compute so the buckets stay
    # non-overlapping
    uncarved = _carve(buckets, oom_blocked + retry_lost + spill_wait,
                      ("compute_unfused", "compute_fused"))
    buckets["oom_blocked"] = oom_blocked
    buckets["retry_lost"] = retry_lost
    buckets["spill_wait"] = spill_wait

    known = sum(buckets[b] for b in BUCKETS if b != "other")
    overcount = max(known - wall, 0) if wall > 0 else max(known, 0)
    buckets["other"] = max(wall - known, 0)
    tol_ns = int(tolerance * wall)
    conserved = overcount <= tol_ns

    nonzero = {b: v for b, v in buckets.items() if v > 0}
    dominant = max(nonzero, key=nonzero.get) if nonzero else None
    overhead = {b: buckets[b] for b in OVERHEAD_BUCKETS
                if buckets[b] > 0}
    dominant_overhead = (max(overhead, key=overhead.get)
                         if overhead else None)

    return {
        "attribution_version": ATTRIBUTION_VERSION,
        "query_id": profile.get("query_id"),
        "tenant": profile.get("tenant", ""),
        "query": profile.get("query", ""),
        "rank": int(profile.get("rank", 0)),
        "world": int(profile.get("world", 1)),
        "wall_ns": wall,
        "exec_wall_ns": exec_wall,
        "buckets": buckets,
        "fractions": {b: (round(v / wall, 4) if wall > 0 else 0.0)
                      for b, v in buckets.items()},
        "dominant": dominant,
        "dominant_overhead": dominant_overhead,
        "overcount_ns": overcount + uncarved,
        "tolerance": tolerance,
        "conserved": conserved and uncarved <= tol_ns,
    }


def attribute_many(profiles: List[dict], *,
                   tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Fleet rollup: per-rank ledgers plus a combined bucket view.
    Conservation is a PER-RANK claim (the fleet wall is the max over
    ranks, so summed buckets legitimately exceed it when ranks overlap
    in time); the rollup's ``conserved`` is the AND over ranks."""
    if not profiles:
        raise ValueError("attribute_many: no profiles given")
    per_rank = {}
    for i, p in enumerate(profiles):
        led = attribute_profile(p, tolerance=tolerance)
        r = led["rank"]
        if str(r) in per_rank:      # reindex colliding dumps
            r = max(int(k) for k in per_rank) + 1
            led["rank"] = r
        per_rank[str(r)] = led
    combined: Dict[str, int] = {b: 0 for b in BUCKETS}
    for led in per_rank.values():
        for b, v in led["buckets"].items():
            combined[b] = combined.get(b, 0) + v
    total = sum(combined.values())
    nonzero = {b: v for b, v in combined.items() if v > 0}
    overhead = {b: combined[b] for b in OVERHEAD_BUCKETS
                if combined[b] > 0}
    return {
        "attribution_version": ATTRIBUTION_VERSION,
        "fleet": len(per_rank) > 1,
        "query_id": profiles[0].get("query_id"),
        "tenant": profiles[0].get("tenant", ""),
        "query": profiles[0].get("query", ""),
        "wall_ns": max(led["wall_ns"] for led in per_rank.values()),
        "per_rank": per_rank,
        "buckets": combined,
        "fractions": {b: (round(v / total, 4) if total > 0 else 0.0)
                      for b, v in combined.items()},
        "dominant": (max(nonzero, key=nonzero.get)
                     if nonzero else None),
        "dominant_overhead": (max(overhead, key=overhead.get)
                              if overhead else None),
        "conserved": all(led["conserved"]
                         for led in per_rank.values()),
    }


def diff_attribution(baseline: dict, current: dict,
                     *, min_delta_ns: int = 1_000_000
                     ) -> List[dict]:
    """Per-bucket regression attribution for ``srt-explain --diff``:
    which bucket absorbed the extra wall ("q5 got 40% slower and it is
    all shuffle_wait on rank 1").  Returns rows sorted by absolute
    growth, largest first; buckets that shrank ride along with
    negative deltas so the reader sees where the time MOVED."""
    b = baseline.get("buckets") or {}
    c = current.get("buckets") or {}
    wall_delta = (int(current.get("wall_ns", 0))
                  - int(baseline.get("wall_ns", 0)))
    rows: List[dict] = []
    for bucket in BUCKETS:
        d = int(c.get(bucket, 0)) - int(b.get(bucket, 0))
        if abs(d) < min_delta_ns:
            continue
        rows.append({
            "bucket": bucket,
            "base_ms": round(int(b.get(bucket, 0)) / 1e6, 3),
            "cur_ms": round(int(c.get(bucket, 0)) / 1e6, 3),
            "delta_ms": round(d / 1e6, 3),
            "share_of_delta": (round(d / wall_delta, 3)
                               if wall_delta > 0 else None),
        })
    rows.sort(key=lambda r: -abs(r["delta_ms"]))
    return rows


def hot_rank(ledger: dict, bucket: Optional[str] = None) -> Optional[str]:
    """Which rank holds the most nanoseconds of ``bucket`` (or of the
    rollup's dominant bucket) — the "on rank 1" half of the diff
    message.  None for single-rank ledgers."""
    per_rank = ledger.get("per_rank") or {}
    if not per_rank:
        return None
    bucket = bucket or ledger.get("dominant")
    if bucket is None:
        return None
    best, best_v = None, -1
    for r, led in sorted(per_rank.items()):
        v = int((led.get("buckets") or {}).get(bucket, 0))
        if v > best_v:
            best, best_v = r, v
    return best
