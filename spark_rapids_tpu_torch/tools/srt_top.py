"""srt-top: live fleet telemetry dashboard over the windowed
timeseries plane.

Renders two tables from merged per-rank windowed snapshots:

  * tenants — inflight/queue depth, RECENT p50/p99 queue wait
    (windowed histogram deltas, never the since-boot cumulative),
    completion + retry rates, device bytes, SLO burn/attainment;
  * fleet ranks — link bytes/s, observed peer deaths, membership
    epoch, window lag.

Input tiers (first match wins):

  * explicit files — any mix of per-rank ``timeseries_rank*.json``
    snapshots and/or a pre-merged ``fleet_timeseries.json``;
  * ``--dump-dir DIR`` — poll a launcher outdir for those same files
    (the no-socket tier: workers dump, srt-top merges offline).

Live mode refreshes every ``--interval`` seconds by re-reading the
inputs; ``--once`` prints one frame and exits; ``--once --json``
emits a sorted-keys machine-readable frame with NO wall-clock
content, so back-to-back runs over the same inputs are byte-identical
(the CI digest gate).

Usage:
    python -m spark_rapids_tpu_torch.tools.srt_top --dump-dir /tmp/out
    python -m spark_rapids_tpu_torch.tools.srt_top out/timeseries_rank*.json \
        --once --json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.observability.timeseries import (
    FleetTimeseries, histogram_quantile)

_QUEUE_WAIT = "srt_server_queue_wait_ns"
_COMPLETED = "srt_server_completed_total"
_REQUEUED = "srt_server_requeued_total"
_QUEUED = "srt_server_queued"
_RUNNING = "srt_server_running"
_TENANT_BYTES = "srt_server_tenant_device_bytes"
_LINK_BYTES = "srt_shuffle_link_bytes_total"
_DEATHS = "srt_fleet_deaths_total"
_EPOCH = "srt_fleet_epoch"
_SPECULATIONS = "srt_fleet_speculations_total"
_RETRIES = "srt_retry_episodes_total"
_ATTR_TIME = "srt_attribution_ns_total"
_STATS_ROWS = "srt_stats_rows_total"
_RC_HITS = "srt_result_cache_hits_total"
_RC_MISSES = "srt_result_cache_misses_total"


# ------------------------------------------------------------- loading


def discover_inputs(dump_dir: str) -> List[str]:
    """The dump-dir polling tier: per-rank snapshots plus the merged
    rank-0 view when present (offering both is fine — the merger
    dedups by window sequence)."""
    paths = sorted(glob.glob(
        os.path.join(dump_dir, "timeseries_rank*.json")))
    fleet = os.path.join(dump_dir, "fleet_timeseries.json")
    if os.path.isfile(fleet):
        paths.append(fleet)
    return paths


def load_fleet(paths: List[str]) -> FleetTimeseries:
    """Merge every input into one FleetTimeseries: per-rank snapshot
    files are offered directly; a pre-merged ``fleet_timeseries.json``
    is decomposed back into per-rank offers (same dedup/fencing
    rules either way)."""
    fleet = FleetTimeseries()
    for path in paths:
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: skipping unreadable input ({e})",
                  file=sys.stderr)
            continue
        if "ranks" in obj:  # a merged fleet view
            for rank, st in obj.get("ranks", {}).items():
                fleet.offer({"rank": int(rank),
                             "epoch": st.get("epoch", 0),
                             "windows": st.get("windows", []),
                             **st.get("meta", {})})
        else:               # one rank's own snapshot
            fleet.offer(obj)
    return fleet


# ----------------------------------------------------------- analysis


def _fold_windows(windows: List[dict], n: Optional[int]):
    """Counter totals + elapsed seconds + last-gauge values + summed
    histogram deltas over the last ``n`` windows of one rank."""
    ws = windows if n is None else windows[-n:]
    counters: Dict[str, Dict[str, float]] = {}
    gauges: Dict[str, Dict[str, float]] = {}
    hists: Dict[str, dict] = {}
    dur = 0.0
    for w in ws:
        dur += w.get("dur_s", 0.0)
        for fam, vals in w.get("counters", {}).items():
            tgt = counters.setdefault(fam, {})
            for k, v in vals.items():
                tgt[k] = tgt.get(k, 0) + v
        for fam, vals in w.get("gauges", {}).items():
            gauges.setdefault(fam, {}).update(vals)
        for fam, h in w.get("histograms", {}).items():
            tgt = hists.setdefault(
                fam, {"buckets": h["buckets"], "series": {}})
            for key, s in h["series"].items():
                acc = tgt["series"].setdefault(
                    key, {"bucket_counts":
                          [0] * len(s["bucket_counts"]),
                          "sum": 0, "count": 0})
                for i, c in enumerate(s["bucket_counts"]):
                    acc["bucket_counts"][i] += c
                acc["sum"] += s["sum"]
                acc["count"] += s["count"]
    return counters, gauges, hists, dur


def build_frame(fleet: FleetTimeseries, windows: int = 12) -> dict:
    """One dashboard frame: the tenant and rank tables as plain data.
    Purely input-derived (no clocks) — the --json golden leans on
    this."""
    merged = fleet.merged()
    tenants: Dict[str, dict] = {}
    ranks: Dict[str, dict] = {}
    for rank, st in merged["ranks"].items():
        counters, gauges, hists, dur = _fold_windows(
            st["windows"], windows)
        dur = max(dur, 1e-9)
        link = sum((counters.get(_LINK_BYTES) or {}).values())
        deaths = sum((counters.get(_DEATHS) or {}).values())
        spec = sum((counters.get(_SPECULATIONS) or {}).values())
        retry = sum((counters.get(_RETRIES) or {}).values())
        ranks[rank] = {
            "epoch": st["epoch"],
            "last_window": st["last_window"],
            "windows": len(st["windows"]),
            "link_bytes_s": round(link / dur, 1),
            "deaths": deaths,
            "speculations": spec,
            "fleet_epoch_gauge": (gauges.get(_EPOCH) or {}).get(""),
        }
        qw = hists.get(_QUEUE_WAIT)
        slo = st["meta"].get("slo") or {}
        tenant_names = set()
        for fam in (_COMPLETED, _QUEUED, _RUNNING, _TENANT_BYTES):
            for key in (counters.get(fam) or {}):
                tenant_names.add(key.split("|")[0])
            for key in (gauges.get(fam) or {}):
                tenant_names.add(key.split("|")[0])
        if qw:
            tenant_names.update(k.split("|")[0]
                                for k in qw["series"])
        attr = counters.get(_ATTR_TIME) or {}
        tenant_names.update(k.split("|")[0] for k in attr)
        tenant_names.update(counters.get(_STATS_ROWS) or {})
        # result-cache label order is (scope, tenant)
        for fam in (_RC_HITS, _RC_MISSES):
            for key in (counters.get(fam) or {}):
                parts = key.split("|")
                if len(parts) > 1 and parts[1] not in ("", "-"):
                    tenant_names.add(parts[1])
        tenant_names.update(slo)
        for t in tenant_names:
            row = tenants.setdefault(t, {
                "queued": 0, "running": 0, "device_bytes": 0,
                "completed_s": 0.0, "requeued_s": 0.0,
                "retry_s": 0.0, "rows_s": 0.0,
                "cache_hit_ratio": None, "recent_p50_ms": None,
                "recent_p99_ms": None, "recent_events": 0,
                "slo": None, "where": {}, "where_dominant": None,
                "_rc_hits": 0, "_rc_misses": 0})
            row["queued"] += int(
                (gauges.get(_QUEUED) or {}).get(t, 0))
            row["running"] += int(
                (gauges.get(_RUNNING) or {}).get(t, 0))
            row["device_bytes"] += int(
                (gauges.get(_TENANT_BYTES) or {}).get(t, 0))
            comp = sum(v for k, v in
                       (counters.get(_COMPLETED) or {}).items()
                       if k.split("|")[0] == t)
            row["completed_s"] = round(
                row["completed_s"] + comp / dur, 3)
            req = sum(v for k, v in
                      (counters.get(_REQUEUED) or {}).items()
                      if k.split("|")[0] == t)
            row["requeued_s"] = round(
                row["requeued_s"] + req / dur, 3)
            row["retry_s"] = round(row["retry_s"] + retry / dur, 3)
            # data-plane satellites: rows/s delivered +
            # result-cache hit ratio — both already in the registry,
            # now rendered
            rows = (counters.get(_STATS_ROWS) or {}).get(t, 0)
            row["rows_s"] = round(row["rows_s"] + rows / dur, 1)
            for fam, slot in ((_RC_HITS, "_rc_hits"),
                              (_RC_MISSES, "_rc_misses")):
                row[slot] += sum(
                    v for k, v in (counters.get(fam) or {}).items()
                    if len(k.split("|")) > 1
                    and k.split("|")[1] == t)
            if qw and t in qw["series"]:
                s = qw["series"][t]
                bc = s["bucket_counts"]
                row["recent_events"] += s["count"]
                row["recent_p50_ms"] = round(histogram_quantile(
                    qw["buckets"], bc, 0.50) / 1e6, 3)
                row["recent_p99_ms"] = round(histogram_quantile(
                    qw["buckets"], bc, 0.99) / 1e6, 3)
            for key, v in attr.items():
                parts = key.split("|")
                if parts[0] != t or len(parts) < 2:
                    continue
                bucket = parts[1]
                row["where"][bucket] = int(
                    row["where"].get(bucket, 0) + v)
            if row["where"]:
                row["where_dominant"] = max(row["where"],
                                            key=row["where"].get)
            if t in slo:
                row["slo"] = slo[t]
    for row in tenants.values():
        hits, misses = row.pop("_rc_hits"), row.pop("_rc_misses")
        if hits + misses > 0:
            row["cache_hit_ratio"] = round(hits / (hits + misses), 4)
    return {"epoch": merged["epoch"],
            "ranks": {k: ranks[k] for k in sorted(ranks)},
            "tenants": {k: tenants[k] for k in sorted(tenants)}}


# ---------------------------------------------------------- rendering


def render_frame(frame: dict) -> List[str]:
    out = [f"fleet epoch {frame['epoch']}  "
           f"ranks {len(frame['ranks'])}  "
           f"tenants {len(frame['tenants'])}", ""]
    tenants = frame["tenants"]
    out.append("tenants (recent percentiles from windowed buckets)")
    hdr = (f"{'tenant':<12}  {'run':>3}  {'qd':>3}  {'p50_ms':>8}  "
           f"{'p99_ms':>8}  {'cmpl/s':>7}  {'rows/s':>8}  "
           f"{'hit%':>5}  {'rq/s':>5}  "
           f"{'dev_MB':>7}  {'burn_f':>6}  {'burn_s':>6}  "
           f"{'attain':>6}  {'where':<15}")
    out.append(hdr)
    out.append("-" * len(hdr))
    if not tenants:
        out.append("(no tenant activity in the window)")
    for t, r in tenants.items():
        slo = r.get("slo") or {}

        def _n(v, fmt="{:.3f}"):
            return "-" if v is None else fmt.format(v)

        def _hit(v):
            return "-" if v is None else f"{100.0 * v:.1f}"

        out.append(
            f"{t[:12]:<12}  {r['running']:>3}  {r['queued']:>3}  "
            f"{_n(r['recent_p50_ms']):>8}  "
            f"{_n(r['recent_p99_ms']):>8}  "
            f"{r['completed_s']:>7.2f}  {r['rows_s']:>8.1f}  "
            f"{_hit(r.get('cache_hit_ratio')):>5}  "
            f"{r['requeued_s']:>5.2f}  "
            f"{r['device_bytes'] / 1e6:>7.1f}  "
            f"{_n(slo.get('burn_fast'), '{:.2f}'):>6}  "
            f"{_n(slo.get('burn_slow'), '{:.2f}'):>6}  "
            f"{_n(slo.get('attainment'), '{:.4f}'):>6}  "
            f"{(r.get('where_dominant') or '-')[:15]:<15}")
    out.append("")
    out.append("fleet ranks")
    hdr = (f"{'rank':>4}  {'epoch':>5}  {'windows':>7}  "
           f"{'link_B/s':>10}  {'deaths':>6}  {'spec':>5}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for rank, r in frame["ranks"].items():
        out.append(f"{rank:>4}  {r['epoch']:>5}  {r['windows']:>7}  "
                   f"{r['link_bytes_s']:>10.1f}  {r['deaths']:>6}  "
                   f"{r['speculations']:>5}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srt-top",
        description="live fleet telemetry dashboard over windowed "
                    "timeseries snapshots")
    ap.add_argument("inputs", nargs="*",
                    help="timeseries_rank*.json and/or "
                         "fleet_timeseries.json files")
    ap.add_argument("--dump-dir", default=None,
                    help="poll a launcher outdir for snapshot files")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable frame (sorted keys, no "
                         "wall-clock content: byte-stable over "
                         "identical inputs)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="live-mode refresh seconds (default 2)")
    ap.add_argument("--windows", type=int, default=12,
                    help="recent windows folded per frame "
                         "(default 12)")
    args = ap.parse_args(argv)
    if not args.inputs and not args.dump_dir:
        ap.error("give snapshot files or --dump-dir")

    def frame_once() -> dict:
        paths = list(args.inputs)
        if args.dump_dir:
            paths += discover_inputs(args.dump_dir)
        if not paths:
            print(f"(no snapshot files in {args.dump_dir} yet)",
                  file=sys.stderr)
        return build_frame(load_fleet(paths), windows=args.windows)

    if args.once:
        frame = frame_once()
        if args.json:
            print(json.dumps(frame, sort_keys=True, indent=1))
        else:
            print("\n".join(render_frame(frame)))
        return 0
    try:
        while True:
            frame = frame_once()
            sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print("\n".join(render_frame(frame)))
            sys.stdout.flush()
            time.sleep(max(args.interval, 0.2))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
