"""bench-trend: the perf trajectory across bench rounds.

::

    python -m spark_rapids_tpu_torch.tools.bench_trend [--dir REPO]
    ... --json     machine-readable, key-sorted, golden-stable

Folds every ``BENCH_r*.json`` / ``BENCH_serve_r*.json`` the bench
drivers left at the repo root into ONE table: per round, the headline
metric that round was about, its value/unit, the delta vs the previous
*comparable* round (same metric+unit — a round that switched headline
metrics starts a new series rather than faking a delta), and a
regression flag when a comparable headline dropped by more than
``--tolerance`` (default 5%).

The extractors mirror the writers: rounds r01–r05 are the row-conversion
bench (``parsed.metric/value/unit``), r06 the kernel+TPC-DS sweep
(headline: fused-pipeline q5 rows/s), r07 the whole-stage-fusion smoke
(headline: fused q5 speedup), r08 the out-of-core join bench, and the
``serve_*`` rounds the multi-tenant serving replays (throughput QPS;
r03 the cached-serving run).  Unknown/new round files degrade to a
"(no extractor)" row instead of failing the whole table, so the next
bench round does not break the trend until its extractor lands.

Exit status: 0 clean, 1 when any regression was flagged, 2 usage.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

# flag a drop bigger than this fraction vs the previous comparable
# round (bench noise on shared boxes sits well under it)
DEFAULT_TOLERANCE = 0.05


def repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def _load(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        return d if isinstance(d, dict) else None
    except (OSError, ValueError):
        return None


# --------------------------------------------------------- extractors
# one per bench-round schema; each returns the round's headline
# {metric, value, unit} plus whatever secondary numbers make the row
# readable.  Higher value = better for every headline emitted here,
# which is what the delta/regression logic assumes.


def _x_rowconv(parsed: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """r01–r05: ``{"metric", "value", "unit", "vs_baseline"}``."""
    if "value" not in parsed or "metric" not in parsed:
        return None
    out = {"metric": "rowconv_GBps", "value": float(parsed["value"]),
           "unit": str(parsed.get("unit", ""))}
    if "vs_baseline" in parsed:
        out["detail"] = f"x{parsed['vs_baseline']:g} vs baseline"
    return out


def _x_kernel_sweep(parsed: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """r06: bench_all kernel + TPC-DS sweep — headline q5 rows/s."""
    tp = parsed.get("tpcds_2e6")
    if not isinstance(tp, dict) or "q5_rows_per_s" not in tp:
        return None
    out = {"metric": "tpcds_q5_rows_per_s",
           "value": float(tp["q5_rows_per_s"]), "unit": "rows/s"}
    extras = []
    for q in ("q3", "q9", "q72_cs", "q7"):
        v = tp.get(f"{q}_rows_per_s")
        if v is not None:
            extras.append(f"{q} {float(v) / 1e6:.2f}M")
    if extras:
        out["detail"] = "also " + ", ".join(extras) + " rows/s"
    return out


def _x_fusion(parsed: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """r07: whole-stage fusion smoke — headline fused q5 speedup."""
    sf = parsed.get("stage_fusion")
    if not isinstance(sf, dict) or "q5" not in sf:
        return None
    q5 = sf["q5"]
    out = {"metric": "fused_q5_speedup",
           "value": float(q5["speedup"]), "unit": "x"}
    bits = [f"{q} x{sf[q]['speedup']:g}" for q in ("q3", "q72")
            if isinstance(sf.get(q), dict) and "speedup" in sf[q]]
    exe = parsed.get("executables") or {}
    if exe.get("second_same_bucket_query_compiles") == 0:
        bits.append("0 recompiles warm")
    if bits:
        out["detail"] = ", ".join(bits)
    return out


def _x_out_of_core(parsed: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """r08: tiered-spill out-of-core join bench."""
    ooc = parsed.get("out_of_core_join")
    if not isinstance(ooc, dict) or "probe_mrows_per_s" not in ooc:
        return None
    out = {"metric": "ooc_join_probe_Mrows_per_s",
           "value": float(ooc["probe_mrows_per_s"]), "unit": "Mrows/s"}
    if "spills" in ooc:
        out["detail"] = (f"{ooc['spills']} spills, "
                         f"{ooc.get('spill_gb_per_s', 0):g} GB/s out")
    return out


def _x_serve(parsed: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """serve_r01/r02/r03: serving replay / ramp / cached-serving."""
    if "throughput_qps" in parsed:
        return {"metric": "serve_qps",
                "value": float(parsed["throughput_qps"]), "unit": "qps",
                "detail": f"{parsed.get('requests', '?')} requests, "
                          f"concurrency {parsed.get('concurrency', '?')}"}
    steps = parsed.get("steps")
    if isinstance(steps, list) and steps:
        # achieved QPS at the top OFFERED step — load-following, not
        # capacity, so it gets its own series rather than a fake delta
        # vs the burst-throughput rounds
        last = steps[-1]
        if "qps_achieved" in last:
            return {"metric": "serve_ramp_qps",
                    "value": float(last["qps_achieved"]), "unit": "qps",
                    "detail": f"ramp {parsed.get('ramp', '?')}, top step "
                              f"offered {last.get('qps_offered', '?')}"}
    on = parsed.get("cache_on")
    if isinstance(on, dict) and "qps" in on:
        out = {"metric": "serve_cached_qps",
               "value": float(on["qps"]), "unit": "qps",
               "detail": f"hit ratio {on.get('hit_ratio', 0):.2%}"}
        sp = parsed.get("warm_vs_cold_median_speedup")
        if sp is not None:
            out["detail"] += f", warm x{sp:g} vs cold"
        return out
    return None


_EXTRACTORS = (_x_fusion, _x_kernel_sweep, _x_out_of_core, _x_serve,
               _x_rowconv)


def _round_label(path: str) -> str:
    name = os.path.basename(path)
    if name.startswith("BENCH_") and name.endswith(".json"):
        name = name[len("BENCH_"):-len(".json")]
    return name


def collect(paths: List[str]) -> List[Dict[str, Any]]:
    """One row per bench file, in the given order (the caller sorts
    paths so serve rounds trail the numbered kernel rounds)."""
    rows: List[Dict[str, Any]] = []
    for path in paths:
        d = _load(path)
        row: Dict[str, Any] = {"round": _round_label(path),
                               "file": os.path.basename(path)}
        if d is None:
            row["error"] = "unreadable"
            rows.append(row)
            continue
        parsed = d.get("parsed")
        head = None
        if isinstance(parsed, dict):
            for ex in _EXTRACTORS:
                head = ex(parsed)
                if head is not None:
                    break
        if head is None:
            row["error"] = "no extractor"
        else:
            row.update(head)
        rows.append(row)
    return rows


def annotate(rows: List[Dict[str, Any]],
             tolerance: float = DEFAULT_TOLERANCE) -> None:
    """Delta + regression flags, in place.  A delta only exists vs the
    most recent EARLIER row with the same metric+unit — new headline
    metrics start a new series at delta '-'."""
    last: Dict[str, float] = {}
    for row in rows:
        if "value" not in row:
            continue
        key = f"{row['metric']}|{row['unit']}"
        prev = last.get(key)
        if prev is not None and prev > 0:
            delta = (row["value"] - prev) / prev
            row["delta_pct"] = round(100.0 * delta, 1)
            row["regression"] = bool(delta < -tolerance)
        last[key] = row["value"]


def _fmt_value(row: Dict[str, Any]) -> str:
    v = row["value"]
    if abs(v) >= 1e6:
        return f"{v / 1e6:.2f}M"
    if abs(v) >= 1e4:
        return f"{v / 1e3:.1f}k"
    return f"{v:g}"


def render(rows: List[Dict[str, Any]]) -> str:
    out = ["bench trend (headline metric per round; delta vs previous "
           "comparable round)"]
    hdr = (f"{'round':<10}  {'metric':<26}  {'value':>9}  "
           f"{'unit':<8}  {'delta':>7}  {'flag':<4}  detail")
    out.append(hdr)
    out.append("-" * len(hdr))
    for row in rows:
        if "value" not in row:
            out.append(f"{row['round']:<10}  "
                       f"({row.get('error', 'empty')})")
            continue
        delta = ("-" if "delta_pct" not in row
                 else f"{row['delta_pct']:+.1f}%")
        flag = "REG" if row.get("regression") else ""
        out.append(f"{row['round']:<10}  {row['metric']:<26}  "
                   f"{_fmt_value(row):>9}  {row['unit']:<8}  "
                   f"{delta:>7}  {flag:<4}  {row.get('detail', '')}")
    regs = [r["round"] for r in rows if r.get("regression")]
    out.append("")
    out.append(f"{len([r for r in rows if 'value' in r])} rounds, "
               f"{len(regs)} regression(s)"
               + (f": {', '.join(regs)}" if regs else ""))
    return "\n".join(out)


def _default_paths(root: str) -> List[str]:
    # numbered kernel rounds first, then the serving rounds — each is
    # its own chronological series and the delta logic keys on metric
    # name anyway
    num = sorted(p for p in glob.glob(os.path.join(root, "BENCH_r*.json")))
    serve = sorted(
        p for p in glob.glob(os.path.join(root, "BENCH_serve_r*.json")))
    return num + serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bench-trend",
        description="fold per-round BENCH_*.json files into one perf "
                    "trajectory table")
    ap.add_argument("files", nargs="*",
                    help="explicit bench files (default: BENCH_r*.json "
                         "+ BENCH_serve_r*.json under --dir)")
    ap.add_argument("--dir", default=repo_root(),
                    help="directory to glob bench files from")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="fractional drop vs previous comparable round "
                         "that flags a regression (default 0.05)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable, key-sorted, golden-stable")
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        return 2
    paths = args.files or _default_paths(args.dir)
    if not paths:
        print(f"bench-trend: no BENCH_*.json files under {args.dir}",
              file=sys.stderr)
        return 2
    rows = collect(paths)
    annotate(rows, tolerance=args.tolerance)
    regressions = sum(1 for r in rows if r.get("regression"))
    if args.json:
        print(json.dumps({"rounds": rows, "regressions": regressions,
                          "tolerance": args.tolerance},
                         sort_keys=True, indent=1))
    else:
        print(render(rows))
    return 1 if regressions else 0


if __name__ == "__main__":
    sys.exit(main())
