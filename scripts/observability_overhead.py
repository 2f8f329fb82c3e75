#!/usr/bin/env python3
"""What turning observability on costs one map task's kudo write.

    python3 scripts/observability_overhead.py [--device cuda] [--rows N]
        [--ballast M] [--iters K]

Builds chip_smoke.py's observability shuffle input (a store_sales batch
in 200 hash partitions, read to the host once) and times the metered
write of all 200 partitions into one stream (median of ``--iters``)
with observability off, metrics only, tracing only, and both; each
with Python's cyclic garbage collector on and off, and each in a
process holding ``--ballast`` million extra small live objects (0 and
the given count), since a full collection walks every live object.
Then profiles one traced write with cProfile.  Prints one JSON object;
the card's name and power limit come first when it runs on the card.
"""

import argparse
import cProfile
import gc
import io
import json
import os
import pstats
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402
from spark_rapids_tpu_torch import observability as obs  # noqa: E402
from spark_rapids_tpu_torch.shuffle import kudo as K  # noqa: E402

MODES = {"off": (False, False), "metrics": (True, False),
         "tracing": (False, True), "both": (True, True)}


def timed(fn, iters):
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=C.OBS_SHUFFLE_ROWS)
    ap.add_argument("--ballast", type=float, default=5.0,
                    help="millions of extra live objects")
    ap.add_argument("--iters", type=int, default=7)
    args = ap.parse_args()
    out = {"device": args.device, "rows": args.rows,
           "partitions": C.SHUFFLE_PARTITIONS}
    if args.device == "cuda":
        import torch
        out["card"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    table = C.store_sales_batch(args.rows, seed=18, device=args.device)
    ordered, bounds = C.obs_partitions(table, args.device)
    views = K.prepare_host_columns(ordered.columns)
    ms = {}
    ballast = []
    for heap in (0, args.ballast):
        ballast = [(i,) for i in range(int(heap * 1e6))]
        for collector in ("gc_on", "gc_off"):
            (gc.enable if collector == "gc_on" else gc.disable)()
            for mode, (metrics, tracing) in MODES.items():
                (obs.enable if metrics else obs.disable)()
                (obs.enable_tracing if tracing else obs.disable_tracing)()
                obs.reset()
                ms[f"ballast_{heap:g}M/{collector}/{mode}"] = timed(
                    lambda: C.obs_write(views, bounds), args.iters)
            gc.enable()
    del ballast
    obs.enable()
    obs.enable_tracing()
    obs.reset()
    prof = cProfile.Profile()
    prof.enable()
    C.obs_write(views, bounds)
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(12)
    out["write_ms"] = ms
    out["profile_tottime_top"] = [
        line.strip() for line in buf.getvalue().splitlines()
        if line.strip() and line.strip()[0].isdigit()][:12]
    obs.disable()
    obs.disable_tracing()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
