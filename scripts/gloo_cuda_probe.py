#!/usr/bin/env python3
"""Whether gloo runs its collectives on CUDA tensors, and what one
all_to_all costs on them against one staged through the host by hand,
on one GPU.

    python3 scripts/gloo_cuda_probe.py [--mib 64]

Starts two rank processes sharing card 0 in one gloo group
(spark_rapids_tpu_torch.distributed.pool.RankPool) and, on each rank:
tries ``all_reduce`` and ``all_to_all_single`` straight on CUDA tensors
(the answer: ``native_all_reduce`` / ``native_all_to_all``, true or the
error), then times an ``all_to_all`` of ``--mib`` MiB per rank copied
to the host, exchanged there and copied back (``staged_ms``) and, where
the native call worked, straight on the CUDA tensors (``native_ms``:
what the port's ``Mesh.all_to_all`` does), each the median of 5
synchronized calls.
Prints one JSON line per rank and the card's name and power limit.
Exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def probe_rank(mesh, mib: int):
    import torch
    import torch.distributed as dist
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "backend": mesh.backend}
    x = torch.arange(8, dtype=torch.int64, device=mesh.device)
    try:
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        torch.cuda.synchronize()
        out["native_all_reduce"] = bool(torch.equal(y, x * mesh.size))
    except Exception as e:  # noqa: BLE001 — the probe's answer
        out["native_all_reduce"] = f"{type(e).__name__}: {e}"[:300]
    try:
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=mesh.group)
        torch.cuda.synchronize()
        out["native_all_to_all"] = True
    except Exception as e:  # noqa: BLE001 — the probe's answer
        out["native_all_to_all"] = f"{type(e).__name__}: {e}"[:300]

    big = torch.ones((mib << 20) // 8, dtype=torch.int64,
                     device=mesh.device)

    def median_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[2]

    def staged():
        send = big.cpu()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group)
        return recv.to(mesh.device)

    staged()       # warm-up
    out["staged_ms"] = median_ms(staged)
    if out["native_all_to_all"] is True:
        recv = torch.empty_like(big)
        out["native_ms"] = median_ms(
            lambda: dist.all_to_all_single(recv, big, group=mesh.group))
    out["mib"] = mib
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=64)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch.distributed.pool import RankPool
    with RankPool(2, device="cuda", backend="gloo", timeout_s=120) as pool:
        for res in pool.run(probe_rank, args.mib):
            print(json.dumps(res), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
