"""Multi-rank dry run: the mesh programs over R gloo ranks on the CPU.

    python -m spark_rapids_tpu_torch.distributed.dryrun --ranks 4

starts R rank processes in one gloo group (distributed/pool.RankPool)
and checks two mesh paths end to end:

  * the hash aggregate (models/query.make_distributed_hash_aggregate):
    murmur3 partition -> all-to-all -> bucketed sums; every row must
    arrive (the counts sum to the rows, the unit values' sums too);
  * the distributed join (models/distributed_join.make_distributed_join):
    partition -> all-to-all -> local device join; the joined
    (key, left, right) triples must equal a host join's.

It prints one JSON line of what it saw and exits 0, or raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def aggregate_rank(mesh, keys: np.ndarray, vals: np.ndarray):
    """One rank of the hash aggregate over this rank's shard."""
    import torch

    from spark_rapids_tpu_torch.models.query import \
        make_distributed_hash_aggregate
    step, shard = make_distributed_hash_aggregate(
        mesh, n_parts=mesh.size, num_buckets=32, capacity=64)
    return step(shard(torch.from_numpy(keys).to(mesh.device)),
                shard(torch.from_numpy(vals).to(mesh.device)))


def join_rank(mesh, lk: np.ndarray, lv: np.ndarray, rk: np.ndarray,
              rv: np.ndarray):
    """One rank of the distributed join over this rank's shards."""
    import torch

    from spark_rapids_tpu_torch.models.distributed_join import \
        make_distributed_join
    join = make_distributed_join(mesh, exch_cap=64, pair_cap=512)
    return join(*(mesh.shard(torch.from_numpy(x).to(mesh.device))
                  for x in (lk, lv, rk, rv)))


def host_join(lk, lv, rk, rv):
    """Sorted (key, left value, right value) triples of the inner join."""
    by_key = {}
    for k, v in zip(rk.tolist(), rv.tolist()):
        by_key.setdefault(k, []).append(v)
    return sorted((k, a, b) for k, a in zip(lk.tolist(), lv.tolist())
                  for b in by_key.get(k, ()))


def dryrun(ranks: int, *, timeout_s: float = 120.0) -> dict:
    """Both paths over ``ranks`` gloo CPU ranks; returns what it saw."""
    from spark_rapids_tpu_torch.distributed.pool import RankPool
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    rows = 16 * ranks
    keys = rng.integers(0, 1000, rows, dtype=np.int64)
    vals = np.ones(rows, np.float32)
    jrows = 8 * ranks
    lk = rng.integers(0, 50, jrows, dtype=np.int64)
    rk = rng.integers(0, 50, jrows, dtype=np.int64)
    lv = np.arange(jrows, dtype=np.int64)
    rv = np.arange(jrows, dtype=np.int64) + 1000
    with RankPool(ranks, device="cpu", backend="gloo",
                  timeout_s=timeout_s) as pool:
        boot_s = pool.boot_wall_s
        agg = pool.run(aggregate_rank, keys, vals)
        joined = pool.run(join_rank, lk, lv, rk, rv)
    counts = int(sum(r[1].sum() for r in agg))
    sums = float(sum(r[0].sum() for r in agg))
    if counts != rows or sums != rows:
        raise AssertionError(f"the aggregate lost rows: counts {counts}, "
                             f"sums {sums}, rows {rows}")
    if any(bool(r[5].any()) for r in joined):
        raise AssertionError("the distributed join overflowed")
    got = sorted((int(k), int(a), int(b)) for r in joined
                 for k, a, b, ok in zip(r[0][0], r[1][0], r[2][0],
                                        r[3][0]) if ok)
    want = host_join(lk, lv, rk, rv)
    if got != want:
        raise AssertionError(f"the distributed join gave {len(got)} "
                             f"pairs, the host join {len(want)}")
    return {"ranks": ranks, "backend": "gloo", "aggregate_rows": rows,
            "join_pairs": len(got), "boot_s": boot_s,
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds for the group and each call")
    args = ap.parse_args(argv)
    print(json.dumps(dryrun(args.ranks, timeout_s=args.timeout)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
