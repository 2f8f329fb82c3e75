"""The rank side of the JNI door's mesh entries
(``jni_entry.flagship_q5_mesh`` / ``flagship_q72_mesh``).

The JVM caller is one process, and a mesh program runs one process per
rank (distributed/mesh.py), so the entries run their ranks in a
:class:`~spark_rapids_tpu_torch.distributed.pool.RankPool` started at
first use on the entries' device (utils/platform.entry_device) and
kept for the next call: a second call pays no second boot, and each
rank keeps its steps and the join capacity it learned
(``_Q5_MESH_STEPS``, ``_Q72_MESH_STEPS``).  ``jni_entry.shutdown()``
stops the pools.  The caller's process never joins a group.

A rank count above ``platform.mesh_ranks_allowed()`` raises
ShimStateError before anything starts: a silent single-device run
would fake the distribution being proven.  The join capacity starts
at the JAX entries' 4096 pairs and doubles collectively while any rank
overflows (parallel/exchange.with_capacity_retry over the group), so
a call at the size of a real batch runs where the JAX entry, fixed at
4096, raises.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

from spark_rapids_tpu_torch.shim.errors import ShimStateError
from spark_rapids_tpu_torch.utils import platform as _platform

MESH_JOIN_CAPACITY = 1 << 12
MESH_MAX_DOUBLINGS = 16
Q72_MAX_WEEK = 16
Q72_WEEK0 = 11_000 // 7

_POOLS: Dict[Tuple[int, str], object] = {}
_POOLS_LOCK = threading.Lock()

# what the last mesh call saw: the pool's boot and every rank's numbers
LAST_CALL: dict = {}


def pool_for(n: int):
    """The started pool of ``n`` ranks on the entries' device, starting
    it at first use; ShimStateError past the allowed ranks."""
    from spark_rapids_tpu_torch.distributed.pool import RankPool
    device = _platform.entry_device()
    have = _platform.mesh_ranks_allowed()
    if n < 1 or n > have:
        hint = (" (set SPARK_RAPIDS_TPU_CPU_DEVICES before init)"
                if device == "cpu" else "")
        raise ShimStateError(
            f"mesh wants {n} devices, backend has {have}{hint}")
    with _POOLS_LOCK:
        pool = _POOLS.get((n, device))
        if pool is None or pool.closed:
            pool = _POOLS[(n, device)] = RankPool(n, device=device)
        return pool


def run_entry(n: int, fn, *args):
    """Run the rank program ``fn`` on an ``n``-rank pool; rank 0's list.
    A failed rank closes its pool (the next attempt boots a new one).
    A rank that raised a retryable OOM inside its step (where it cannot
    re-run its collectives alone) has the whole call re-run on fresh
    ranks, under the retry driver, as one controller re-runs the whole
    mesh step in JAX; any other failure surfaces as ShimStateError."""
    from spark_rapids_tpu_torch.distributed.pool import RankFailed
    from spark_rapids_tpu_torch.memory import exceptions as exc
    from spark_rapids_tpu_torch.robustness import retry
    t0 = time.perf_counter()

    def attempt():
        pool = pool_for(int(n))
        try:
            return pool, pool.run(fn, *args)
        except RankFailed as e:
            if e.retryable:
                raise exc.GpuRetryOOM(f"mesh rank OOM: {e}") from e
            raise ShimStateError(f"mesh entry failed: {e}") from e

    try:
        pool, results = retry.with_retry(
            attempt, name=f"mesh_entry:{getattr(fn, '__name__', 'call')}")
    except retry.RetryExhausted as e:
        raise ShimStateError(f"mesh entry failed: {e}") from e
    LAST_CALL.clear()
    LAST_CALL.update(backend=pool.backend, boot=pool.ranks,
                     boot_wall_s=pool.boot_wall_s,
                     wall_s=time.perf_counter() - t0,
                     ranks=[info for _flat, info in results])
    flat, _info = results[0]
    return flat


def stop_pools() -> None:
    with _POOLS_LOCK:
        pools = list(_POOLS.values())
        _POOLS.clear()
    for pool in pools:
        pool.close()


# ------------------------------------------------------ rank programs

_Q5_MESH_STEPS: dict = {}
_Q72_MESH_STEPS: dict = {}


def _learned_run(cache: dict, key, build, args, mesh):
    """Run a capacity-parameterized step from the capacity this rank
    learned for ``key`` (the JAX entries' 4096 the first time), under
    the collective overflow retry; remembers what it settled on."""
    from spark_rapids_tpu_torch.models import tpcds
    from spark_rapids_tpu_torch.parallel.exchange import CapacityExceeded
    entry = cache.get(key)
    if entry is None:
        entry = cache[key] = {"build": build,
                              "capacity": MESH_JOIN_CAPACITY}
    start = entry["capacity"]
    try:
        out, cap = tpcds.run_with_capacity_retry(
            entry["build"], args, start, MESH_MAX_DOUBLINGS, mesh=mesh)
    except CapacityExceeded as e:
        raise ShimStateError(f"mesh overflow: {e}") from e
    entry["capacity"] = cap
    doublings = (cap // start).bit_length() - 1
    return out, {"capacity": cap, "doublings": doublings}


def _rank_start(mesh) -> float:
    """Zero this rank's counters (collectives, row-kernel launches) and
    its clock."""
    from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA
    mesh.stats.reset()
    RA.reset_launches()
    _sync(mesh)
    return time.perf_counter()


def _rank_info(mesh, t0: float, extra: dict) -> dict:
    """This rank's numbers since _rank_start: ms, collectives, the row
    kernels it launched (``launches``), peak MiB on a card."""
    import torch
    from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA
    info = dict(extra, rank=mesh.rank, ms=(time.perf_counter() - t0) * 1e3,
                launches=dict(RA.LAUNCHES), **mesh.stats.as_dict())
    if mesh.device.type == "cuda":
        info["peak_mib"] = torch.cuda.max_memory_allocated(
            mesh.device) / 2**20
    return info


def _sync(mesh) -> None:
    import torch
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def q5_rank(mesh, rows: int, stores: int) -> Tuple[List[int], dict]:
    """One rank of flagship_q5_mesh: q5 over the group on this rank's
    shard of ``q5_mesh_data``; the live group rows flattened as
    [store_id, sales, returns, profit, ...] (replicated), and this
    rank's numbers."""
    from spark_rapids_tpu_torch.models import tpcds
    stores = int(stores)
    d = tpcds.q5_mesh_data(int(rows), stores, mesh.size,
                           device=mesh.device)
    args = [mesh.shard(x) for x in d[:8]] + [d.d_date, d.st_id]
    t0 = _rank_start(mesh)
    (key_s, sales, rets, profit, _of), info = _learned_run(
        _Q5_MESH_STEPS, (mesh.size, stores),
        lambda cap: tpcds.make_q5_multichip(mesh, stores, cap), args,
        mesh)
    key = key_s.cpu().numpy()
    live = key != 2**31 - 1
    out: List[int] = []
    for k, a, b, c in zip(key[live], sales.cpu().numpy()[live],
                          rets.cpu().numpy()[live],
                          profit.cpu().numpy()[live]):
        out.extend([int(k), int(a), int(b), int(c)])
    return out, _rank_info(mesh, t0, info)


def q72_rank(mesh, cs_rows: int, items: int) -> Tuple[List[int], dict]:
    """One rank of flagship_q72_mesh: live (item, week, count) triples
    flattened (replicated), and this rank's numbers."""
    from spark_rapids_tpu_torch.models import tpcds
    items = int(items)
    d = tpcds.q72_mesh_data(int(cs_rows), items, mesh.size,
                            device=mesh.device)
    args = [mesh.shard(x) for x in d[:3]] + list(d[3:])
    t0 = _rank_start(mesh)
    (ti, tw, tc, _of), info = _learned_run(
        _Q72_MESH_STEPS, (mesh.size, items),
        lambda cap: tpcds.make_q72_multichip(
            mesh, items, Q72_MAX_WEEK, join_capacity=cap,
            week0=Q72_WEEK0), args, mesh)
    cnts = tc.cpu().numpy()
    live = cnts > 0
    out: List[int] = []
    for i, w, c in zip(ti.cpu().numpy()[live], tw.cpu().numpy()[live],
                       cnts[live]):
        out.extend([int(i), int(w), int(c)])
    return out, _rank_info(mesh, t0, info)
