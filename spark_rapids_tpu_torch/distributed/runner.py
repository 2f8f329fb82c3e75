"""Distributed TPC-DS worker: q5/q72 as real processes.

Execution plan per rank (the process-per-shard harness: table movement
ALWAYS rides the shuffle service, which is the contract under test):

  1. scan: every rank regenerates the seeded dataset on its device and
     takes its row shard (deterministic, no data files needed);
  2. partials: the map side runs as ONE fused stage through the stage
     IR (plan/catalog), under ``exchange.with_capacity_retry``
     (overflow doubles the join budget).
     ``SPARK_RAPIDS_TPU_STAGE_FUSION=0`` takes the op-by-op hand
     pipelines' map sides (``models/tpcds._q5_partials`` /
     ``_q72_partials``), the byte-identity oracle of the fused path;
  3. reduce-scatter: the partial group table is sliced into rank-owned
     chunks, each chunk shipped to its owner as kudo tables over the
     socket shuffle (partition -> kudo write -> transport -> kudo
     merge); owners sum their received chunks (exact int64: any arrival
     order is byte-identical);
  4. allgather: owners re-share their summed chunks; every rank
     reassembles the GLOBAL group table;
  5. finish: the reduce side is the matching fused finish stage, or the
     hand pipelines' ``_q5_finish`` / ``_q72_finish`` under the escape
     hatch; either way the output bytes equal the single-process
     pipeline's by construction.

The query functions and ``main`` take a device (``--device``, "cuda"
unless the caller asks for the CPU, as the tests do): data, partials,
merges and the finish live there; kudo carries the bytes between
processes.  Several ranks may share one card.

Run as a module (``python -m spark_rapids_tpu_torch.distributed.runner``)
by the launcher; the per-query entry points are also importable for
in-process tests against any table transport.  Each query opens a
query span; a worker runs with metrics and tracing on, parents its
process span under the trace context its launcher seeds
(``SPARK_RAPIDS_TPU_DIST_TRACE_CTX``), and dumps its spans, metrics and
journal next to its summary (``spans_rank{r}.jsonl``,
``metrics_rank{r}.json``, ``journal_rank{r}.jsonl``).  With profiling
on each query also leaves ``profile_{op}_rank{r}.json`` (and a
same-moment ``metrics_{op}_rank{r}.json``); with the timeseries plane
on, ``timeseries_rank{r}.json`` with its same-moment
``metrics_ts_rank{r}.json``, published to rank 0, which writes
``fleet_timeseries.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from spark_rapids_tpu_torch import observability as _obs

# default query shapes: the launcher AND the single-process reference
# import these so the comparison can never drift
Q5_PARAMS = dict(rows=4096, stores=32, days=60,
                 join_capacity=1 << 14)
Q72_PARAMS = dict(cs_rows=4096, inv_rows=64, items=64, max_week=16,
                  days=35, join_capacity=1 << 17, limit=100,
                  week0=11_000 // 7)


class OpIds:
    """Centralized op-id allocation: one id per (query, stage) so
    concurrent exchanges can never cross payloads."""

    Q5_REDUCE_SCATTER = 101
    Q5_ALLGATHER = 102
    Q72_REDUCE_SCATTER = 111
    Q72_ALLGATHER = 112
    EQ5_PARTS = 121       # elastic q5: per-shard partial broadcast
    BARRIER = 900
    ELASTIC_BARRIER = 901


def _die_spec() -> Optional[tuple]:
    """Injected worker death (chaos for the elastic fleet):
    ``SPARK_RAPIDS_TPU_DIST_DIE="<where>[:<rc>]"`` with ``where`` in
    {'boot', 'q5:scan', 'q5:partials'}.  boot exits immediately at
    worker start (the launcher fast-fail path); q5:scan exits after
    generating the dataset, BEFORE any partials exist (survivors'
    sends fail -> membership barrier -> the inheritor recomputes the
    dead shard); q5:partials exits AFTER computing this rank's partials
    but BEFORE broadcasting them (work genuinely lost)."""
    spec = os.environ.get("SPARK_RAPIDS_TPU_DIST_DIE", "")
    if not spec:
        return None
    parts = spec.split(":")
    if parts[-1].isdigit() and len(parts) > 1:
        return ":".join(parts[:-1]), int(parts[-1])
    return spec, 13


def _maybe_die(where: str) -> None:
    spec = _die_spec()
    if spec is not None and spec[0] == where:
        sys.stderr.write(f"injected death at {where} "
                         f"(rc={spec[1]})\n")
        sys.stderr.flush()
        os._exit(spec[1])


# ------------------------------------------------------------- helpers


def _int64_table(vecs, device):
    """An all-INT64 kudo-shuffleable Table from tensors or arrays, on
    `device`."""
    import torch

    from spark_rapids_tpu_torch.columns import dtypes
    from spark_rapids_tpu_torch.columns.column import Column
    from spark_rapids_tpu_torch.columns.table import Table
    cols = []
    for v in vecs:
        t = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(device=device, dtype=torch.int64)
        cols.append(Column(dtypes.INT64, t.shape[0], data=t))
    return Table(cols)


def _pad_to(vec, n: int):
    import torch
    if vec.shape[0] == n:
        return vec
    out = torch.zeros(n, dtype=vec.dtype, device=vec.device)
    out[: vec.shape[0]] = vec
    return out


def _reduce_scatter_allgather(transport, op_rs: int, op_ag: int,
                              vecs, overflow: bool, device):
    """Steps 3+4 for a dense partial group table: slice ``vecs`` (int64
    tensors of one length) into rank-owned chunks, shuffle chunks to
    owners, sum, allgather the owned sums back, return the global
    vectors + the OR of every rank's overflow flag.  The flag rides as
    one more int64 column so it crosses the same wire as the data."""
    import torch
    world = transport.world
    n = vecs[0].shape[0]
    chunk = -(-n // world)  # ceil: pad so every rank owns equal rows
    padded = [_pad_to(v.to(device=device, dtype=torch.int64),
                      chunk * world) for v in vecs]
    ofv = torch.full((chunk,), int(bool(overflow)), dtype=torch.int64,
                     device=device)
    parts = []
    for d in range(world):
        sl = slice(d * chunk, (d + 1) * chunk)
        parts.append(_int64_table([v[sl] for v in padded] + [ofv],
                                  device))
    merged = transport.exchange(op_rs, parts)
    # merged rows = world * chunk, source-rank order: sum per owner
    stacked = [c.data.reshape(world, chunk) for c in merged.columns]
    owned = [s.sum(0) for s in stacked[:-1]]
    of_owned = int(bool((stacked[-1] > 0).any()))
    gathered = transport.allgather(
        op_ag, _int64_table(
            owned + [torch.full((chunk,), of_owned, dtype=torch.int64,
                                device=device)], device))
    full = [c.data for c in gathered.columns]
    out = [v[:n] for v in full[:-1]]
    return out, bool((full[-1] > 0).any())


@contextlib.contextmanager
def _profiled(op: str, rank: int, world: int):
    """Per-rank query-profile session: when SPARK_RAPIDS_TPU_PROFILE
    is on, each rank assembles its own EXPLAIN ANALYZE artifact — this
    process's registry scopes the shuffle-link byte deltas, so a rank's
    profile carries exactly its own per-peer traffic.
    ``merge_profiles`` stitches the rank artifacts into ONE fleet
    profile via the launcher-seeded trace context.  One attribute read
    when profiling is off."""
    sess = _obs.PROFILER.begin(f"{op}-rank{rank}", query=f"dist_{op}",
                               rank=rank, world=world)
    try:
        yield sess
    finally:
        _obs.PROFILER.end(sess)


def _shard(a, rank: int, world: int):
    n = (a.shape[0] // world) * world
    per = n // world
    return a[rank * per: (rank + 1) * per]


def _fused() -> bool:
    """Stage fusion on for this rank?  (SPARK_RAPIDS_TPU_STAGE_FUSION=0
    takes the op-by-op map and reduce sides of models/tpcds.)"""
    from spark_rapids_tpu_torch.plan.compiler import fusion_mode
    return fusion_mode() != "off"


def _host(t):
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


# per-query timings of the last run in this process (partials and
# exchange seconds), for the worker summary
LAST_TIMES: Dict[str, dict] = {}


# ------------------------------------------------------------------ q5


def _q5_shard_args(d, shard: int, world: int):
    return tuple(
        _shard(a, shard, world)
        for a in (d.s_date, d.s_store, d.s_price, d.s_profit,
                  d.r_date, d.r_store, d.r_amt, d.r_loss)
    ) + (d.d_date,)


def _q5_partials(args, p, fused: bool, check=None):
    from spark_rapids_tpu_torch.models import tpcds as T
    if fused:
        from spark_rapids_tpu_torch.plan import catalog as C
        outs, _cap = C.run_q5_partials(
            args, p["stores"], p["join_capacity"], check=check)
        return outs
    if check is not None:
        check()
    outs, _cap = T.run_with_capacity_retry(
        lambda cap: T._q5_partials(p["stores"], cap), args,
        p["join_capacity"])
    if check is not None:
        check()
    return outs


def _q5_finish(sales, rets, profit, seen, of_any: bool, d, p,
               fused: bool, device):
    import torch

    from spark_rapids_tpu_torch.models import tpcds as T
    if fused:
        from spark_rapids_tpu_torch.plan import catalog as C
        key_s, sales_s, ret_s, profit_s, _of = C.run_q5_finish(
            sales, rets, profit, seen,
            torch.tensor(of_any, device=device), d.st_id, p["stores"])
    else:
        key_s, sales_s, ret_s, profit_s = T._q5_finish(p["stores"])(
            sales, rets, profit, seen, d.st_id)
    return {"key": _host(key_s), "sales": _host(sales_s),
            "rets": _host(ret_s), "profit": _host(profit_s),
            "overflow": np.asarray(of_any)}


def run_dist_q5(params: Optional[dict] = None, *, transport=None,
                device="cuda") -> Dict[str, np.ndarray]:
    """Distributed q5 on this rank's shard.  Returns the FULL query
    result (every rank converges to the same bytes) as host numpy
    arrays: key / sales / rets / profit / overflow."""
    from spark_rapids_tpu_torch.models import tpcds as T
    from spark_rapids_tpu_torch.parallel import exchange as X

    p = dict(Q5_PARAMS, **(params or {}))
    if transport is None:
        transport = X.table_transport()
    rank, world = transport.rank, transport.world
    with _obs.TRACER.span("dist_q5", kind="query",
                          attrs={"rank": rank, "world": world}), \
            _profiled("q5", rank, world):
        rows = max(int(p["rows"]) // (8 * world), 1) * 8 * world
        d = T.gen_q5(rows=rows, stores=p["stores"], days=p["days"],
                     device=device)
        # one read per query: a mid-query env flip must not leave the
        # finish step without the partials step's engine
        fused = _fused()
        t0 = time.perf_counter()
        sales, rets, profit, seen, of = _q5_partials(
            _q5_shard_args(d, rank, world), p, fused)
        of = bool(of)
        t1 = time.perf_counter()
        (sales, rets, profit, seen), of_any = _reduce_scatter_allgather(
            transport, OpIds.Q5_REDUCE_SCATTER, OpIds.Q5_ALLGATHER,
            [sales, rets, profit, seen], of, device)
        t2 = time.perf_counter()
        LAST_TIMES["q5"] = {"partials_ms": (t1 - t0) * 1e3,
                            "exchange_ms": (t2 - t1) * 1e3}
        return _q5_finish(sales, rets, profit, seen, of_any, d, p, fused,
                          device)


def single_q5(params: Optional[dict] = None,
              device="cuda") -> Dict[str, np.ndarray]:
    """The single-process reference with the SAME shapes the
    distributed run uses (row count rounded identically)."""
    from spark_rapids_tpu_torch.models import tpcds as T

    p = dict(Q5_PARAMS, **(params or {}))
    world = int(p.get("world", 1))
    rows = max(int(p["rows"]) // (8 * world), 1) * 8 * world
    d = T.gen_q5(rows=rows, stores=p["stores"], days=p["days"],
                 device=device)
    run = T.make_q5(p["stores"], p["join_capacity"])
    key_s, sales_s, ret_s, profit_s, of = run(d)
    return {"key": _host(key_s), "sales": _host(sales_s),
            "rets": _host(ret_s), "profit": _host(profit_s),
            "overflow": np.asarray(bool(of))}


# ---------------------------------------------------------- elastic q5


def run_elastic_q5(params: Optional[dict] = None, *, transport=None,
                   device="cuda") -> Dict[str, np.ndarray]:
    """q5 on the ELASTIC fleet protocol: every shard's partial group
    table is a logical PARTITION broadcast to all live ranks; the
    global sums are local (exact int64, shard order).  A dead rank's
    shards are recomputed by the fleet-assigned inheritor (inputs are
    seeded-deterministic); a straggler's shard is speculatively
    re-executed by the least-loaded survivor with the first verified
    copy winning the (op, shard) dedup; a respawned worker recomputes
    its own shards and catches up on the rest by CRC'd replay: every
    rank, however it got here, converges to bytes identical to
    ``single_q5``."""
    from spark_rapids_tpu_torch.models import tpcds as T
    from spark_rapids_tpu_torch.parallel import exchange as X
    from spark_rapids_tpu_torch.shuffle import kudo as _kudo
    from spark_rapids_tpu_torch.shuffle.schema import schema_of_table

    p = dict(Q5_PARAMS, **(params or {}))
    if transport is None:
        transport = X.table_transport()
    if getattr(transport, "fleet", None) is None:
        # degenerate path: no elastic fabric installed; the classic
        # reduce-scatter runner computes the same bytes
        return run_dist_q5(params, transport=transport, device=device)
    fleet = transport.fleet
    rank, world0 = transport.rank, fleet.world0
    with _obs.TRACER.span("elastic_q5", kind="query",
                          attrs={"rank": rank, "world": world0}), \
            _profiled("q5", rank, world0):
        rows = max(int(p["rows"]) // (8 * world0), 1) * 8 * world0
        d = T.gen_q5(rows=rows, stores=p["stores"], days=p["days"],
                     device=device)
        _maybe_die("q5:scan")
        fused = _fused()

        def compute_part(shard: int, ctx=None):
            """Deterministic per-shard partials -> one int64 kudo table.
            Runs for our own shards, for INHERITED shards after a
            rebalance, and (cancel-aware via ``ctx``) as a speculative
            re-execution of a straggler's shard."""
            t0 = time.monotonic_ns()
            outs = _q5_partials(_q5_shard_args(d, shard, world0), p, fused,
                                check=None if ctx is None
                                else ctx.check_cancel)
            sales, rets, profit, seen, of = outs
            fleet.note_stage_wall("q5.partials", time.monotonic_ns() - t0)
            n = sales.shape[0]
            return _int64_table([sales, rets, profit, seen,
                                 np.full(n, int(bool(of)), dtype=np.int64)],
                                device)

        t0 = time.perf_counter()
        view = fleet.view()
        for shard in view.shards_of(rank):
            t = compute_part(shard)
            _maybe_die("q5:partials")
            transport.broadcast_part(OpIds.EQ5_PARTS, shard, t)
        t1 = time.perf_counter()
        got = transport.gather_parts(
            OpIds.EQ5_PARTS, range(world0), compute=compute_part,
            deadline_s=transport.recv_timeout_s)
        fields = schema_of_table(_int64_table([[0]] * 5, "cpu"))
        vecs = None
        of_any = False
        for shard in range(world0):
            merged = _kudo.merge_to_table(got[shard], fields, device=device)
            cols = [c.data for c in merged.columns]
            of_any = of_any or bool((cols[-1] > 0).any())
            vecs = cols[:-1] if vecs is None else [
                a + b for a, b in zip(vecs, cols[:-1])]
        t2 = time.perf_counter()
        LAST_TIMES["q5"] = {"partials_ms": (t1 - t0) * 1e3,
                            "exchange_ms": (t2 - t1) * 1e3}
        sales, rets, profit, seen = vecs
        return _q5_finish(sales, rets, profit, seen, of_any, d, p, fused,
                          device)


# ----------------------------------------------------------------- q72


def run_dist_q72(params: Optional[dict] = None, *, transport=None,
                 device="cuda") -> Dict[str, np.ndarray]:
    """Distributed q72: catalog_sales sharded row-parallel, inventory
    + item dim replicated, counts reduce-scattered/allgathered over the
    kudo shuffle."""
    import torch

    from spark_rapids_tpu_torch.models import tpcds as T
    from spark_rapids_tpu_torch.parallel import exchange as X

    p = dict(Q72_PARAMS, **(params or {}))
    if transport is None:
        transport = X.table_transport()
    rank, world = transport.rank, transport.world
    with _obs.TRACER.span("dist_q72", kind="query",
                          attrs={"rank": rank, "world": world}), \
            _profiled("q72", rank, world):
        cs_rows = max(int(p["cs_rows"]) // world, 1) * world
        d = T.gen_q72(cs_rows=cs_rows, inv_rows=p["inv_rows"],
                      items=p["items"], days=p["days"], device=device)
        shard_args = (
            _shard(d.cs_item, rank, world),
            _shard(d.cs_date, rank, world),
            _shard(d.cs_qty, rank, world),
            d.inv_item, d.inv_date, d.inv_qty, d.item_id)

        fused = _fused()
        t0 = time.perf_counter()
        if fused:
            from spark_rapids_tpu_torch.plan import catalog as C
            outs, _cap = C.run_q72_partials(
                shard_args, p["items"], p["max_week"],
                p["join_capacity"], p["week0"])
        else:
            outs, _cap = T.run_with_capacity_retry(
                lambda cap: T._q72_partials(p["items"], p["max_week"], cap,
                                            p["week0"]),
                shard_args, p["join_capacity"])
        counts, of = outs
        of = bool(of)
        t1 = time.perf_counter()
        (counts,), of_any = _reduce_scatter_allgather(
            transport, OpIds.Q72_REDUCE_SCATTER,
            OpIds.Q72_ALLGATHER, [counts], of, device)
        t2 = time.perf_counter()
        LAST_TIMES["q72"] = {"partials_ms": (t1 - t0) * 1e3,
                             "exchange_ms": (t2 - t1) * 1e3}
        if fused:
            item, week, cnt, _of = C.run_q72_finish(
                counts, torch.tensor(of_any, device=device), p["items"],
                p["max_week"], p["limit"], p["week0"])
        else:
            item, week, cnt = T._q72_finish(
                p["items"], p["max_week"], p["limit"], p["week0"])(counts)
        return {"item": _host(item), "week": _host(week),
                "cnt": _host(cnt), "overflow": np.asarray(of_any)}


def single_q72(params: Optional[dict] = None,
               device="cuda") -> Dict[str, np.ndarray]:
    from spark_rapids_tpu_torch.models import tpcds as T

    p = dict(Q72_PARAMS, **(params or {}))
    world = int(p.get("world", 1))
    cs_rows = max(int(p["cs_rows"]) // world, 1) * world
    d = T.gen_q72(cs_rows=cs_rows, inv_rows=p["inv_rows"],
                  items=p["items"], days=p["days"], device=device)
    run = T.make_q72(p["items"], p["max_week"], p["join_capacity"],
                     limit=p["limit"], week0=p["week0"])
    item, week, cnt, of = run(d)
    return {"item": _host(item), "week": _host(week),
            "cnt": _host(cnt), "overflow": np.asarray(bool(of))}


DIST_QUERIES = {"q5": run_dist_q5, "q72": run_dist_q72}
ELASTIC_QUERIES = {"q5": run_elastic_q5, "q72": run_dist_q72}
SINGLE_QUERIES = {"q5": single_q5, "q72": single_q72}


# ---------------------------------------------------------- worker main


def _compile_seconds() -> float:
    """Seconds this process spent in fused stages' first calls
    (tracing and compiling included)."""
    from spark_rapids_tpu_torch.plan import compiler
    return sum(sum(cs.compile_seconds.values())
               for cs in compiler._STAGE_MEMO.values())


def _parse_trace_ctx():
    spec = os.environ.get("SPARK_RAPIDS_TPU_DIST_TRACE_CTX", "")
    if ":" not in spec:
        return None
    try:
        tid, sid = spec.split(":")
        return _obs.SpanContext(int(tid, 16), int(sid, 16))
    except ValueError:
        return None


def main(argv=None) -> int:
    t_start = time.time()
    ap = argparse.ArgumentParser(
        description="spark_rapids_tpu_torch distributed shuffle worker")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--addresses", required=True,
                    help="comma-separated per-rank listen addresses "
                         "(unix:/path or host:port)")
    ap.add_argument("--ops", default="q5,q72")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--params", default="{}",
                    help="JSON dict of per-query param overrides "
                         "keyed by op name")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic fleet protocol: membership epoch, "
                         "rebalance on peer death, speculation, "
                         "skew re-split")
    ap.add_argument("--device", default="cuda",
                    help="device of the worker's data and stages")
    ap.add_argument("--coordinator", default=None,
                    help="init_method of the process group (the mesh "
                         "attempt under SPARK_RAPIDS_TPU_DIST_MESH)")
    args = ap.parse_args(argv)
    _maybe_die("boot")

    import torch

    from spark_rapids_tpu_torch.distributed import transport as TR
    from spark_rapids_tpu_torch.distributed.mesh import (leave_group,
                                                         try_form_mesh)
    from spark_rapids_tpu_torch.distributed.service import ShuffleService
    from spark_rapids_tpu_torch.observability.dumpio import dump_via
    from spark_rapids_tpu_torch.robustness import links
    from spark_rapids_tpu_torch.shuffle import kudo

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)   # the context, before the clock
    t_ready = time.time()

    rank, world = args.rank, args.world
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)
    overrides = json.loads(args.params)

    kudo.set_crc_enabled(True)
    _obs.enable()
    _obs.enable_tracing()

    mesh_info = try_form_mesh(rank, world, coordinator=args.coordinator,
                              device=device)
    service = ShuffleService(
        rank, world, args.addresses.split(","),
        elastic=args.elastic).start().install()
    respawned = os.environ.get(
        "SPARK_RAPIDS_TPU_DIST_RESPAWN", "") == "1"
    root = _obs.TRACER.start_span(
        "dist_worker", kind="process", parent=_parse_trace_ctx(),
        attrs={"rank": rank, "world": world,
               "mesh": mesh_info["mode"],
               "respawned": respawned})
    # control/replay daemon threads parent under this worker's
    # process span so the fleet trace stays ONE connected tree
    service.trace_ctx = _obs.SpanContext(root.trace_id, root.span_id)
    if args.elastic and respawned:
        # a respawned incarnation: announce ourselves so survivors
        # waiting at the elastic barrier learn we are back, and learn
        # their epoch/departed view before sending fenceable frames
        service.join_fleet()
    else:
        # every peer listening before the first send: a peer still
        # importing torch is slow, not dead (under load its boot can
        # outlast a link's retry budget, which the elastic fleet would
        # read as a death)
        service.await_peers()
    queries = ELASTIC_QUERIES if args.elastic else DIST_QUERIES
    ops = [o for o in args.ops.split(",") if o]
    rc = 0
    op_s = {}
    try:
        for op in ops:
            t0 = time.perf_counter()
            result = queries[op](overrides.get(op),
                                 transport=service, device=device)
            op_s[op] = time.perf_counter() - t0
            np.savez(os.path.join(
                outdir, f"result_{op}_rank{rank}.npz"), **result)
            if _obs.PROFILER.enabled:
                prof = _obs.PROFILER.last()
                if prof is not None:
                    dump_via(
                        os.path.join(
                            outdir,
                            f"profile_{op}_rank{rank}.json"),
                        lambda f, p=prof: f.write(
                            json.dumps(p, sort_keys=True,
                                       default=str)))
                    # same-moment registry snapshot: the profile's
                    # link-byte deltas reconcile exactly against
                    # THIS dump (the final metrics_rank dump also
                    # counts post-query barrier traffic)
                    dump_via(
                        os.path.join(
                            outdir,
                            f"metrics_{op}_rank{rank}.json"),
                        lambda f: f.write(
                            _obs.METRICS.snapshot_json()))
        if _obs.TIMESERIES.enabled:
            # close the final window NOW and dump the same-moment pair
            # (ring + the registry fold the window was cut from): the
            # ring's summed counter deltas equal that fold exactly.  A
            # second registry read would also count a peer's frame
            # landing between the two (its publish, a gossip beat), and
            # the post-barrier metrics_rank dump counts barrier traffic
            _, reg_snap = _obs.TIMESERIES.tick_with_registry()
            ts_snap = _obs.timeseries_snapshot(
                rank=rank, epoch=(service.fleet.epoch
                                  if service.fleet is not None else 0))
            dump_via(os.path.join(outdir,
                                  f"timeseries_rank{rank}.json"),
                     lambda f: f.write(json.dumps(ts_snap,
                                                  sort_keys=True)))
            dump_via(os.path.join(outdir,
                                  f"metrics_ts_rank{rank}.json"),
                     lambda f: f.write(json.dumps(reg_snap,
                                                  sort_keys=True)))
            # publish to rank 0 while the links are still up: the send
            # blocks for the ACK, so after the barrier below rank 0
            # holds every rank's windows
            service.publish_timeseries(ts_snap)
        if args.elastic:
            # membership-tolerant: survives peers leaving AND waits
            # for a respawned peer when the launcher may send one
            service.elastic_barrier(OpIds.ELASTIC_BARRIER)
            # graceful leave: peers still gathering (a respawned
            # straggler) drop us from their barrier wants instead of
            # waiting out a death detection on our closed listener
            service.leave_fleet()
        else:
            service.barrier(OpIds.BARRIER)
    except Exception as e:  # noqa: BLE001 — report, then nonzero exit
        rc = 1
        with open(os.path.join(outdir, f"error_rank{rank}.txt"),
                  "w") as f:
            f.write(f"{type(e).__name__}: {e}\n")
        raise
    finally:
        root.end()
        _obs.TRACER.dump_jsonl(
            os.path.join(outdir, f"spans_rank{rank}.jsonl"))
        dump_via(os.path.join(outdir, f"metrics_rank{rank}.json"),
                 lambda f: f.write(_obs.METRICS.snapshot_json()))
        # the journal carries the fleet evidence spine
        # (fleet_membership / fleet_speculation / fleet_inherit /
        # shuffle_dup_dropped)
        _obs.dump_journal_jsonl(
            os.path.join(outdir, f"journal_rank{rank}.jsonl"))
        if rank == 0 and _obs.TIMESERIES.enabled:
            # rank 0's merged fleet timeseries (self + every publish
            # folded pre-barrier)
            dump_via(os.path.join(outdir, "fleet_timeseries.json"),
                     lambda f: f.write(json.dumps(
                         service.fleet_timeseries.merged(),
                         sort_keys=True)))
        fleet = service.fleet
        summary = {
            "rank": rank, "world": world, "ops": ops,
            "device": str(device), "mesh": mesh_info,
            "elastic": bool(args.elastic), "respawned": respawned,
            "epoch": fleet.epoch if fleet is not None else 0,
            "t_start": t_start, "t_ready": t_ready,
            "import_s": t_ready - t_start,
            "compile_s": _compile_seconds(), "op_s": op_s,
            "times": dict(LAST_TIMES), "link": dict(TR.STATS),
            "link_retries": dict(links.LINK_STATS),
            "fleet_events": list(fleet.events) if fleet else [],
            "service_events": list(service.events),
            "peak_mib": (torch.cuda.max_memory_allocated(device) / 2**20
                         if device.type == "cuda" else None),
            "rc": rc,
        }
        with open(os.path.join(outdir, f"summary_rank{rank}.json"),
                  "w") as f:
            f.write(json.dumps(summary, indent=1, default=str))
        service.uninstall()
        service.stop()
        leave_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
