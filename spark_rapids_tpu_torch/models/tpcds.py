"""TPC-DS-shaped pipelines written by hand, their seeded generators
and their numpy oracles.

Each hand pipeline is eager PyTorch over tensors on one device — scan
-> join(s) -> filter -> group-by -> order-by — with the shapes the real
queries have:

  * q9-shape : CASE-WHEN bucketed aggregates over store_sales (5
               quantity ranges; count/avg per range).
  * q5-shape : sales & returns facts joined to a date-filtered
               date_dim and to a store dim, grouped by store with
               decimal sums, ordered by store — join -> join ->
               group-by -> order-by.
  * q72-shape: catalog_sales joined to inventory on item (fact-fact),
               week-offset filter through date lookups, inventory
               shortage filter, item dim join, group by (item, week),
               count, order by count desc with a LIMIT — the long
               multi-join chain.
  * q3-shape : store_sales through dense date and item dims, month and
               manufacturer filters, GROUP BY (year, brand), ORDER BY
               year, sum DESC, brand LIMIT.
  * q7-shape : sales through three filtering dims, four AVGs per item.

q67 and q89 have generators and oracles only: their pipelines are stage
plans (plan/catalog.py).

Joins are the fixed-capacity device probe
(ops/device_join.inner_join_device), group-bys are integer segment
sums over dictionary-encoded keys, order-bys stable sorts over the
padded group table with sentinel keys for empty groups; decimal sums
are exact int64 scaled arithmetic, promoted to f64 only for averages.
These hand pipelines are the port's oracles for the stage-IR versions
in plan/catalog.py, and the numpy `oracle_*` functions define
correctness for both.  The JAX package's oracles loop in Python per
row; these are vectorised (numpy, exact int64 sums) and give the same
tuples, and each one's arrays come from a helper that callers at full
size compare with the stage outputs directly.

The generators make the JAX package's draws (`models/tpcds.py` there)
from the same `np.random.default_rng(seed)` in the same order, so both
packages see the same data, and hand it over on ``device``.  Each
pipeline runs under the task-level retry driver inside a query-root
span (``_retried_query``; over a process group ``_mesh_query``, whose
retry every rank takes together).  The q3, q5, q9 and q72 generators note each
regeneration to the result cache's ingest-epoch registry (the device
is not part of the note: the data is the same on every device).
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.ops.device_join import inner_join_device
from spark_rapids_tpu_torch.parallel.exchange import with_capacity_retry
from spark_rapids_tpu_torch.plan.compiler import sort_lex
from spark_rapids_tpu_torch.robustness import retry as _retry


def _note_gen(source: str, **args) -> None:
    """Catalog data generators feed the result-cache ingest-epoch
    registry: a regeneration with CHANGED arguments is new data over
    that source (the epoch bumps and stale cached results miss); an
    identical regeneration is not an ingest."""
    from spark_rapids_tpu_torch.perf.result_cache import note_ingest
    note_ingest(source, ",".join(
        f"{k}={v}" for k, v in sorted(args.items())))


def _retried_query(name: str, fn):
    """Run a pipeline under the task-level retry driver: a GpuRetryOOM /
    GpuSplitAndRetryOOM / CudfException raised mid-query (real or
    injected — the driver polls the forced-OOM hooks at every attempt)
    recomputes the pipeline instead of killing it.  The pipelines are
    pure functions of their argument tensors, so the recompute needs no
    checkpoint and a "split" degrades soundly to a full re-run.  A
    query-root span wraps the driver: shuffle spans and OOM episodes
    recorded while the query executes parent under it."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        # close over the call instead of forwarding kwargs: a pipeline
        # kwarg named like a driver control parameter (policy, ...)
        # must reach fn, not the driver
        with _obs.TRACER.span(name, kind="query"):
            return _retry.with_retry(lambda: fn(*args, **kwargs),
                                     name=name)

    return run


def _mesh_query(name: str, mesh, fn):
    """_retried_query for a step over a process group: the same span,
    and the retry driver made collective (robustness/retry.
    with_collective_retry over ``mesh.agree``), so every rank retries
    or returns together; a failure inside the step fails the rank's
    call instead of re-running its collectives alone."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _obs.TRACER.span(name, kind="query"):
            return _retry.with_collective_retry(
                lambda: fn(*args, **kwargs), mesh.agree, name=name)

    return run


def _segment_sum(value: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Integer sum per id; every id is in range here."""
    out = torch.zeros(num_segments, dtype=value.dtype, device=value.device)
    return out.index_add(0, ids, value)


def _host(d):
    """Host numpy copies of a data tuple's tensors."""
    return type(d)(*(x.cpu().numpy() for x in d))


def _exact_sums(ids: np.ndarray, n: int, values: np.ndarray) -> np.ndarray:
    """int64 sum of ``values`` per id in [0, n): exact, wrapping as
    the pipelines' int64 adds do."""
    out = np.zeros(n, np.int64)
    np.add.at(out, ids, values.astype(np.int64))
    return out


# ------------------------------------------------------------------ q5


class Q5Data(NamedTuple):
    # store_sales-like fact
    s_date: torch.Tensor     # i32 days since epoch
    s_store: torch.Tensor    # i32 store key
    s_price: torch.Tensor    # i64 decimal64(2) cents
    s_profit: torch.Tensor   # i64 decimal64(2) cents
    # store_returns-like fact
    r_date: torch.Tensor
    r_store: torch.Tensor
    r_amt: torch.Tensor
    r_loss: torch.Tensor
    # date_dim filtered to the 14-day window, store dim (dense keys:
    # store key k's attributes live at index k)
    d_date: torch.Tensor     # i32 days (pre-filtered window)
    st_id: torch.Tensor      # i32 dictionary id of s_store_id


def gen_q5(rows: int = 50_000, stores: int = 32, days: int = 120,
           seed: int = 5, device="cuda") -> Q5Data:
    _note_gen("tpcds:gen_q5", rows=rows, stores=stores, days=days,
              seed=seed)
    rng = np.random.default_rng(seed)
    base = 11_000  # ~2000-02-14 in days-since-epoch
    win0 = base + 40

    def fact(n):
        return (
            rng.integers(base, base + days, n).astype(np.int32),
            rng.integers(0, stores, n).astype(np.int32),
            rng.integers(100, 100_000, n).astype(np.int64),
            rng.integers(-20_000, 50_000, n).astype(np.int64),
        )

    s = fact(rows)
    r = fact(rows // 8)
    d_date = np.arange(win0, win0 + 14, dtype=np.int32)
    perm = rng.permutation(stores).astype(np.int32)
    return Q5Data(*(torch.from_numpy(a).to(device)
                    for a in (*s, *r, d_date, perm)))


def _q5_partials(stores: int, join_capacity: int):
    """The map side of q5: partial group table (per-store sales /
    returns / profit / seen) + overflow flag.  The partials are exact
    int64 sums, so any reduction order gives the same totals."""

    def compute(s_date, s_store, s_price, s_profit,
                r_date, r_store, r_amt, r_loss, d_date):
        def channel(date, store, amt_a, amt_b):
            """fact JOIN date_window -> per-store (sum a, sum b)."""
            pairs = inner_join_device(date, d_date, join_capacity)
            li = pairs.left_indices
            ok = pairs.valid
            st = torch.where(ok, store[li], 0)
            sum_a = _segment_sum(torch.where(ok, amt_a[li], 0), st,
                                 stores)
            sum_b = _segment_sum(torch.where(ok, amt_b[li], 0), st,
                                 stores)
            seen = _segment_sum(ok.to(torch.int64), st, stores)
            return sum_a, sum_b, seen, pairs.total > join_capacity

        s_sales, s_profit_s, s_seen, of1 = channel(
            s_date, s_store, s_price, s_profit)
        r_amt_s, r_loss_s, r_seen, of2 = channel(
            r_date, r_store, r_amt, r_loss)
        return (s_sales, r_amt_s, s_profit_s - r_loss_s,
                s_seen + r_seen, of1 | of2)

    return compute


def _q5_finish(stores: int):
    """The reduce side of q5: ORDER BY s_store_id over the global group
    table (post-reduction)."""

    def fin(sales, rets, profit, seen, st_id):
        # ORDER BY s_store_id: a stable sort of the group table by
        # dictionary id, empty stores last under a sentinel id
        key = torch.where(seen > 0, st_id, 2**31 - 1)
        order = torch.sort(key, stable=True).indices
        return key[order], sales[order], rets[order], profit[order]

    return fin


def _q5_kernel(stores: int, join_capacity: int, reduce_sum,
               reduce_any):
    """The whole q5 body: _q5_partials (map side) and _q5_finish
    (order-by) with the caller's reduction in between."""
    partials = _q5_partials(stores, join_capacity)
    fin = _q5_finish(stores)

    def compute(s_date, s_store, s_price, s_profit,
                r_date, r_store, r_amt, r_loss, d_date, st_id):
        s_sales, r_amt_s, profit, seen, of = partials(
            s_date, s_store, s_price, s_profit,
            r_date, r_store, r_amt, r_loss, d_date)
        s_sales = reduce_sum(s_sales)
        r_amt_s = reduce_sum(r_amt_s)
        profit = reduce_sum(profit)
        seen = reduce_sum(seen)
        key_s, sales_s, ret_s, profit_s = fin(
            s_sales, r_amt_s, profit, seen, st_id)
        return key_s, sales_s, ret_s, profit_s, reduce_any(of)

    return compute


def make_q5(stores: int, join_capacity: int):
    """q5-shape pipeline.  Returns fn(Q5Data) -> (store_ids i32, sales
    i64, returns i64, profit i64, overflow bool) with one output row per
    store id, ordered by store id (empty stores hold sentinel id
    2^31-1)."""
    kernel = _q5_kernel(stores, join_capacity,
                        lambda x: x, lambda b: b)

    def run(d: Q5Data):
        return kernel(*d)

    return _retried_query("tpcds_q5", run)


def oracle_q5(d: Q5Data, stores: int):
    h = Q5Data(*(x.cpu().numpy() for x in d))
    dd = set(h.d_date.tolist())
    out = {}
    for i in range(len(h.s_date)):
        if int(h.s_date[i]) in dd:
            e = out.setdefault(int(h.s_store[i]), [0, 0, 0])
            e[0] += int(h.s_price[i])
            e[2] += int(h.s_profit[i])
    for i in range(len(h.r_date)):
        if int(h.r_date[i]) in dd:
            e = out.setdefault(int(h.r_store[i]), [0, 0, 0])
            e[1] += int(h.r_amt[i])
            e[2] -= int(h.r_loss[i])
    rows = sorted((int(h.st_id[st]), a, b, c)
                  for st, (a, b, c) in out.items())
    return rows


# ------------------------------------------------------------------ q9


def gen_q9(rows: int = 100_000, seed: int = 9, device="cuda"):
    """(quantity i32 1-100, price i64 cents, profit i64 cents)."""
    _note_gen("tpcds:gen_q9", rows=rows, seed=seed)
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a).to(device) for a in (
        rng.integers(1, 101, rows).astype(np.int32),
        rng.integers(100, 30_000, rows).astype(np.int64),
        rng.integers(-5_000, 20_000, rows).astype(np.int64)))


_Q9_BUCKETS = ((1, 20), (21, 40), (41, 60), (61, 80), (81, 100))


def _run_q9(quantity: torch.Tensor, price: torch.Tensor,
            profit: torch.Tensor):
    """q9-shape: per-bucket count / avg(price) / avg(profit); sums exact
    in int64, averages in f64 at the presentation edge."""
    counts, avg_p, avg_n = [], [], []
    for lo, hi in _Q9_BUCKETS:
        m = (quantity >= lo) & (quantity <= hi)
        c = m.to(torch.int64).sum()
        sp = torch.where(m, price, 0).sum()
        sn = torch.where(m, profit, 0).sum()
        denom = c.clamp(min=1).to(torch.float64)
        counts.append(c)
        avg_p.append(sp.to(torch.float64) / denom)
        avg_n.append(sn.to(torch.float64) / denom)
    return torch.stack(counts), torch.stack(avg_p), torch.stack(avg_n)


run_q9 = _retried_query("tpcds_q9", _run_q9)


def make_q9_multichip(mesh):
    """q9-shape over a process group (distributed/mesh.Mesh): rows
    sharded, the five buckets' counts and sums all-reduced (one psum of
    the stacked int64 partials: exact, so the same totals as the JAX
    package's fifteen), the avg divide on the global sums (a mean of
    shard means would be wrong).  Each rank passes its shard of the
    three columns; every rank gets the replicated outputs."""

    def shard_fn(quantity, price, profit):
        parts = []
        for lo, hi in _Q9_BUCKETS:
            m = (quantity >= lo) & (quantity <= hi)
            parts.append(torch.stack([m.to(torch.int64).sum(),
                                      torch.where(m, price, 0).sum(),
                                      torch.where(m, profit, 0).sum()]))
        c, sp, sn = mesh.psum(torch.stack(parts, 1))
        denom = c.clamp(min=1).to(torch.float64)
        return (c, sp.to(torch.float64) / denom,
                sn.to(torch.float64) / denom)

    return _mesh_query("tpcds_q9_multichip", mesh, shard_fn)


def oracle_q9(quantity, price, profit):
    """[(count, avg price, avg profit)] per bucket."""
    q, p, n = (x.cpu().numpy() for x in (quantity, price, profit))
    out = []
    for lo, hi in _Q9_BUCKETS:
        m = (q >= lo) & (q <= hi)
        c = int(m.sum())
        out.append((c, p[m].sum() / max(c, 1), n[m].sum() / max(c, 1)))
    return out


# ------------------------------------------------------------------ q72


class Q72Data(NamedTuple):
    cs_item: torch.Tensor      # i32 item key
    cs_date: torch.Tensor      # i32 order date (days)
    cs_qty: torch.Tensor       # i32
    inv_item: torch.Tensor     # i32
    inv_date: torch.Tensor     # i32 inventory date (days)
    inv_qty: torch.Tensor      # i32
    item_id: torch.Tensor      # i32 dictionary id per item key (dense)


def gen_q72(cs_rows: int = 30_000, inv_rows: int = 30_000,
            items: int = 512, days: int = 70, seed: int = 72,
            device="cuda") -> Q72Data:
    _note_gen("tpcds:gen_q72", cs_rows=cs_rows, inv_rows=inv_rows,
              items=items, days=days, seed=seed)
    rng = np.random.default_rng(seed)
    base = 11_000
    cols = (
        rng.integers(0, items, cs_rows).astype(np.int32),
        rng.integers(base, base + days, cs_rows).astype(np.int32),
        rng.integers(1, 100, cs_rows).astype(np.int32),
        rng.integers(0, items, inv_rows).astype(np.int32),
        rng.integers(base, base + days, inv_rows).astype(np.int32),
        rng.integers(1, 60, inv_rows).astype(np.int32),
        rng.permutation(items).astype(np.int32),
    )
    return Q72Data(*(torch.from_numpy(a).to(device) for a in cols))


def _q72_partials(items: int, max_week: int, join_capacity: int,
                  week0: int):
    """Map side of q72: partial (item, week) count vector + overflow
    flag (exact int64 partials, see _q5_partials)."""
    n_groups = items * max_week

    def compute(cs_item, cs_date, cs_qty, inv_item, inv_date,
                inv_qty, item_id):
        pairs = inner_join_device(cs_item, inv_item, join_capacity)
        li, ri, ok = (pairs.left_indices, pairs.right_indices,
                      pairs.valid)
        order_week = cs_date[li] // 7
        inv_week = inv_date[ri] // 7
        week = order_week - week0
        keep = (ok & (inv_week == order_week + 1)
                & (inv_qty[ri] < cs_qty[li])
                & (week >= 0) & (week < max_week))
        iid = item_id[cs_item[li]]
        gid = torch.where(keep, iid * max_week + week, 0)
        # masked rows land on gid 0 but add 0 (the summand is `keep`)
        counts = _segment_sum(keep.to(torch.int64), gid, n_groups)
        return counts, pairs.total > join_capacity

    return compute


def _q72_finish(items: int, max_week: int, limit: int, week0: int):
    """Reduce side of q72: top-k over the global count vector."""
    n_groups = items * max_week

    def fin(counts):
        # ORDER BY count DESC, item ASC LIMIT k over the group table:
        # a stable sort of the count key keeps ties in group order
        gidx = torch.arange(n_groups, dtype=torch.int64,
                            device=counts.device)
        sort_key = torch.where(counts > 0, -counts, 2**62)
        order = torch.sort(sort_key, stable=True).indices
        gid_s, cnt_s = gidx[order], counts[order]
        return (gid_s[:limit] // max_week,
                gid_s[:limit] % max_week + week0, cnt_s[:limit])

    return fin


def _q72_kernel(items: int, max_week: int, join_capacity: int,
                limit: int, week0: int, reduce_sum, reduce_any):
    """The whole q72 body (see _q5_kernel)."""
    partials = _q72_partials(items, max_week, join_capacity, week0)
    fin = _q72_finish(items, max_week, limit, week0)

    def compute(cs_item, cs_date, cs_qty, inv_item, inv_date,
                inv_qty, item_id):
        counts, of = partials(cs_item, cs_date, cs_qty, inv_item,
                              inv_date, inv_qty, item_id)
        counts = reduce_sum(counts)
        item, week, cnt = fin(counts)
        return item, week, cnt, reduce_any(of)

    return compute


def make_q72(items: int, max_week: int, join_capacity: int,
             limit: int = 100, week0: int = 0):
    """q72-shape pipeline: cs JOIN inv ON item (fact-fact) with
    inv_week == order_week + 1 and inv_qty < cs_qty filters, item-dim
    join for the dictionary id, GROUP BY (item, week) COUNT, ORDER BY
    count DESC, item_id ASC LIMIT `limit`.  The group space is items x
    max_week with weeks rebased to week0 (the date_dim window's first
    week)."""
    kernel = _q72_kernel(items, max_week, join_capacity, limit,
                         week0, lambda x: x, lambda b: b)

    def run(d: Q72Data):
        return kernel(*d)

    return _retried_query("tpcds_q72", run)


def oracle_q72(d: Q72Data, items: int, max_week: int,
               limit: int = 100, week0: int = 0):
    from collections import Counter, defaultdict
    h = Q72Data(*(x.cpu().numpy() for x in d))
    inv_by_item = defaultdict(list)
    for j in range(len(h.inv_item)):
        inv_by_item[int(h.inv_item[j])].append(j)
    counts: Counter = Counter()
    for i in range(len(h.cs_item)):
        ow = int(h.cs_date[i]) // 7
        for j in inv_by_item.get(int(h.cs_item[i]), ()):
            if (int(h.inv_date[j]) // 7 == ow + 1
                    and int(h.inv_qty[j]) < int(h.cs_qty[i])
                    and 0 <= ow - week0 < max_week):
                counts[(int(h.item_id[h.cs_item[i]]), ow - week0)] += 1
    rows = sorted(((-c, iid * max_week + wk)
                   for (iid, wk), c in counts.items()))
    return [(g // max_week, g % max_week + week0, -negc)
            for negc, g in rows[:limit]]


# ------------------------------------------------------------------ q3


class Q3Data(NamedTuple):
    s_date: torch.Tensor      # i32 days (fact)
    s_item: torch.Tensor      # i32 item key
    s_price: torch.Tensor     # i64 decimal64(2) cents
    d_moy: torch.Tensor       # i32 month-of-year per day index (dense
    #                           date dim: day d's row lives at d - base)
    d_year: torch.Tensor      # i32 year per day index
    i_brand: torch.Tensor     # i32 brand id per item key (dense item dim)
    i_manufact: torch.Tensor  # i32 manufacturer id per item key


def gen_q3(rows: int = 50_000, items: int = 256, days: int = 730,
           brands: int = 32, seed: int = 3, device="cuda") -> Q3Data:
    _note_gen("tpcds:gen_q3", rows=rows, items=items, days=days,
              brands=brands, seed=seed)
    rng = np.random.default_rng(seed)
    base = 10_957  # 2000-01-01
    day_idx = np.arange(days)
    cols = (
        rng.integers(base, base + days, rows).astype(np.int32),
        rng.integers(0, items, rows).astype(np.int32),
        rng.integers(100, 50_000, rows).astype(np.int64),
        ((day_idx // 30) % 12 + 1).astype(np.int32),
        (2000 + day_idx // 365).astype(np.int32),
        rng.integers(0, brands, items).astype(np.int32),
        rng.integers(0, 8, items).astype(np.int32),
    )
    return Q3Data(*(torch.from_numpy(a).to(device) for a in cols))


def _q3_kernel(base, years, brands, manufact, month, limit, reduce_sum):
    """The q3 body (see _q5_kernel)."""
    n_groups = years * brands

    def compute(s_date, s_item, s_price, d_moy, d_year, i_brand,
                i_manufact):
        di = s_date - base
        year_idx = d_year[di] - d_year[0]
        keep = ((d_moy[di] == month)
                & (i_manufact[s_item] == manufact)
                & (year_idx >= 0) & (year_idx < years))
        brand = i_brand[s_item]
        gid = torch.where(keep, year_idx * brands + brand, 0)
        amt = torch.where(keep, s_price, 0)
        sums = reduce_sum(_segment_sum(amt, gid, n_groups))
        cnts = reduce_sum(_segment_sum(keep.to(torch.int64), gid,
                                       n_groups))
        gidx = torch.arange(n_groups, dtype=torch.int64,
                            device=sums.device)
        sentinel = 2**62
        k1 = torch.where(cnts > 0, gidx // brands, sentinel)
        # ORDER BY year, sum DESC, brand
        _a, _b, _c, g_s, sum_s, cnt_s = sort_lex(
            (k1, torch.where(cnts > 0, -sums, sentinel), gidx % brands,
             gidx, sums, cnts), num_keys=3)
        live = cnt_s[:limit] > 0
        # dead slots sentinel their year (a zero-sum group is otherwise
        # indistinguishable from padding)
        return (torch.where(live, g_s[:limit] // brands + d_year[0],
                            2**31 - 1),
                g_s[:limit] % brands, sum_s[:limit], cnts.sum())

    return compute


def make_q3(base: int, years: int, brands: int, manufact: int,
            month: int = 11, limit: int = 100):
    """q3-shape pipeline: store_sales JOIN date_dim (dense lookup, d_moy
    filter) JOIN item (dense lookup, manufacturer filter) GROUP BY
    (d_year, brand) SUM(price) ORDER BY year ASC, sum DESC, brand ASC
    LIMIT `limit`.  Rows outside the `years`-wide window starting at
    d_year[0] are filtered; dead output slots carry the 2^31-1 year
    sentinel.  Returns fn(Q3Data) -> (year i64, brand i64, sum i64,
    kept-row total i64)."""
    kernel = _q3_kernel(base, years, brands, manufact, month, limit,
                        lambda x: x)

    def run(d: Q3Data):
        return kernel(*d)

    return _retried_query("tpcds_q3", run)


def q3_arrays(d: Q3Data, base: int, manufact: int, month: int = 11):
    """Every (year, brand) group of q3 over all the data's years, in
    ORDER BY year, sum DESC, brand order: (years, brands, sums) int64
    arrays and the kept-row count."""
    h = _host(d)
    di = h.s_date.astype(np.int64) - base
    keep = (h.d_moy[di] == month) & (h.i_manufact[h.s_item] == manufact)
    year = h.d_year[di[keep]].astype(np.int64)
    brand = h.i_brand[h.s_item[keep]].astype(np.int64)
    if not len(year):
        empty = np.zeros(0, np.int64)
        return empty, empty, empty, 0
    y0, width = int(year.min()), int(brand.max()) + 1
    uniq, inv = np.unique((year - y0) * width + brand,
                          return_inverse=True)
    sums = _exact_sums(inv, len(uniq), h.s_price[keep])
    years, brands = uniq // width + y0, uniq % width
    order = np.lexsort((brands, -sums, years))
    return years[order], brands[order], sums[order], int(keep.sum())


def oracle_q3(d: Q3Data, base: int, brands: int, manufact: int,
              month: int = 11, limit: int = 100):
    """[(year, brand, sum)] for the first `limit` groups."""
    years, brands_, sums, _n = q3_arrays(d, base, manufact, month)
    return [(int(y), int(b), int(s))
            for y, b, s in zip(years[:limit], brands_[:limit],
                               sums[:limit])]


# ------------------------------------------------------------------ q7


class Q7Data(NamedTuple):
    s_item: torch.Tensor     # i32
    s_cdemo: torch.Tensor    # i32 customer-demographics key
    s_promo: torch.Tensor    # i32 promotion key
    s_qty: torch.Tensor      # i64
    s_list: torch.Tensor     # i64 decimal64(2)
    s_coupon: torch.Tensor   # i64 decimal64(2)
    s_sales: torch.Tensor    # i64 decimal64(2)
    cd_match: torch.Tensor   # bool per cdemo key (gender/marital/edu)
    p_match: torch.Tensor    # bool per promo key (no email/event)
    item_id: torch.Tensor    # i32 dictionary id per item key


def gen_q7(rows: int = 40_000, items: int = 128, demos: int = 512,
           promos: int = 64, seed: int = 7, device="cuda") -> Q7Data:
    rng = np.random.default_rng(seed)
    cols = (
        rng.integers(0, items, rows).astype(np.int32),
        rng.integers(0, demos, rows).astype(np.int32),
        rng.integers(0, promos, rows).astype(np.int32),
        rng.integers(1, 100, rows).astype(np.int64),
        rng.integers(100, 20_000, rows).astype(np.int64),
        rng.integers(0, 5_000, rows).astype(np.int64),
        rng.integers(100, 18_000, rows).astype(np.int64),
        rng.random(demos) < 0.2,
        rng.random(promos) < 0.5,
        rng.permutation(items).astype(np.int32),
    )
    return Q7Data(*(torch.from_numpy(a).to(device) for a in cols))


def _q7_kernel(items, limit, reduce_sum):
    """The q7 body (see _q5_kernel)."""

    def compute(s_item, s_cdemo, s_promo, s_qty, s_list, s_coupon,
                s_sales, cd_match, p_match, item_id):
        keep = cd_match[s_cdemo] & p_match[s_promo]
        gid = torch.where(keep, item_id[s_item], 0)
        cnt = reduce_sum(_segment_sum(keep.to(torch.int64), gid, items))
        sums = [reduce_sum(_segment_sum(torch.where(keep, v, 0), gid,
                                        items))
                for v in (s_qty, s_list, s_coupon, s_sales)]
        denom = cnt.clamp(min=1).to(torch.float64)
        avgs = [s.to(torch.float64) / denom for s in sums]
        key = torch.where(cnt > 0, torch.arange(items, dtype=torch.int64,
                                                device=cnt.device), 2**62)
        out = sort_lex((key, cnt, *avgs), num_keys=1)
        return tuple(o[:limit] for o in out)

    return compute


def make_q7(items: int, limit: int = 100):
    """q7-shape pipeline: sales JOIN customer_demographics (selective
    filter) JOIN promotion (filter) JOIN item; four AVGs GROUP BY item
    dictionary id, ORDER BY item id LIMIT `limit` — averages as exact
    int64 sums with one f64 divide at the edge.  Returns fn(Q7Data) ->
    (item id i64, count i64, 4 x avg f64); dead slots hold id 2^62."""
    kernel = _q7_kernel(items, limit, lambda x: x)

    def run(d: Q7Data):
        return kernel(*d)

    return _retried_query("tpcds_q7", run)


def q7_arrays(d: Q7Data):
    """q7's live groups ordered by item id: (ids, counts, then the
    quantity, list, coupon and sales sums), int64 arrays."""
    h = _host(d)
    keep = h.cd_match[h.s_cdemo] & h.p_match[h.s_promo]
    iid = h.item_id[h.s_item[keep]].astype(np.int64)
    n = int(iid.max()) + 1 if len(iid) else 0
    cnt = np.bincount(iid, minlength=n).astype(np.int64)
    sums = [_exact_sums(iid, n, v[keep])
            for v in (h.s_qty, h.s_list, h.s_coupon, h.s_sales)]
    live = np.nonzero(cnt)[0]
    return (live.astype(np.int64), cnt[live], *(s[live] for s in sums))


def oracle_q7(d: Q7Data, items: int, limit: int = 100):
    """[(item id, count, avg qty, avg list, avg coupon, avg sales)]."""
    ids, cnt, *sums = q7_arrays(d)
    # f64 division equals python's int / int while both are exact
    assert all(len(s) == 0 or int(np.abs(s).max()) < 2**53 for s in sums)
    return [(int(i), int(c), *(float(s[k] / c) for s in sums))
            for k, (i, c) in enumerate(zip(ids[:limit], cnt[:limit]))]


# ------------------------------------- q67 / q89 (stage-IR shapes)
# These two shapes have no hand pipeline: their pipelines are stage
# plans (plan/catalog.py).  The seeded generators and oracles below
# are their contract.


class Q67Data(NamedTuple):
    cat: torch.Tensor     # i32 category key
    cls: torch.Tensor     # i32 class key
    sales: torch.Tensor   # i64 decimal64(2) cents


def gen_q67(rows: int = 20_000, ncat: int = 8, ncls: int = 16,
            seed: int = 67, device="cuda") -> Q67Data:
    rng = np.random.default_rng(seed)
    cols = (rng.integers(0, ncat, rows).astype(np.int32),
            rng.integers(0, ncls, rows).astype(np.int32),
            rng.integers(100, 50_000, rows).astype(np.int64))
    return Q67Data(*(torch.from_numpy(a).to(device) for a in cols))


def _q67_finest(d: Q67Data, ncat: int, ncls: int):
    """Dense (ncat * ncls) finest-level sums and counts."""
    h = _host(d)
    g = h.cat.astype(np.int64) * ncls + h.cls
    return (_exact_sums(g, ncat * ncls, h.sales),
            np.bincount(g, minlength=ncat * ncls).astype(np.int64))


def q67_arrays(d: Q67Data, ncat: int, ncls: int):
    """Live finest-level groups ordered by (cat, rank) — rank within
    category by sum DESC, ties by class — as (cat, cls, sum, rank,
    count) int64 arrays, with the per-category sums and the grand
    total."""
    sum0, cnt0 = _q67_finest(d, ncat, ncls)
    g = np.nonzero(cnt0)[0]
    g = g[np.lexsort((g % ncls, -sum0[g], g // ncls))]
    cat = g // ncls
    rank = np.arange(len(g), dtype=np.int64) - np.searchsorted(cat, cat)
    sum1 = sum0.reshape(ncat, ncls).sum(axis=1)
    return (cat, g % ncls, sum0[g], rank, cnt0[g], sum1,
            int(sum0.sum()))


def oracle_q67(d: Q67Data, ncat: int, ncls: int):
    """q67-shape oracle: finest-level rows as [(cat, cls, sum, rank)]
    ordered by (cat, rank), plus the per-category rollup sums and the
    grand total."""
    cat, cls, s, rank, _cnt, sum1, total = q67_arrays(d, ncat, ncls)
    rows = [(int(a), int(b), int(c), int(r))
            for a, b, c, r in zip(cat, cls, s, rank)]
    return rows, [int(x) for x in sum1], total


def oracle_cube(d: Q67Data, ncat: int, ncls: int):
    """All four grouping sets of CUBE(cat, cls) as dense vectors."""
    sum0, cnt0 = _q67_finest(d, ncat, ncls)
    s2 = sum0.reshape(ncat, ncls)
    c2 = cnt0.reshape(ncat, ncls)
    return (sum0, cnt0, s2.sum(axis=1), c2.sum(axis=1),
            int(sum0.sum()), int(cnt0.sum()),
            s2.sum(axis=0), c2.sum(axis=0))


class Q89Data(NamedTuple):
    store: torch.Tensor   # i32 store key
    item: torch.Tensor    # i32 item key
    sales: torch.Tensor   # i64 decimal64(2) cents


def gen_q89(rows: int = 20_000, stores: int = 8, items: int = 32,
            seed: int = 89, device="cuda") -> Q89Data:
    rng = np.random.default_rng(seed)
    cols = (rng.integers(0, stores, rows).astype(np.int32),
            rng.integers(0, items, rows).astype(np.int32),
            rng.integers(100, 30_000, rows).astype(np.int64))
    return Q89Data(*(torch.from_numpy(a).to(device) for a in cols))


def q89_arrays(d: Q89Data, stores: int, items: int):
    """Dense per-(store, item) sales and row counts (group id store *
    items + item) and each store's total, int64 arrays."""
    h = _host(d)
    g = h.store.astype(np.int64) * items + h.item
    return (_exact_sums(g, stores * items, h.sales),
            np.bincount(g, minlength=stores * items).astype(np.int64),
            _exact_sums(h.store, stores, h.sales))


def oracle_q89(d: Q89Data, stores: int, items: int):
    """q89-shape oracle: live (store, item) groups ordered by (store,
    item) with each group's sales, its store's total (the
    sum-over-partition window), and the group row count."""
    sales, cnt, tot = q89_arrays(d, stores, items)
    g = np.nonzero(cnt)[0]
    return [(int(st), int(it), int(s), int(tot[st]), int(c))
            for st, it, s, c in zip(g // items, g % items, sales[g],
                                    cnt[g])]


# ----------------------------------------------------------- multichip
#
# Each factory takes a process group's Mesh (distributed/mesh.py): every
# rank calls the step with its own contiguous shard of the fact columns
# (the JAX package's P(axis) inputs) and the dimension columns whole
# (P()), and every rank gets the replicated outputs.  The bodies are the
# single-device kernels with the reduces set to the group's all_reduce.


def make_q5_multichip(mesh, stores: int, join_capacity: int):
    """q5-shape over the group: facts sharded (row-parallel scan), the
    date window and store dim replicated (broadcast join: dims fit the
    card, the plan GpuBroadcastHashJoin picks), per-shard partial
    group-by via the shared _q5_kernel, one all_reduce per partial for
    the global group table, order-by replicated."""
    kernel = _q5_kernel(stores, join_capacity, mesh.psum, mesh.pany)
    return _mesh_query("tpcds_q5_multichip", mesh, kernel)


def make_q72_multichip(mesh, items: int, max_week: int,
                       join_capacity: int, limit: int = 100,
                       week0: int = 0):
    """q72-shape over the group: catalog_sales sharded, inventory and
    the item dim replicated, per-shard join + filters + partial (item,
    week) counts via the shared _q72_kernel, all_reduce for the global
    group table, top-k replicated."""
    kernel = _q72_kernel(items, max_week, join_capacity, limit, week0,
                         mesh.psum, mesh.pany)
    return _mesh_query("tpcds_q72_multichip", mesh, kernel)


def make_q3_multichip(mesh, base: int, years: int, brands: int,
                      manufact: int, month: int = 11, limit: int = 100):
    """q3-shape over the group: fact sharded, the dense date and item
    dims replicated, partial group tables all-reduced."""
    kernel = _q3_kernel(base, years, brands, manufact, month, limit,
                        mesh.psum)
    return _mesh_query("tpcds_q3_multichip", mesh, kernel)


def make_q7_multichip(mesh, items: int, limit: int = 100):
    """q7-shape over the group: facts sharded, the filter and
    dictionary dims replicated, partial counts and sums all-reduced
    BEFORE the avg divide (a mean of shard means would be wrong)."""
    kernel = _q7_kernel(items, limit, mesh.psum)
    return _mesh_query("tpcds_q7_multichip", mesh, kernel)


# --------------------------------------------------- capacity retry


def run_with_capacity_retry(build, args, capacity: int,
                            max_doublings: int = 16, *, mesh=None):
    """Run a fixed-capacity pipeline under the centralized overflow
    retry (parallel/exchange.with_capacity_retry; collective over
    ``mesh`` when given).  The pipelines report overflow as their LAST
    output.  Returns (outputs, capacity_used)."""
    return with_capacity_retry(build, capacity,
                               max_doublings=max_doublings,
                               mesh=mesh)(*args)


def q5_mesh_data(rows: int, stores: int, n_devices: int,
                 days: int = 60, device="cuda") -> Q5Data:
    """Seeded q5 data shaped for an n-rank mesh (row counts rounded to
    shard evenly): shared by the JVM-driven mesh entry and its oracle
    so the two cannot drift."""
    rows = max(int(rows) // n_devices, 1) * n_devices
    d = gen_q5(rows=rows, stores=stores, days=days, device=device)
    rrows = max(len(d.r_date) // n_devices, 1) * n_devices
    return d._replace(r_date=d.r_date[:rrows],
                      r_store=d.r_store[:rrows],
                      r_amt=d.r_amt[:rrows], r_loss=d.r_loss[:rrows])


def q72_mesh_data(cs_rows: int, items: int, n_devices: int,
                  days: int = 35, device="cuda") -> Q72Data:
    """Seeded q72 data shaped for an n-rank mesh (cs rows rounded to
    shard evenly; inventory replicated)."""
    cs_rows = max(int(cs_rows) // n_devices, 1) * n_devices
    return gen_q72(cs_rows=cs_rows, inv_rows=64, items=items,
                   days=days, device=device)


# ----------------------------------------------------- presentation


def present_q5(outs, store_ids):
    """Decode q5 outputs at the presentation boundary: dictionary ids
    map back to store id STRINGS here (strings never entered the
    pipeline).  Returns [(store_id_str, sales, returns, profit), ...]
    for live rows."""
    key_s, sales, rets, profit, _overflow = (np.asarray(_as_host(x))
                                             for x in outs)
    live = key_s != 2**31 - 1
    return [(store_ids[int(k)], int(a), int(b), int(c))
            for k, a, b, c in zip(key_s[live], sales[live], rets[live],
                                  profit[live])]


def present_q72(outs, item_ids):
    """Decode q72 outputs: item dictionary ids -> item id strings."""
    items, weeks, cnts, _overflow = (np.asarray(_as_host(x))
                                     for x in outs)
    live = cnts > 0
    return [(item_ids[int(i)], int(w), int(c))
            for i, w, c in zip(items[live], weeks[live], cnts[live])]


def _as_host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x
