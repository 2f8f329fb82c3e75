"""TPC-DS-shaped pipelines written by hand: q5 and q72.

Each pipeline is eager PyTorch over tensors on one device — scan ->
join(s) -> filter -> group-by -> order-by — with the shapes the real
queries have:

  * q5-shape : sales & returns facts joined to a date-filtered
               date_dim and to a store dim, grouped by store with
               decimal sums, ordered by store — join -> join ->
               group-by -> order-by.
  * q72-shape: catalog_sales joined to inventory on item (fact-fact),
               week-offset filter through date lookups, inventory
               shortage filter, item dim join, group by (item, week),
               count, order by count desc with a LIMIT — the long
               multi-join chain.

Joins are the fixed-capacity device probe
(ops/device_join.inner_join_device), group-bys are integer segment
sums over dictionary-encoded keys, order-bys stable sorts over the
padded group table with sentinel keys for empty groups; decimal sums
are exact int64 scaled arithmetic.  These hand pipelines are the port's
oracles for the stage-IR versions in plan/catalog.py, and the numpy
loops `oracle_q5`/`oracle_q72` define correctness for both.

The generators make the JAX package's draws (`models/tpcds.py` there)
from the same `np.random.default_rng(seed)` in the same order, so both
packages see the same data, and hand it over on ``device``.  The query
spans and task-level retry around each pipeline, and the generators'
ingest notes to the result cache, come with ROADMAP A14.
"""

from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_tpu_torch.ops.device_join import inner_join_device
from spark_rapids_tpu_torch.parallel.exchange import with_capacity_retry


def _segment_sum(value: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Integer sum per id; every id is in range here."""
    out = torch.zeros(num_segments, dtype=value.dtype, device=value.device)
    return out.index_add(0, ids, value)


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

    return run


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

    return run


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


# --------------------------------------------------- capacity retry


def run_with_capacity_retry(build, args, capacity: int,
                            max_doublings: int = 16):
    """Run a fixed-capacity pipeline under the centralized overflow
    retry (parallel/exchange.with_capacity_retry).  The
    pipelines report overflow as their LAST output.  Returns (outputs,
    capacity_used)."""
    return with_capacity_retry(build, capacity,
                               max_doublings=max_doublings)(*args)
