"""TPC-DS catalog stages expressed in the stage IR.

The hand pipelines in models/tpcds.py are the byte-identity oracles
where a query has one; this module re-expresses the queries as
:class:`~spark_rapids_tpu_torch.plan.ir.StagePlan` pipelines run by
plan/compiler.py:

  * q3, q9     — one stage each: scan-bind -> project/filter ->
                 segment aggregate -> sort/limit;
  * q5, q72    — two stages joined by a typed ShuffleBoundary
                 (partials | finish); one process hands the carry
                 straight across;
  * q67-shape  — GROUP BY ROLLUP(category, class) + rank() OVER
                 (PARTITION BY category ORDER BY sales DESC), and its
                 CUBE variant;
  * q89-shape  — sum(sales) OVER (PARTITION BY store) broadcast back
                 to each (store, item) group.

The plans are the JAX package's (`spark_rapids_tpu/plan/catalog.py`)
node for node, so their digests are equal.

Every expression mirrors its hand-pipeline twin operation for
operation (same dtypes, same literal promotion, exact int64
aggregates), which is what makes the results byte-identical.  Fact
inputs pad their join-key columns with side-specific sentinels (-1
left, -2 right) so bucket-pad rows can never match each other.

The generator-size row estimates come with ROADMAP A14 and the
multi-process fused stage factories with A10.
"""

from spark_rapids_tpu_torch.parallel.exchange import with_capacity_retry
from spark_rapids_tpu_torch.plan.compiler import (compile_pipeline,
                                                  compile_stage)
from spark_rapids_tpu_torch.plan.ir import (Arange, Bin, Col, ColSpec, Idx,
                                            JoinProbe, Lit, Mask, Pipeline,
                                            Project, Reduce, Rollup,
                                            ScanBind, SegmentSum,
                                            ShuffleBoundary, Sl, Sort,
                                            Stack, StagePlan, Un, Where,
                                            WindowRank, WindowSum)

I64_SENTINEL = Lit(2 ** 62, "int64")


def _and(*es):
    out = es[0]
    for e in es[1:]:
        out = Bin("and", out, e)
    return out


def _gt0(e):
    return Bin("gt", e, Lit(0))


# ------------------------------------------------------------------- q5


def q5_partials_plan(stores: int, join_capacity: int) -> StagePlan:
    """Map side of q5 (mirrors models.tpcds._q5_partials): two
    fact-to-date-window join probes, per-store segment sums, overflow
    flag."""
    nodes = []
    for side, (date, key, amt_a, amt_b, j) in (
            ("s", ("s_date", "s_store", "s_price", "s_profit", "j1")),
            ("r", ("r_date", "r_store", "r_amt", "r_loss", "j2"))):
        valid = Col(f"{j}.valid")
        li = Col(f"{j}.li")
        nodes += [
            JoinProbe(j, Col(date), Col("d_date"), join_capacity),
            Project(f"{side}_st",
                    Where(valid, Idx(Col(key), li), Lit(0))),
            SegmentSum(f"{side}_sum_a",
                       Where(valid, Idx(Col(amt_a), li), Lit(0)),
                       Col(f"{side}_st"), stores),
            SegmentSum(f"{side}_sum_b",
                       Where(valid, Idx(Col(amt_b), li), Lit(0)),
                       Col(f"{side}_st"), stores),
            SegmentSum(f"{side}_seen", Un("i64", valid),
                       Col(f"{side}_st"), stores),
        ]
    nodes += [
        Project("profit", Bin("sub", Col("s_sum_b"), Col("r_sum_b"))),
        Project("seen", Bin("add", Col("s_seen"), Col("r_seen"))),
        Project("of", Bin("or",
                          Bin("gt", Col("j1.total"),
                              Lit(join_capacity)),
                          Bin("gt", Col("j2.total"),
                              Lit(join_capacity)))),
    ]
    return StagePlan(
        name="q5_partials",
        inputs=(
            ScanBind("s", (ColSpec("s_date", pad=-1),
                           ColSpec("s_store"), ColSpec("s_price"),
                           ColSpec("s_profit"))),
            ScanBind("r", (ColSpec("r_date", pad=-1),
                           ColSpec("r_store"), ColSpec("r_amt"),
                           ColSpec("r_loss"))),
            ScanBind("d", (ColSpec("d_date", pad=-2),)),
        ),
        nodes=tuple(nodes),
        outputs=("s_sum_a", "r_sum_a", "profit", "seen", "of"),
    )


def q5_finish_plan(stores: int) -> StagePlan:
    """Reduce side of q5 (mirrors models.tpcds._q5_finish): global
    group table -> ORDER BY s_store_id.  The Reduce nodes are the
    cross-shard seam: identity in one process."""
    return StagePlan(
        name="q5_finish",
        inputs=(
            ScanBind("xchg", (ColSpec("s_sum_a"), ColSpec("r_sum_a"),
                              ColSpec("profit"), ColSpec("seen"),
                              ColSpec("of")), bucket=False),
            ScanBind("dims", (ColSpec("st_id"),), bucket=False),
        ),
        nodes=(
            Reduce("g_sales", Col("s_sum_a")),
            Reduce("g_rets", Col("r_sum_a")),
            Reduce("g_profit", Col("profit")),
            Reduce("g_seen", Col("seen")),
            Reduce("g_of", Col("of"), kind="any"),
            Project("key", Where(_gt0(Col("g_seen")), Col("st_id"),
                                 Lit(2 ** 31 - 1, "int32"))),
            Sort(("key_s", "sales_s", "ret_s", "profit_s"),
                 (Col("key"), Col("g_sales"), Col("g_rets"),
                  Col("g_profit")), num_keys=1),
        ),
        outputs=("key_s", "sales_s", "ret_s", "profit_s", "g_of"),
    )


def q5_pipeline(stores: int, join_capacity: int) -> Pipeline:
    return Pipeline(
        name="q5",
        stages=(q5_partials_plan(stores, join_capacity),
                q5_finish_plan(stores)),
        boundaries=(ShuffleBoundary(
            ("s_sum_a", "r_sum_a", "profit", "seen", "of")),),
    )


def run_q5(d, stores: int, capacity: int):
    """q5 under the capacity retry, on the device of ``d``'s
    tensors.  Returns the same tuple as models.tpcds.make_q5(...)(d)."""

    def build(cap):
        pipe = compile_pipeline(q5_pipeline(stores, cap))
        return lambda *a: pipe.run({"s": a[0:4], "r": a[4:8],
                                    "d": (a[8],), "dims": (a[9],)})

    outs, _cap = with_capacity_retry(build, capacity, max_doublings=16)(
        d.s_date, d.s_store, d.s_price, d.s_profit,
        d.r_date, d.r_store, d.r_amt, d.r_loss, d.d_date, d.st_id)
    return outs


def run_q5_partials(args, stores: int, capacity: int, *, check=None):
    """The map side alone: ``args`` = the 8 fact columns + the d_date
    window; returns ((sales, rets, profit, seen, of), cap).  ``check``
    runs before every capacity attempt (raise from it to cancel)."""

    def build(cap):
        st = compile_stage(q5_partials_plan(stores, cap))
        return lambda *a: st.run({"s": a[0:4], "r": a[4:8],
                                  "d": (a[8],)})

    return with_capacity_retry(build, capacity, max_doublings=16,
                               check=check)(*args)


def run_q5_finish(sales, rets, profit, seen, of, st_id, stores: int):
    """The reduce side alone (inputs already globally summed)."""
    st = compile_stage(q5_finish_plan(stores))
    return st.run({"xchg": (sales, rets, profit, seen, of),
                   "dims": (st_id,)})


# ------------------------------------------------------------------ q72


def q72_partials_plan(items: int, max_week: int, join_capacity: int,
                      week0: int) -> StagePlan:
    """Map side of q72 (mirrors models.tpcds._q72_partials): fact-fact
    join probe + week-offset/shortage filters + (item, week) counts."""
    n_groups = items * max_week
    return StagePlan(
        name="q72_partials",
        inputs=(
            ScanBind("cs", (ColSpec("cs_item", pad=-1),
                            ColSpec("cs_date"), ColSpec("cs_qty"))),
            ScanBind("inv", (ColSpec("inv_item", pad=-2),
                             ColSpec("inv_date"), ColSpec("inv_qty"))),
            ScanBind("dim", (ColSpec("item_id"),), bucket=False),
        ),
        nodes=(
            JoinProbe("j", Col("cs_item"), Col("inv_item"),
                      join_capacity),
            Project("ow", Bin("floordiv",
                              Idx(Col("cs_date"), Col("j.li")),
                              Lit(7))),
            Project("iw", Bin("floordiv",
                              Idx(Col("inv_date"), Col("j.ri")),
                              Lit(7))),
            Project("wk", Bin("sub", Col("ow"), Lit(week0))),
            Project("keep", _and(
                Col("j.valid"),
                Bin("eq", Col("iw"), Bin("add", Col("ow"), Lit(1))),
                Bin("lt", Idx(Col("inv_qty"), Col("j.ri")),
                    Idx(Col("cs_qty"), Col("j.li"))),
                Bin("ge", Col("wk"), Lit(0)),
                Bin("lt", Col("wk"), Lit(max_week)))),
            Project("iid", Idx(Col("item_id"),
                               Idx(Col("cs_item"), Col("j.li")))),
            Project("gid", Where(
                Col("keep"),
                Bin("add", Bin("mul", Col("iid"), Lit(max_week)),
                    Col("wk")), Lit(0))),
            SegmentSum("counts", Un("i64", Col("keep")), Col("gid"),
                       n_groups),
            Project("of", Bin("gt", Col("j.total"),
                              Lit(join_capacity))),
        ),
        outputs=("counts", "of"),
    )


def q72_finish_plan(items: int, max_week: int, limit: int,
                    week0: int) -> StagePlan:
    """Reduce side of q72 (mirrors models.tpcds._q72_finish): top-k
    over the global count vector."""
    n_groups = items * max_week
    return StagePlan(
        name="q72_finish",
        inputs=(ScanBind("xchg", (ColSpec("counts"), ColSpec("of")),
                         bucket=False),),
        nodes=(
            Reduce("g_counts", Col("counts")),
            Reduce("g_of", Col("of"), kind="any"),
            Project("gidx", Arange(n_groups, "int64")),
            Project("skey", Where(_gt0(Col("g_counts")),
                                  Un("neg", Col("g_counts")),
                                  I64_SENTINEL)),
            Sort(("_k", "gid_s", "cnt_s"),
                 (Col("skey"), Col("gidx"), Col("g_counts")),
                 num_keys=2),
            Project("item", Bin("floordiv", Sl(Col("gid_s"), 0, limit),
                                Lit(max_week))),
            Project("week", Bin("add",
                                Bin("mod", Sl(Col("gid_s"), 0, limit),
                                    Lit(max_week)), Lit(week0))),
            Project("cnt", Sl(Col("cnt_s"), 0, limit)),
        ),
        outputs=("item", "week", "cnt", "g_of"),
    )


def q72_pipeline(items: int, max_week: int, join_capacity: int,
                 limit: int = 100, week0: int = 0) -> Pipeline:
    return Pipeline(
        name="q72",
        stages=(q72_partials_plan(items, max_week, join_capacity,
                                  week0),
                q72_finish_plan(items, max_week, limit, week0)),
        boundaries=(ShuffleBoundary(("counts", "of")),),
    )


def run_q72(d, items: int, max_week: int, capacity: int,
            limit: int = 100, week0: int = 0):
    """q72 under the capacity retry — same tuple as make_q72."""

    def build(cap):
        pipe = compile_pipeline(
            q72_pipeline(items, max_week, cap, limit, week0))
        return lambda *a: pipe.run({"cs": a[0:3], "inv": a[3:6],
                                    "dim": (a[6],)})

    outs, _cap = with_capacity_retry(build, capacity, max_doublings=16)(
        d.cs_item, d.cs_date, d.cs_qty, d.inv_item, d.inv_date,
        d.inv_qty, d.item_id)
    return outs


def run_q72_partials(args, items: int, max_week: int, capacity: int,
                     week0: int):
    def build(cap):
        st = compile_stage(
            q72_partials_plan(items, max_week, cap, week0))
        return lambda *a: st.run({"cs": a[0:3], "inv": a[3:6],
                                  "dim": (a[6],)})

    return with_capacity_retry(build, capacity, max_doublings=16)(*args)


def run_q72_finish(counts, of, items: int, max_week: int, limit: int,
                   week0: int):
    st = compile_stage(q72_finish_plan(items, max_week, limit, week0))
    return st.run({"xchg": (counts, of)})


# ------------------------------------------------------------------- q3


def q3_plan(base: int, years: int, brands: int, manufact: int,
            month: int = 11, limit: int = 100) -> StagePlan:
    """q3 as ONE stage (mirrors models.tpcds._q3_kernel): dense date +
    item dim lookups, month/manufacturer filters, (year, brand) sums,
    three-key order-by with LIMIT."""
    n_groups = years * brands
    return StagePlan(
        name="q3",
        inputs=(
            ScanBind("s", (ColSpec("s_date", pad=base),
                           ColSpec("s_item"), ColSpec("s_price"))),
            ScanBind("dims", (ColSpec("d_moy"), ColSpec("d_year"),
                              ColSpec("i_brand"),
                              ColSpec("i_manufact")), bucket=False),
        ),
        nodes=(
            Project("di", Bin("sub", Col("s_date"), Lit(base))),
            Project("year_idx", Bin("sub",
                                    Idx(Col("d_year"), Col("di")),
                                    Idx(Col("d_year"), Lit(0)))),
            # Mask('s') last: pad rows (s_date=base -> a real day)
            # must never reach the aggregates
            Project("keep", _and(
                Bin("eq", Idx(Col("d_moy"), Col("di")), Lit(month)),
                Bin("eq", Idx(Col("i_manufact"), Col("s_item")),
                    Lit(manufact)),
                Bin("ge", Col("year_idx"), Lit(0)),
                Bin("lt", Col("year_idx"), Lit(years)),
                Mask("s"))),
            Project("brand", Idx(Col("i_brand"), Col("s_item"))),
            Project("gid", Where(
                Col("keep"),
                Bin("add", Bin("mul", Col("year_idx"), Lit(brands)),
                    Col("brand")), Lit(0))),
            Project("amt", Where(Col("keep"), Col("s_price"),
                                 Lit(0))),
            SegmentSum("sums0", Col("amt"), Col("gid"), n_groups),
            Reduce("sums", Col("sums0")),
            SegmentSum("cnts0", Un("i64", Col("keep")), Col("gid"),
                       n_groups),
            Reduce("cnts", Col("cnts0")),
            Project("gidx", Arange(n_groups, "int64")),
            Project("year_of_g", Bin("floordiv", Col("gidx"),
                                     Lit(brands))),
            Project("brand_of_g", Bin("mod", Col("gidx"),
                                      Lit(brands))),
            Project("k1", Where(_gt0(Col("cnts")), Col("year_of_g"),
                                I64_SENTINEL)),
            Project("k2", Where(_gt0(Col("cnts")),
                                Un("neg", Col("sums")),
                                I64_SENTINEL)),
            Sort(("_a", "_b", "_c", "g_s", "sum_s", "cnt_s"),
                 (Col("k1"), Col("k2"), Col("brand_of_g"),
                  Col("gidx"), Col("sums"), Col("cnts")), num_keys=3),
            Project("live", _gt0(Sl(Col("cnt_s"), 0, limit))),
            Project("yrs", Where(
                Col("live"),
                Bin("add", Bin("floordiv", Sl(Col("g_s"), 0, limit),
                               Lit(brands)),
                    Idx(Col("d_year"), Lit(0))),
                Lit(2 ** 31 - 1, "int64"))),
            Project("brands_out", Bin("mod", Sl(Col("g_s"), 0, limit),
                                      Lit(brands))),
            Project("sums_out", Sl(Col("sum_s"), 0, limit)),
            Project("total", Un("sum", Col("cnts"))),
        ),
        outputs=("yrs", "brands_out", "sums_out", "total"),
    )


def run_q3(d, base: int, years: int, brands: int, manufact: int,
           month: int = 11, limit: int = 100):
    """q3 on the device of ``d``'s tensors — same tuple as
    models.tpcds.make_q3(...)(d).  The second ScanBind is unbucketed:
    the date and item dims' exact lengths enter the compile key."""
    # ROADMAP A14: the generator-size row estimates are noted here
    st = compile_stage(q3_plan(base, years, brands, manufact, month,
                               limit))
    return st.run({"s": (d.s_date, d.s_item, d.s_price),
                   "dims": (d.d_moy, d.d_year, d.i_brand,
                            d.i_manufact)})


# ------------------------------------------------------------------- q9

_Q9_BUCKETS = ((1, 20), (21, 40), (41, 60), (61, 80), (81, 100))


def q9_plan() -> StagePlan:
    """q9 as ONE stage (mirrors models.tpcds.run_q9): five CASE-WHEN
    quantity buckets, exact int64 sums, f64 avgs at the edge.  Pad
    rows carry quantity 0, outside every bucket."""
    nodes = []
    cs, aps, ans = [], [], []
    for k, (lo, hi) in enumerate(_Q9_BUCKETS):
        m = f"m{k}"
        nodes += [
            Project(m, Bin("and",
                           Bin("ge", Col("quantity"), Lit(lo)),
                           Bin("le", Col("quantity"), Lit(hi)))),
            Project(f"c{k}", Un("sum", Un("i64", Col(m)))),
            Project(f"sp{k}", Un("sum", Where(Col(m), Col("price"),
                                              Lit(0)))),
            Project(f"sn{k}", Un("sum", Where(Col(m), Col("profit"),
                                              Lit(0)))),
            Project(f"ap{k}", Bin("div", Un("f64", Col(f"sp{k}")),
                                  Un("f64", Bin("max", Col(f"c{k}"),
                                                Lit(1))))),
            Project(f"an{k}", Bin("div", Un("f64", Col(f"sn{k}")),
                                  Un("f64", Bin("max", Col(f"c{k}"),
                                                Lit(1))))),
        ]
        cs.append(Col(f"c{k}"))
        aps.append(Col(f"ap{k}"))
        ans.append(Col(f"an{k}"))
    nodes += [Project("counts", Stack(tuple(cs))),
              Project("avg_p", Stack(tuple(aps))),
              Project("avg_n", Stack(tuple(ans)))]
    return StagePlan(
        name="q9",
        inputs=(ScanBind("f", (ColSpec("quantity"), ColSpec("price"),
                               ColSpec("profit"))),),
        nodes=tuple(nodes),
        outputs=("counts", "avg_p", "avg_n"),
    )


def run_q9(quantity, price, profit):
    st = compile_stage(q9_plan())
    return st.run({"f": (quantity, price, profit)})


# ------------------------------------------- q67-shape (rollup + rank)


def q67_plan(ncat: int, ncls: int) -> StagePlan:
    """q67-shape: sum(sales) GROUP BY ROLLUP(category, class), then
    rank() OVER (PARTITION BY category ORDER BY sum DESC) on the
    finest level, presented sorted by (category, rank).  Dead groups
    sort last under int sentinels."""
    n = ncat * ncls
    return StagePlan(
        name="q67",
        inputs=(ScanBind("f", (ColSpec("cat"), ColSpec("cls"),
                               ColSpec("sales"))),),
        nodes=(
            Rollup("r", (Col("cat"), Col("cls")), (ncat, ncls),
                   Col("sales"), Mask("f"), mode="rollup"),
            Project("part", Bin("floordiv", Arange(n, "int64"),
                                Lit(ncls))),
            Project("okey", Where(_gt0(Col("r.cnt0")),
                                  Un("neg", Col("r.sum0")),
                                  I64_SENTINEL)),
            WindowRank("rank", Col("part"), Col("okey")),
            Project("kcat", Where(_gt0(Col("r.cnt0")), Col("part"),
                                  Lit(2 ** 31 - 1, "int64"))),
            Sort(("cat_s", "rank_s", "gid_s", "sum_s", "cnt_s"),
                 (Col("kcat"), Col("rank"), Arange(n, "int64"),
                  Col("r.sum0"), Col("r.cnt0")), num_keys=2),
            Project("cls_s", Bin("mod", Col("gid_s"), Lit(ncls))),
        ),
        outputs=("cat_s", "cls_s", "sum_s", "rank_s", "cnt_s",
                 "r.sum1", "r.sumt"),
    )


def run_q67(d, ncat: int, ncls: int):
    st = compile_stage(q67_plan(ncat, ncls))
    return st.run({"f": (d.cat, d.cls, d.sales)})


def cube_plan(ncat: int, ncls: int) -> StagePlan:
    """The CUBE variant of the grouping-sets node: all four grouping
    sets of (cat, cls) as exact int64 folds of the finest level."""
    return StagePlan(
        name="cube2",
        inputs=(ScanBind("f", (ColSpec("cat"), ColSpec("cls"),
                               ColSpec("sales"))),),
        nodes=(Rollup("r", (Col("cat"), Col("cls")), (ncat, ncls),
                      Col("sales"), Mask("f"), mode="cube"),),
        outputs=("r.sum0", "r.cnt0", "r.sum1", "r.cnt1", "r.sumt",
                 "r.cntt", "r.sum2", "r.cnt2"),
    )


def run_cube(d, ncat: int, ncls: int):
    st = compile_stage(cube_plan(ncat, ncls))
    return st.run({"f": (d.cat, d.cls, d.sales)})


# ------------------------------------ q89-shape (sum-over-partition)


def q89_plan(stores: int, items: int) -> StagePlan:
    """q89-shape: per-(store, item) sales vs the whole store's total —
    sum(sales) OVER (PARTITION BY store) broadcast back to each group
    row, presented sorted by (store, item), live groups first."""
    n = stores * items
    return StagePlan(
        name="q89",
        inputs=(ScanBind("f", (ColSpec("store"), ColSpec("item"),
                               ColSpec("sales"))),),
        nodes=(
            Project("gid", Where(
                Mask("f"),
                Bin("add", Bin("mul", Un("i64", Col("store")),
                               Lit(items)),
                    Un("i64", Col("item"))), Lit(0))),
            Project("w", Where(Mask("f"), Col("sales"), Lit(0))),
            SegmentSum("g_sales", Col("w"), Col("gid"), n),
            SegmentSum("g_cnt", Un("i64", Mask("f")), Col("gid"), n),
            Project("part", Bin("floordiv", Arange(n, "int64"),
                                Lit(items))),
            WindowSum("tot", Col("part"), Col("g_sales"), stores),
            Project("key", Where(_gt0(Col("g_cnt")),
                                 Arange(n, "int64"), I64_SENTINEL)),
            Sort(("key_s", "gid_s", "sales_s", "tot_s", "cnt_s"),
                 (Col("key"), Arange(n, "int64"), Col("g_sales"),
                  Col("tot"), Col("g_cnt")), num_keys=1),
            Project("store_s", Bin("floordiv", Col("gid_s"),
                                   Lit(items))),
            Project("item_s", Bin("mod", Col("gid_s"), Lit(items))),
        ),
        outputs=("store_s", "item_s", "sales_s", "tot_s", "cnt_s"),
    )


def run_q89(d, stores: int, items: int):
    st = compile_stage(q89_plan(stores, items))
    return st.run({"f": (d.store, d.item, d.sales)})
