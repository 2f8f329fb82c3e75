"""TPC-DS catalog stages expressed in the stage IR: q5 and q72.

The hand pipelines in models/tpcds.py are the byte-identity oracles;
this module re-expresses the same queries as
:class:`~spark_rapids_tpu_torch.plan.ir.StagePlan` pipelines run by
plan/compiler.py.  q5 and q72 are two stages each joined by a typed
ShuffleBoundary (partials | finish); one process hands the carry
straight across.  The plans are the JAX package's
(`spark_rapids_tpu/plan/catalog.py`) node for node, so their digests
are equal.

Every expression mirrors its hand-pipeline twin operation for
operation (same dtypes, same literal promotion, exact int64
aggregates), which is what makes the results byte-identical.  Fact
inputs pad their join-key columns with side-specific sentinels (-1
left, -2 right) so bucket-pad rows can never match each other.

q3, q9, q67 and q89 come next (ROADMAP A8); the generator-size row
estimates (A14) and the multi-process fused stage factories (A10) later.
"""

from spark_rapids_tpu_torch.parallel.exchange import with_capacity_retry
from spark_rapids_tpu_torch.plan.compiler import (compile_pipeline,
                                                  compile_stage)
from spark_rapids_tpu_torch.plan.ir import (Arange, Bin, Col, ColSpec, Idx,
                                            JoinProbe, Lit, Pipeline,
                                            Project, Reduce, ScanBind,
                                            SegmentSum, ShuffleBoundary, Sl,
                                            Sort, StagePlan, Un, Where)

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
