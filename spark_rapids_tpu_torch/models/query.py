"""The star join: the smallest end-to-end composition of the eager op
kernels (hash join -> gather -> group-by aggregate), on the device of
the tables it is given.

The JAX package's multi-chip `make_distributed_hash_aggregate` comes
with ROADMAP A10.
"""

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import copying, groupby, joins
from spark_rapids_tpu_torch.robustness import retry as _retry


def simple_star_join_agg(fact: Table, dim: Table,
                         fact_key: int = 0, fact_value: int = 1,
                         dim_key: int = 0, dim_attr: int = 1) -> Table:
    """SELECT d.attr, sum(f.value), count(*) FROM fact f JOIN dim d
    ON f.key = d.key GROUP BY d.attr.  The retry driver recomputes the
    (pure) composition on a mid-query out-of-memory, under a query-root
    span."""

    def _run():
        li, ri = joins.hash_inner_join(Table([fact.columns[fact_key]]),
                                       Table([dim.columns[dim_key]]))
        value = copying.gather(fact.columns[fact_value], li)
        attr = copying.gather(dim.columns[dim_attr], ri)
        return groupby.groupby_aggregate(
            Table([attr], names=["attr"]), [value, value],
            [groupby.SUM, groupby.COUNT])

    # query-root span: shuffle spans, OOM episodes and retry episodes
    # recorded while the query runs parent under it
    with _obs.TRACER.span("simple_star_join_agg", kind="query"):
        return _retry.with_retry(_run, name="simple_star_join_agg")
