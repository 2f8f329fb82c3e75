"""The star join: the smallest end-to-end composition of the eager op
kernels (hash join -> gather -> group-by aggregate), on the device of
the tables it is given.

The JAX package's multi-chip `make_distributed_hash_aggregate` comes
with ROADMAP A10.
"""

from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import copying, groupby, joins


def simple_star_join_agg(fact: Table, dim: Table,
                         fact_key: int = 0, fact_value: int = 1,
                         dim_key: int = 0, dim_attr: int = 1) -> Table:
    """SELECT d.attr, sum(f.value), count(*) FROM fact f JOIN dim d
    ON f.key = d.key GROUP BY d.attr.

    ROADMAP A14: the JAX package wraps this in a query-root span and
    its retry loop (recomputed on a mid-query out-of-memory)."""
    li, ri = joins.hash_inner_join(Table([fact.columns[fact_key]]),
                                   Table([dim.columns[dim_key]]))
    value = copying.gather(fact.columns[fact_value], li)
    attr = copying.gather(dim.columns[dim_attr], ri)
    return groupby.groupby_aggregate(
        Table([attr], names=["attr"]), [value, value],
        [groupby.SUM, groupby.COUNT])
