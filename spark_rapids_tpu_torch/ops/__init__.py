"""Stateless columnar ops: Spark row hashes, JCUDF row conversion, the
fixed-capacity device join probe, the inner join router with its four
engines and the outer/semi/anti transforms, GROUP BY and ORDER BY over
columns and the copying, aggregation and key helpers they stand on."""

from spark_rapids_tpu_torch.ops.joins import (  # noqa: F401
    NULL_EQUAL,
    NULL_UNEQUAL,
    filter_join_pairs,
    get_matched_rows,
    hash_inner_join,
    make_anti,
    make_full_outer,
    make_left_outer,
    make_semi,
    sort_merge_inner_join,
)
