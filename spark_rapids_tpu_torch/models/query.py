"""Flagship query pipelines: the "model" of this framework.

Two forms:
  * simple_star_join_agg: eager composition of the real op kernels
    (hash join -> gather -> group-by aggregate), on the device of the
    tables it is given;
  * make_distributed_hash_aggregate: the multi-rank step, murmur3
    partitioning + the all-to-all exchange over a process group +
    bucketed partial aggregation on every rank's device (the analog of
    the reference's executor-parallel shuffle + aggregate).
"""
import torch

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import copying, groupby, joins
from spark_rapids_tpu_torch.ops import hash as H
from spark_rapids_tpu_torch.parallel import exchange as ex
from spark_rapids_tpu_torch.robustness import retry as _retry
from spark_rapids_tpu_torch.utils.u64math import urem


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


def make_distributed_hash_aggregate(mesh, n_parts: int, num_buckets: int,
                                    capacity: int):
    """The multi-rank step over ``mesh`` (distributed/mesh.Mesh): per
    shard murmur3 partition -> all-to-all -> per-rank bucketed sums and
    counts.  Returns (step_fn, shard): ``shard(x)`` is this rank's rows
    of a sharded input (the JAX package returns the sharding).

    Each rank calls step(keys int64 shard, vals float32 shard) and gets
    its own (bucket_sums f32, bucket_counts i32, send_counts i32);
    concatenated in rank order they are the JAX package's sharded
    outputs.  Callers check max(send_counts) <= capacity per the
    exchange contract.  The hash and the bucket are unsigned, as in
    JAX: ``(h mod 2^32) mod n`` and the key's u64 bits mod the buckets,
    in int64 lanes."""

    def local(keys, vals):
        h = H.murmur3_32(
            [Column(dtypes.INT64, keys.shape[0], data=keys)], 42).data
        part = torch.remainder(h.to(torch.int64) & 0xFFFFFFFF,
                               n_parts).to(torch.int32)
        (rk, rv), valid, _total, send_counts = ex.exchange(
            [keys, vals], part, mesh, n_parts, capacity)
        bucket = urem(rk.to(torch.int64), num_buckets)
        bucket = torch.where(valid, bucket, num_buckets)  # dropped lane
        sums = torch.zeros(num_buckets + 1, dtype=rv.dtype,
                           device=rv.device).scatter_add(
            0, bucket, torch.where(valid, rv, 0.0))
        counts = torch.zeros(num_buckets + 1, dtype=torch.int32,
                             device=rv.device).scatter_add(
            0, bucket, valid.to(torch.int32))
        return sums[:num_buckets], counts[:num_buckets], send_counts

    def step(keys, vals):
        # stage-level span around the multi-rank step; the collective
        # retry driver re-runs it on every rank when any rank's attempt
        # fails at its start (a failure inside fails the rank's call)
        with _obs.TRACER.span("distributed_hash_aggregate",
                              kind="stage"):
            return _retry.with_collective_retry(
                lambda: local(keys, vals), mesh.agree,
                name="distributed_hash_aggregate")

    return step, mesh.shard
