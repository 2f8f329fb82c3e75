"""Out-of-core hash join and group-by: when the build side exceeds
``SPARK_RAPIDS_TPU_DEVICE_BUDGET_BYTES``, partition both sides by the
join group ids (ops/hash_join.key_hashes over the join word encoding),
spill the build partitions through the tiered store (memory/spill.py),
and stream them back one partition at a time — each partition running
through the UNCHANGED in-memory operators, so the result equals the
single-pass answer.

Why partitioning preserves the result (the contracts these wrappers
lean on, held by tests/test_torch_spill.py):

* join — ``hash_inner_join`` returns pairs grouped by left index
  ascending, right ascending within a left row.  A key hashes to ONE
  partition, so every match of a left row lives in that row's
  partition; concatenating per-partition pairs (mapped back to global
  indices) and re-sorting by (left, right) reproduces the in-memory
  order exactly.
* group-by — same-key rows land in the same partition, so every group
  is COMPLETE within its partition: per-partition aggregates are the
  FINAL aggregates, computed by ``groupby_aggregate`` over the same
  rows in the same relative order.  On the CPU that makes even float
  sums bit-identical; on a CUDA device float SUM/MEAN add with atomics
  in a varying order, as the in-memory call does (ops/groupby.py).
  Output rows are re-ordered to the in-memory group order (sorted-key
  order, the position-independent contract of ``_group_ids``) by
  running the group-id machinery once over the merged
  one-row-per-group output keys.

Everything stays on the operands' device: partition ids, one stable sort
by partition id and a bincount give every partition's global row
indices (ascending, as a mask would), and the final orders are stable
torch sorts; the host reads only the per-partition counts.  A spilled
partition really leaves device memory: the store drops the only
reference to it (the partition list is dropped once the handles are
registered), and a ``recompute`` after a corrupt spill file re-gathers
from the caller's table by the partition's row indices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.memory import spill as spill_mod
from spark_rapids_tpu_torch.ops import joins
from spark_rapids_tpu_torch.ops.copying import gather_table

_MAX_PARTS = 64


def _partition_count(build_bytes: int, budget: int,
                     parts: Optional[int]) -> int:
    """Power-of-two partition count sized so one build partition fits
    the budget (expectation under a uniform hash), clamped to
    [2, 64]; ``SPARK_RAPIDS_TPU_SPILL_PARTITIONS`` / ``parts``
    overrides."""
    if parts is None:
        parts = spill_mod._env_int("SPARK_RAPIDS_TPU_SPILL_PARTITIONS")
    if parts is not None and parts > 0:
        n = 1 << max(int(parts) - 1, 0).bit_length()
        return max(2, min(_MAX_PARTS, n))
    need = max(2, -(-build_bytes // max(budget, 1)))
    return min(_MAX_PARTS, 1 << (need - 1).bit_length())


def partition_rows(words, nparts: int) -> List[torch.Tensor]:
    """Each partition's global row indices (int32, ascending), from the
    SAME xxhash64 group ids the join engines key on — both join sides
    therefore agree by construction.  The low bits of the u64 hash in
    an int64 lane are the u64's low bits."""
    from spark_rapids_tpu_torch.ops.hash_join import key_hashes
    pid = key_hashes(words) & (nparts - 1)
    order = torch.sort(pid, stable=True).indices.to(torch.int32)
    counts = torch.bincount(pid, minlength=nparts).tolist()
    return list(torch.split(order, counts))


def _spill_partitions(store, table: Table, rows: List[torch.Tensor],
                      stage: str, task_id=None) -> List:
    """Gather, register and spill one partition at a time: the caller
    is ABOUT to exceed its device budget, and the streamed-back working
    set re-enters one partition at a time.  Each handle's recompute
    re-gathers its partition from ``table`` by its row indices."""
    handles = []
    for i, ix in enumerate(rows):
        h = store.register(
            gather_table(table, ix).columns, name=f"{stage}-p{i}",
            task_id=task_id, stage=stage,
            recompute=lambda ix=ix: gather_table(table, ix).columns)
        handles.append(h)
        h.spill()
    return handles


def _lex_pairs(gl: torch.Tensor, gr: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pairs ordered by (left, right): a stable sort by right, then
    a stable sort by left."""
    o = torch.sort(gr, stable=True).indices
    gl, gr = gl[o], gr[o]
    o = torch.sort(gl, stable=True).indices
    return gl[o], gr[o]


def out_of_core_hash_join(left_keys: Table, right_keys: Table,
                          compare_nulls: str = joins.NULL_EQUAL, *,
                          budget: Optional[int] = None,
                          parts: Optional[int] = None,
                          store: Optional[spill_mod.SpillStore] = None,
                          task_id: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``joins.hash_inner_join`` that degrades to partitioned
    out-of-core execution (never to shedding) when the build side
    exceeds the device budget.  Same return contract: (left_indices,
    right_indices) int32 on the keys' device, grouped by left
    ascending, right ascending within."""
    from spark_rapids_tpu_torch.ops.hash_join import join_key_words
    if budget is None:
        budget = spill_mod.device_budget_bytes()
    if budget is None:
        return joins.hash_inner_join(left_keys, right_keys,
                                     compare_nulls)
    build_bytes = spill_mod.columns_nbytes(right_keys.columns)
    if build_bytes <= budget:
        return joins.hash_inner_join(left_keys, right_keys,
                                     compare_nulls)
    try:
        lwords, rwords, _vl, _vr, _extra = join_key_words(
            left_keys, right_keys, compare_nulls)
    except ValueError:
        # no device word encoding for these keys -> no hash to
        # partition on; the host rank path runs in one pass
        return joins.hash_inner_join(left_keys, right_keys,
                                     compare_nulls)
    nparts = _partition_count(build_bytes, budget, parts)
    lidx = partition_rows(lwords, nparts)
    ridx = partition_rows(rwords, nparts)
    del lwords, rwords, _vl, _vr
    if store is None:
        store = spill_mod.ensure_store()
    handles = _spill_partitions(store, right_keys, ridx, "ooc_join",
                                task_id)

    out_l: List[torch.Tensor] = []
    out_r: List[torch.Tensor] = []
    try:
        for p in range(nparts):
            if len(lidx[p]) == 0 or len(ridx[p]) == 0:
                continue
            lpart = gather_table(left_keys, lidx[p])
            # pinned while the join runs: a concurrent ensure_headroom
            # must not re-spill the partition out from under it
            with handles[p].pin() as rcols:
                rpart = Table(rcols, right_keys.names)
                # the UNCHANGED in-memory operator, per partition
                li, ri = joins.hash_inner_join(lpart, rpart,
                                               compare_nulls)
                out_l.append(lidx[p][li.long()])
                out_r.append(ridx[p][ri.long()])
            del lpart, rpart, rcols
            handles[p].close()
    finally:
        for h in handles:
            h.close()
    if not out_l:
        empty = torch.zeros(0, dtype=torch.int32, device=left_keys.device)
        return empty, empty.clone()
    return _lex_pairs(torch.cat(out_l), torch.cat(out_r))


def out_of_core_groupby(keys: Table, values: Sequence, aggs: Sequence[str],
                        *, budget: Optional[int] = None,
                        parts: Optional[int] = None,
                        store: Optional[spill_mod.SpillStore] = None,
                        task_id: Optional[int] = None) -> Table:
    """``groupby.groupby_aggregate`` that partitions by the key hash
    and streams partitions through the spill store when the input
    exceeds the device budget.  Groups are complete per partition, so
    per-partition aggregates are final; rows are re-ordered to the
    in-memory (sorted-key) group order."""
    from spark_rapids_tpu_torch.ops import groupby
    from spark_rapids_tpu_torch.ops.hash_join import join_key_words
    if budget is None:
        budget = spill_mod.device_budget_bytes()
    input_cols = list(keys.columns) + list(values)
    if budget is None:
        return groupby.groupby_aggregate(keys, values, aggs)
    total_bytes = spill_mod.columns_nbytes(input_cols)
    if total_bytes <= budget:
        return groupby.groupby_aggregate(keys, values, aggs)
    try:
        kwords, _rw, _vl, _vr, _extra = join_key_words(
            keys, keys, joins.NULL_EQUAL)
    except ValueError:
        return groupby.groupby_aggregate(keys, values, aggs)
    nparts = _partition_count(total_bytes, budget, parts)
    pidx = [ix for ix in partition_rows(kwords, nparts) if len(ix)]
    del kwords, _rw, _vl, _vr
    nkeys = len(keys.columns)
    if store is None:
        store = spill_mod.ensure_store()
    handles = _spill_partitions(store, Table(input_cols), pidx, "ooc_agg",
                                task_id)

    partials: List[Table] = []
    try:
        for h in handles:
            # pinned while the aggregate runs (see out_of_core_hash_join)
            with h.pin() as cols:
                pkeys = Table(cols[:nkeys], keys.names)
                # the UNCHANGED in-memory operator, per partition
                partials.append(
                    groupby.groupby_aggregate(pkeys, cols[nkeys:], aggs))
            del cols, pkeys
            h.close()
    finally:
        for h in handles:
            h.close()
    if not partials:
        return groupby.groupby_aggregate(keys, values, aggs)
    return merge_group_partials(partials, nkeys)


def merge_group_partials(partials: Sequence[Table], nkeys: int) -> Table:
    """The in-memory ``groupby_aggregate`` output from per-partition
    outputs whose groups are complete (no key in two partials): one row
    per group across all partials, re-ordered to the in-memory group
    order by the group-id machinery (position-independent, sorted-key
    order) over the merged keys."""
    from spark_rapids_tpu_torch.ops import groupby
    from spark_rapids_tpu_torch.ops.copying import concat_tables
    merged = (partials[0] if len(partials) == 1
              else concat_tables(list(partials)))
    ids, _first, _ngroups = groupby._group_ids(
        Table(merged.columns[:nkeys]))
    order = torch.sort(ids, stable=True).indices
    return gather_table(merged, order)
