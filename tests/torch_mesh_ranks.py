"""Rank programs for the port's mesh tests: each runs on every rank of a
``distributed.pool.RankPool`` as ``fn(mesh, *args)``.  They take the
full host arrays (the same numpy inputs the JAX side gets), shard them
as ``P(axis)`` does, and return the rank's outputs (the pool copies
tensors to numpy).  No JAX here: the ranks import torch and the port
only.
"""

import numpy as np
import torch

from spark_rapids_tpu_torch.models import distributed_join as DJ
from spark_rapids_tpu_torch.models import query as Q
from spark_rapids_tpu_torch.models import tpcds as TT
from spark_rapids_tpu_torch.parallel import exchange as EX
from spark_rapids_tpu_torch.plan import catalog as TC

# factory name -> (how many leading inputs are sharded; the rest are
# replicated), as the JAX package's in_specs say
SHARDED = {"q5": 8, "q72": 3, "q3": 3, "q7": 7, "q9": 3}


def _t(mesh, x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)


def _args(mesh, arrays, sharded):
    return [mesh.shard(_t(mesh, a)) if i < sharded else _t(mesh, a)
            for i, a in enumerate(arrays)]


def exchange_rank(mesh, keys, vals, cap, all_to_zero=False):
    k, v = mesh.shard(_t(mesh, keys)), mesh.shard(_t(mesh, vals))
    part = (torch.zeros_like(k, dtype=torch.int32) if all_to_zero
            else torch.remainder(k, mesh.size).to(torch.int32))
    (rk, rv), valid, total, sends = EX.exchange([k, v], part, mesh,
                                                mesh.size, cap)
    return rk, rv, valid, total[None], sends, mesh.stats.as_dict()


def join_rank(mesh, lk, lv, rk, rv, exch_cap, pair_cap):
    step = DJ.make_distributed_join(mesh, exch_cap, pair_cap)
    return step(*(mesh.shard(_t(mesh, x)) for x in (lk, lv, rk, rv)))


def join_auto_rank(mesh, lk, lv, rk, rv, exch_cap, pair_cap,
                   max_doublings):
    run = DJ.make_distributed_join_auto(mesh, exch_cap, pair_cap,
                                        max_doublings=max_doublings)
    return run(*(mesh.shard(_t(mesh, x)) for x in (lk, lv, rk, rv)))


def aggregate_rank(mesh, keys, vals, num_buckets, capacity):
    step, shard = Q.make_distributed_hash_aggregate(
        mesh, mesh.size, num_buckets, capacity)
    return step(shard(_t(mesh, keys)), shard(_t(mesh, vals)))


def lockstep_rank(mesh, overflow_below, max_doublings):
    """A program whose only overflow is rank 0's while its capacity is
    under ``overflow_below``: the retry must double every rank."""
    attempts = []

    def make_step(cap):
        def step():
            attempts.append(cap)
            flag = mesh.rank == 0 and cap < overflow_below
            return (torch.tensor([flag]),
                    torch.tensor([cap * (mesh.rank + 1)], dtype=torch.int64))
        return step

    try:
        out, cap = EX.with_capacity_retry(
            make_step, 1, max_doublings=max_doublings, overflow_index=0,
            mesh=mesh)()
    except EX.CapacityExceeded as e:
        return "exceeded", e.capacity, attempts
    return "ok", cap, attempts, out


def counts_rank(mesh, max_doublings):
    """A counts indicator that never fits: the terminal error carries
    the largest counts over the ranks."""
    def make_step(cap):
        def step():
            return (torch.tensor([10 + mesh.rank, 3], dtype=torch.int32),)
        return step

    try:
        EX.with_capacity_retry(make_step, 1, max_doublings=max_doublings,
                               overflow_index=0, counts_indicator=True,
                               mesh=mesh)()
    except EX.CapacityExceeded as e:
        return e.send_counts
    return None


def tpcds_rank(mesh, name, arrays, params):
    make = getattr(TT, f"make_{name}_multichip")
    step = make(mesh, **params)
    return step(*_args(mesh, arrays, SHARDED[name]))


def fused_rank(mesh, name, arrays, params):
    """The fused mesh program and the op-by-op one on the same shard:
    (fused outputs, op-by-op outputs, graphs compiled, all_reduces)."""
    fused = getattr(TC, f"make_{name}_multichip_fused")(mesh, **params)
    args = _args(mesh, arrays, SHARDED[name])
    mesh.stats.reset()
    got = fused(*args)
    reduces = mesh.stats.all_reduce
    want = getattr(TT, f"make_{name}_multichip")(mesh, **params)(*args)
    return got, want, fused.program.compiles, reduces


def injected_oom_rank(mesh, keys, vals, num_buckets, capacity, bad_rank,
                      rules_path):
    """The hash aggregate with the fault injector's rules at
    ``rules_path`` (one GpuRetryOOM at the step's attempt start) on
    ``bad_rank`` alone: the rank's outputs and its all_reduce count."""
    from spark_rapids_tpu_torch.utils import fault_injection as FI
    if mesh.rank == bad_rank:
        FI.install(rules_path)
    try:
        step, shard = Q.make_distributed_hash_aggregate(
            mesh, mesh.size, num_buckets, capacity)
        mesh.stats.reset()
        out = step(shard(_t(mesh, keys)), shard(_t(mesh, vals)))
    finally:
        if mesh.rank == bad_rank:
            FI.uninstall()
    return out + (mesh.stats.all_reduce,)


def oom_inside_rank(mesh, keys, vals, num_buckets, capacity, bad_rank):
    """The hash aggregate with a GpuRetryOOM raised on ``bad_rank``
    between the exchange's collectives, inside the step."""
    from spark_rapids_tpu_torch.memory import exceptions as exc
    if mesh.rank == bad_rank:
        real, calls = mesh.all_to_all, []

        def all_to_all(x):
            calls.append(x)
            if len(calls) == 2:
                raise exc.GpuRetryOOM("out of memory between collectives")
            return real(x)

        mesh.all_to_all = all_to_all
    return aggregate_rank(mesh, keys, vals, num_buckets, capacity)


def oom_once_rank(mesh, mark):
    """Rank 1 raises a GpuRetryOOM inside its work the first time (the
    file ``mark`` remembers it across pools); then every rank returns
    the group's size, summed over the group, in the entries' form."""
    import os
    from spark_rapids_tpu_torch.memory import exceptions as exc
    if mesh.rank == 1 and not os.path.exists(mark):
        open(mark, "w").close()
        raise exc.GpuRetryOOM("rank 1 out of memory inside its step")
    total = int(mesh.psum(torch.ones(1, dtype=torch.int64)))
    return [total], {"rank": mesh.rank}


def fail_rank(mesh, bad_rank):
    if mesh.rank == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    # the others wait in a collective the failed rank never joins
    return mesh.psum(torch.ones(1, dtype=torch.int64))


def stage_fused_fn_rank(mesh, stores, partials, st_id):
    """q5's finish stage through CompiledStage.fused_fn over the group,
    run eagerly on this rank's row of each partial."""
    from spark_rapids_tpu_torch.plan.compiler import compile_stage
    fn = compile_stage(TC.q5_finish_plan(stores)).fused_fn(mesh)
    return fn(*[mesh.shard(_t(mesh, p)) for p in partials],
              _t(mesh, st_id))
