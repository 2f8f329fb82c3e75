"""PyTorch port: the fixed-capacity exchange over a process group and
the programs on it (parallel/exchange.build_padded_sends and exchange,
models/distributed_join, models/query.make_distributed_hash_aggregate,
the collective capacity retry, distributed/mesh and distributed/pool),
held against the JAX package's shard_map versions.

The JAX side runs on a mesh of R of the 8 virtual CPU devices
(tests/conftest.py); the port side on R gloo CPU ranks, one
module-scoped RankPool per R (R = 2 and 4) that every case is sent to,
its group rendezvous on a ``file://`` store.  The same numpy inputs go
to both; each rank returns its own slice of a sharded output, and the
slices concatenated in rank order must equal the JAX output byte for
byte.  Float sums per bucket (f32, summed in another order than
``jax.ops.segment_sum``) are held to twice the classical bound,
2 * count * 2^-24 * sum |v|.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import torch_mesh_ranks as MR
from spark_rapids_tpu.models import distributed_join as JDJ
from spark_rapids_tpu.models import query as JQ
from spark_rapids_tpu.parallel import exchange as JEX
from spark_rapids_tpu.utils.jax_compat import shard_map
from spark_rapids_tpu_torch.distributed import mesh as M
from spark_rapids_tpu_torch.distributed.pool import RankFailed, RankPool
from spark_rapids_tpu_torch.parallel import exchange as EX
from spark_rapids_tpu_torch.utils.u64math import urem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = (2, 4)


@pytest.fixture(scope="module")
def pools():
    made = {}
    try:
        for r in RANKS:
            made[r] = RankPool(r, device="cpu", timeout_s=90)
        yield made
    finally:
        for pool in made.values():
            pool.close()


def jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def cat(results, i):
    """Output ``i`` of every rank, concatenated in rank order."""
    return np.concatenate([np.asarray(r[i]).reshape(
        (-1,) + np.asarray(r[i]).shape[1:]) for r in results])


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------ padded sends


@pytest.mark.parametrize("layout", ["counting", "argsort"])
@pytest.mark.parametrize("case", ["small", "paths"])
def test_build_padded_sends_matches_jax(monkeypatch, layout, case):
    """Both layouts give the JAX package's (partition, rank) slots, the
    overflow slot dropped (the "paths" case is the counting sort against
    argsort check of test_device_join_paths)."""
    if case == "small":
        part = np.array([2, 0, 2, 1, 2, 0], np.int32)
        cols = [np.array([20, 0, 21, 10, 22, 1], np.int64)]
        n_parts, cap = 4, 3
    else:
        rng = np.random.default_rng(9)
        rows, n_parts, cap = 257, 8, 64
        part = rng.integers(0, n_parts, rows, dtype=np.int32)
        cols = [rng.integers(0, 1000, rows, dtype=np.int64),
                rng.normal(size=rows), rng.random(rows) < 0.5]
        cap = 30    # some partitions overflow
    if layout == "argsort":
        monkeypatch.setattr(EX, "_COUNTING_SORT_MAX_BYTES", 0)
        monkeypatch.setattr(JEX, "_COUNTING_SORT_MAX_BYTES", 0)
    jsends, jcounts = JEX.build_padded_sends(
        [jnp.asarray(c) for c in cols], jnp.asarray(part), n_parts, cap)
    sends, counts = EX.build_padded_sends(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(part),
        n_parts, cap)
    same(counts.numpy(), jcounts)
    for s, js in zip(sends, jsends):
        same(s.numpy(), js)


# ---------------------------------------------------------- exchange


def jax_exchange(n, keys, vals, cap, all_to_zero=False):
    def local(k, v):
        part = (jnp.zeros_like(k, jnp.int32) if all_to_zero
                else (k % n).astype(jnp.int32))
        (rk, rv), valid, total, sends = JEX.exchange(
            [k, v], part, "data", n, cap)
        return rk, rv, valid, total[None], sends

    mesh = jmesh(n)
    f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"),) * 2,
                          out_specs=(P("data"),) * 5))
    sh = NamedSharding(mesh, P("data"))
    return f(jax.device_put(jnp.asarray(keys), sh),
             jax.device_put(jnp.asarray(vals), sh))


@pytest.mark.parametrize("n", RANKS)
def test_exchange_all_rows_arrive(pools, n):
    rng = np.random.default_rng(0)
    keys = rng.integers(-1000, 1000, n * 32, dtype=np.int64)
    vals = np.arange(n * 32, dtype=np.int64)
    cap = 24
    want = jax_exchange(n, keys, vals, cap)
    got = pools[n].run(MR.exchange_rank, keys, vals, cap)
    for i in range(5):
        same(cat(got, i), want[i])
    assert (cat(got, 4) <= cap).all()
    # every row arrives exactly once, on the rank its key names
    rk, rv, valid = (cat(got, i).reshape(n, -1) for i in range(3))
    for d in range(n):
        assert ((rk[d][valid[d]] % n) == d).all()
    assert sorted(rv[valid].tolist()) == vals.tolist()
    # two all_to_alls of data and one of counts, each rank
    assert [r[5]["all_to_all"] for r in got] == [3] * n


@pytest.mark.parametrize("n", RANKS)
def test_exchange_overflow_clips_counts(pools, n):
    keys = np.arange(n * 8, dtype=np.int64)
    cap = 2    # every key goes to partition 0
    want = jax_exchange(n, keys, keys, cap, all_to_zero=True)
    got = pools[n].run(MR.exchange_rank, keys, keys, cap, True)
    for i in range(5):
        same(cat(got, i), want[i])
    total = cat(got, 3)
    assert (cat(got, 4).reshape(n, n)[:, 0] == 8).all()
    assert total[0] == n * cap and (total[1:] == 0).all()


# ---------------------------------------------------- distributed join


def join_rows(outs):
    k, lv, rv, valid = (np.asarray(o).reshape(-1) for o in outs[:4])
    return sorted(zip(k[valid].tolist(), lv[valid].tolist(),
                      rv[valid].tolist()))


@pytest.mark.parametrize("n", RANKS)
def test_distributed_join_exact(pools, n):
    rng = np.random.default_rng(11)
    lk = rng.integers(-150, 150, 256).astype(np.int64)
    rk = rng.integers(-150, 150, 256).astype(np.int64)
    lv = rng.integers(0, 1000, 256).astype(np.int64)
    rv = rng.integers(0, 1000, 256).astype(np.int64)
    want = JDJ.make_distributed_join(jmesh(n), exch_cap=128,
                                     pair_cap=2048)(lk, lv, rk, rv)
    got = pools[n].run(MR.join_rank, lk, lv, rk, rv, 128, 2048)
    for i in range(6):
        same(cat(got, i), want[i])
    assert not cat(got, 5).any()
    assert join_rows([cat(got, i) for i in range(4)]) == sorted(
        (int(a), int(b), int(c)) for a, b in zip(lk, lv)
        for a2, c in zip(rk, rv) if a == a2)


@pytest.mark.parametrize("n", RANKS)
def test_distributed_join_overflow_flag(pools, n):
    rng = np.random.default_rng(12)
    lk = rng.integers(0, 10, 128).astype(np.int64)
    vals = np.arange(128, dtype=np.int64)
    want = JDJ.make_distributed_join(jmesh(n), exch_cap=2,
                                     pair_cap=8)(lk, vals, lk, vals)
    got = pools[n].run(MR.join_rank, lk, vals, lk, vals, 2, 8)
    for i in range(6):
        same(cat(got, i), want[i])
    assert cat(got, 5).any()


@pytest.mark.parametrize("n", RANKS)
def test_distributed_join_auto_retry_in_lockstep(pools, n):
    """The collective retry grows a too-small budget on every rank
    together until the join is complete, to the capacity the JAX
    package's single controller settles on."""
    rng = np.random.default_rng(13)
    lk = rng.integers(0, 8, 128).astype(np.int64)    # heavy skew
    rk = rng.integers(0, 8, 128).astype(np.int64)
    lv = np.arange(128, dtype=np.int64)
    rv = np.arange(128, dtype=np.int64) + 1000
    jout, jcaps = JDJ.make_distributed_join_auto(
        jmesh(n), exch_cap=2, pair_cap=4, max_doublings=12)(lk, lv, rk,
                                                            rv)
    got = pools[n].run(MR.join_auto_rank, lk, lv, rk, rv, 2, 4, 12)
    caps = {tuple(r[1]) for r in got}
    assert caps == {tuple(jcaps)} and jcaps[0] > 2
    for i in range(6):
        same(np.concatenate([np.asarray(r[0][i]) for r in got]), jout[i])


def test_retry_doubles_every_rank_when_one_overflows(pools):
    got = pools[4].run(MR.lockstep_rank, 8, 6)
    for status, cap, attempts, out in got:
        assert status == "ok" and cap == 8
        assert attempts == [1, 2, 4, 8]
    # each rank keeps its own flag and outputs
    assert [bool(r[3][0][0]) for r in got] == [False] * 4
    assert [int(r[3][1][0]) for r in got] == [8, 16, 24, 32]
    # out of doublings: every rank raises at the same capacity
    got = pools[2].run(MR.lockstep_rank, 1 << 20, 2)
    assert [(r[0], r[1], r[2]) for r in got] == [
        ("exceeded", 4, [1, 2, 4])] * 2


def test_capacity_exceeded_carries_the_largest_counts(pools):
    assert pools[4].run(MR.counts_rank, 2) == [[13, 3]] * 4


# ---------------------------------------------------- hash aggregate


def jax_aggregate(n, keys, vals, buckets, cap):
    step, sharding = JQ.make_distributed_hash_aggregate(
        jmesh(n), n_parts=n, num_buckets=buckets, capacity=cap)
    return step(jax.device_put(jnp.asarray(keys), sharding),
                jax.device_put(jnp.asarray(vals), sharding))


@pytest.mark.parametrize("values", ["ones", "normal"])
@pytest.mark.parametrize("n", RANKS)
def test_distributed_hash_aggregate(pools, n, values):
    rng = np.random.default_rng(1)
    rows = 64 * n
    # negative keys reach the unsigned bucket (u64 bits mod buckets)
    keys = rng.integers(-(1 << 62), 1 << 62, rows, dtype=np.int64)
    vals = (np.ones(rows, np.float32) if values == "ones"
            else rng.normal(size=rows).astype(np.float32))
    buckets, cap = 16, 128
    jsums, jcounts, jsends = jax_aggregate(n, keys, vals, buckets, cap)
    got = pools[n].run(MR.aggregate_rank, keys, vals, buckets, cap)
    same(cat(got, 1), jcounts)
    same(cat(got, 2), jsends)
    sums = cat(got, 0)
    assert sums.dtype == np.float32
    assert int(cat(got, 1).sum()) == rows
    # the bound per bucket, from the rows that landed there
    h = np.asarray(jcounts)
    abs_sums, _ = (np.abs(np.asarray(x)) for x in jax_aggregate(
        n, keys, np.abs(vals), buckets, cap)[:2])
    bound = 2 * h * 2.0 ** -24 * abs_sums
    assert (np.abs(sums.astype(np.float64) - np.asarray(jsums))
            <= bound).all()
    if values == "ones":
        same(sums, jsums)


# -------------------------------------------------------- the pieces


@pytest.mark.parametrize("b", [1, 2, 3, 7, 16, 1000, 2**31 - 1, 2**31])
def test_urem_is_the_u64_remainder(b):
    x = np.random.default_rng(b).integers(-2**63, 2**63 - 1, 4096,
                                          dtype=np.int64)
    x[:4] = [-1, -2**63, 0, 2**63 - 1]
    want = (x.view(np.uint64) % np.uint64(b)).astype(np.int64)
    assert np.array_equal(urem(torch.from_numpy(x), b).numpy(), want)
    with pytest.raises(ValueError):
        urem(torch.from_numpy(x), 0)


def test_a_failed_rank_fails_the_call_and_closes_the_pool():
    with RankPool(2, device="cpu", timeout_s=60) as pool:
        with pytest.raises(RankFailed, match="fails on purpose") as e:
            pool.run(MR.fail_rank, 1)
        assert not e.value.retryable
        assert pool.closed
        assert all(not p.is_alive() for p in pool._procs)


@pytest.mark.parametrize("n", RANKS)
def test_an_oom_injected_on_one_rank_retries_every_rank(pools, n,
                                                        tmp_path):
    """One GpuRetryOOM at the step's attempt start on the last rank
    alone: every rank retries together (three agreements, one
    otherwise), and the outputs are the JAX package's."""
    rules = tmp_path / "rules.json"
    rules.write_text('{"faults": [{"match": "distributed_hash_aggregate",'
                     ' "repeat": 1, "exception": "GpuRetryOOM"}]}')
    rng = np.random.default_rng(2)
    keys = rng.integers(-(1 << 40), 1 << 40, 32 * n, dtype=np.int64)
    vals = np.ones(32 * n, np.float32)
    jsums, jcounts, jsends = jax_aggregate(n, keys, vals, 16, 64)
    plain = pools[n].run(MR.injected_oom_rank, keys, vals, 16, 64, -1,
                         str(rules))
    got = pools[n].run(MR.injected_oom_rank, keys, vals, 16, 64, n - 1,
                       str(rules))
    assert [r[3] for r in plain] == [1] * n
    assert [r[3] for r in got] == [3] * n
    for i, want in enumerate((jsums, jcounts, jsends)):
        same(cat(got, i), want)


def test_an_oom_inside_a_mesh_step_fails_the_call():
    """An OOM between two collectives cannot be retried by its rank
    alone (its peer waits in the next one): the call fails at once,
    marked retryable, and the pool closes."""
    keys = np.arange(64, dtype=np.int64)
    vals = np.ones(64, np.float32)
    with RankPool(2, device="cpu", timeout_s=60) as pool:
        t0 = time.monotonic()
        with pytest.raises(RankFailed,
                           match="out of memory between collectives") as e:
            pool.run(MR.oom_inside_rank, keys, vals, 16, 64, 1)
        assert time.monotonic() - t0 < 30
        assert e.value.rank == 1 and e.value.retryable
        assert pool.closed


def test_try_form_mesh_modes(monkeypatch, tmp_path):
    from spark_rapids_tpu.distributed import mesh as JM
    monkeypatch.delenv("SPARK_RAPIDS_TPU_DIST_MESH", raising=False)
    got = M.try_form_mesh(0, 2)
    assert got["mode"] == "harness" and got["backend"] is None
    assert got["detail"] == JM.try_form_mesh(0, 2)["detail"]
    monkeypatch.setenv("SPARK_RAPIDS_TPU_DIST_MESH", "auto")
    assert M.try_form_mesh(0, 2)["detail"] == "no coordinator address"
    # a group really forms (in a process of its own: this one must
    # stay without a default group), and a failed one is reported
    code = (
        "import json, sys; "
        "from spark_rapids_tpu_torch.distributed import mesh as M; "
        f"ok = M.try_form_mesh(0, 1, 'file://{tmp_path}/store', "
        "device='cpu'); M.leave_group(); "
        "bad = M.try_form_mesh(0, 1, 'nosuch://x', device='cpu'); "
        "print(json.dumps([ok, bad]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  SPARK_RAPIDS_TPU_DIST_MESH="1"),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    import json
    ok, bad = json.loads(out.strip().splitlines()[-1])
    assert ok["mode"] == "mesh" and ok["backend"] == "gloo"
    assert ok["detail"] == "1 ranks over gloo on cpu"
    assert bad["mode"] == "harness"
    assert bad["detail"].startswith("mesh init failed: ")
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_mesh_shard_and_backend_choice():
    mesh = M.Mesh(None, 1, 4, "cpu", "gloo")
    x = torch.arange(8)
    assert mesh.shard(x).tolist() == [2, 3]
    with pytest.raises(ValueError, match="split evenly"):
        mesh.shard(torch.arange(6))
    assert M.default_backend("cpu", 2) == "gloo"
    # one card at most here: two CUDA ranks share it, so gloo
    assert M.default_backend("cuda", 2) == "gloo"
    assert M.rank_device("cuda", 3).type == "cuda"
    assert M.rank_device("cpu", 3) == torch.device("cpu")


@pytest.mark.parametrize("n", RANKS)
def test_stage_fused_fn_reduces_over_the_group(pools, n):
    """CompiledStage.fused_fn(reduce_group): q5's finish stage, whose
    Reduce nodes sum the ranks' partial group tables (and any their
    overflow flags), against the JAX fused_fn under shard_map."""
    from spark_rapids_tpu.plan import catalog as JC
    from spark_rapids_tpu.plan.compiler import compile_stage as jcompile
    stores = 12
    rng = np.random.default_rng(n)
    partials = [rng.integers(-10**9, 10**9, n * stores, dtype=np.int64)
                for _ in range(3)]
    partials.append(rng.integers(0, 3, n * stores, dtype=np.int64))
    partials.append(np.arange(n) == n - 1)          # one rank overflowed
    st_id = rng.permutation(stores).astype(np.int32)
    fn = jcompile(JC.q5_finish_plan(stores)).fused_fn("data")
    want = jax.jit(shard_map(fn, mesh=jmesh(n),
                             in_specs=(P("data"),) * 5 + (P(),),
                             out_specs=(P(),) * 5))(*partials, st_id)
    got = pools[n].run(MR.stage_fused_fn_rank, stores, partials, st_id)
    for ranks_out in got:
        for g, w in zip(ranks_out, want):
            same(g, w)
    assert bool(np.asarray(want[4]).all())


def test_launched_workers_form_the_group_and_report_it(tmp_path):
    """Under SPARK_RAPIDS_TPU_DIST_MESH=1 each launched worker forms the
    gloo group at the launcher's file store, reports mesh mode with its
    backend, still moves its tables over the shuffle service, and leaves
    the group at exit."""
    from spark_rapids_tpu_torch.distributed import launcher as DL
    res = DL.launch(2, str(tmp_path), ops=("q5",), device="cpu",
                    worker_env={"SPARK_RAPIDS_TPU_STAGE_FUSION": "0"},
                    mesh="1", timeout_s=120.0)
    for s in res["summaries"]:
        assert s["rc"] == 0
        assert s["mesh"]["mode"] == "mesh", s["mesh"]
        assert s["mesh"]["backend"] == "gloo"
        assert s["link"]["frames_sent"] == s["link"]["frames_recv"] == 3


def test_the_mesh_modules_import_without_jax():
    code = ("import sys, spark_rapids_tpu_torch, "
            "spark_rapids_tpu_torch.models.distributed_join, "
            "spark_rapids_tpu_torch.distributed.dryrun, "
            "spark_rapids_tpu_torch.distributed.pool, "
            "spark_rapids_tpu_torch.shim.jni_mesh; "
            "assert 'jax' not in sys.modules; "
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'spark_rapids_tpu']")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
