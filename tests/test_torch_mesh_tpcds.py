"""PyTorch port: the TPC-DS mesh programs (models/tpcds
``make_q{5,72,3,7,9}_multichip``, ``q5_mesh_data``, ``q72_mesh_data``,
``present_q5``, ``present_q72``), the JVM door's mesh entries
(``jni_entry.flagship_q5_mesh`` / ``flagship_q72_mesh`` with
``SPARK_RAPIDS_TPU_CPU_DEVICES``, and their refusal past the allowed
ranks) and the dry run (``distributed/dryrun``), held against the JAX
package on the same seeded data.

The JAX programs run on a mesh of R of the 8 virtual CPU devices; the
port's on R gloo CPU ranks (module-scoped RankPools, R = 2 and 4), each
rank passing its shard of the fact columns.  Every output is
replicated, so every rank's must equal the JAX output byte for byte
(q5, q72 and q3 sums are exact int64; q7 and q9 averages divide exact
int64 sums in float64, the same IEEE division in both).
"""

import os

import numpy as np
import pytest
import jax
from jax.sharding import Mesh as JMesh

import torch_mesh_ranks as MR
from torch_port_data import same_outputs
from spark_rapids_tpu.models import tpcds as JT
from spark_rapids_tpu.shim import jni_entry as JJ
from spark_rapids_tpu_torch.distributed import dryrun
from spark_rapids_tpu_torch.distributed.pool import RankPool
from spark_rapids_tpu_torch.models import tpcds as TT
from spark_rapids_tpu_torch.shim import jni_entry as J
from spark_rapids_tpu_torch.shim import jni_mesh
from spark_rapids_tpu_torch.shim.errors import ShimStateError
from spark_rapids_tpu_torch.utils import platform

RANKS = (2, 4)
STORES = 16
ITEMS = 64
MAX_WEEK = 16
WEEK0 = 11_000 // 7


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


def host(arrays):
    return [np.asarray(a) for a in arrays]


def check(pool, name, arrays, params, jax_step):
    want = jax_step(*arrays)
    results = pool.run(MR.tpcds_rank, name, host(arrays), params)
    for got in results:       # replicated: every rank has the result
        same_outputs(got, want)
    return results[0]


def q5_data(n):
    rows = 4096
    d = JT.gen_q5(rows=rows, stores=STORES, days=60)
    cut = len(np.asarray(d.r_date)) // n * n
    return d._replace(r_date=d.r_date[:cut], r_store=d.r_store[:cut],
                      r_amt=d.r_amt[:cut], r_loss=d.r_loss[:cut])


@pytest.mark.parametrize("n", RANKS)
def test_q5_multichip(pools, n):
    d = q5_data(n)
    got = check(pools[n], "q5", d,
                dict(stores=STORES, join_capacity=1 << 11),
                JT.make_q5_multichip(jmesh(n), STORES,
                                     join_capacity=1 << 11))
    live = got[0] != 2**31 - 1
    assert [tuple(int(x) for x in r) for r in zip(
        got[0][live], got[1][live], got[2][live], got[3][live])] == \
        JT.oracle_q5(d, STORES)


@pytest.mark.parametrize("n", RANKS)
def test_q72_multichip(pools, n):
    d = JT.gen_q72(cs_rows=2048, inv_rows=2048, items=ITEMS, days=35)
    check(pools[n], "q72", d,
          dict(items=ITEMS, max_week=MAX_WEEK, join_capacity=1 << 16,
               week0=WEEK0),
          JT.make_q72_multichip(jmesh(n), ITEMS, MAX_WEEK,
                                join_capacity=1 << 16, week0=WEEK0))


@pytest.mark.parametrize("n", RANKS)
def test_q72_multichip_overflow_flag(pools, n):
    """A join capacity too small on some rank: every rank's replicated
    flag says so, as the JAX psum'd flag does."""
    d = JT.gen_q72(cs_rows=1024, inv_rows=1024, items=8, days=35)
    got = check(pools[n], "q72", d,
                dict(items=8, max_week=MAX_WEEK, join_capacity=64,
                     week0=WEEK0),
                JT.make_q72_multichip(jmesh(n), 8, MAX_WEEK,
                                      join_capacity=64, week0=WEEK0))
    assert bool(got[3])


@pytest.mark.parametrize("n", RANKS)
def test_q3_multichip(pools, n):
    base = 10_957
    d = JT.gen_q3(rows=4096, items=64, days=730, brands=8)
    check(pools[n], "q3", d,
          dict(base=base, years=3, brands=8, manufact=2),
          JT.make_q3_multichip(jmesh(n), base, years=3, brands=8,
                               manufact=2))


@pytest.mark.parametrize("n", RANKS)
def test_q7_multichip(pools, n):
    d = JT.gen_q7(rows=4096, items=32)
    check(pools[n], "q7", d, dict(items=32),
          JT.make_q7_multichip(jmesh(n), 32))


@pytest.mark.parametrize("n", RANKS)
def test_q9_multichip(pools, n):
    q = JT.gen_q9(rows=4096)
    check(pools[n], "q9", q, {}, JT.make_q9_multichip(jmesh(n)))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_mesh_data_and_presenters(n):
    for ours, ref in (
            (TT.q5_mesh_data(1001, 6, n, device="cpu"),
             JT.q5_mesh_data(1001, 6, n)),
            (TT.q72_mesh_data(999, 12, n, device="cpu"),
             JT.q72_mesh_data(999, 12, n))):
        same_outputs([x.numpy() for x in ours], host(ref))
    d = JT.q5_mesh_data(512, 6, n)
    outs = JT.make_q5(6, join_capacity=1 << 12)(d)
    names = [f"store_{i}" for i in range(6)]
    assert TT.present_q5(outs, names) == JT.present_q5(outs, names)
    d = JT.q72_mesh_data(512, 12, n)
    outs = JT.make_q72(12, MAX_WEEK, join_capacity=1 << 12,
                       week0=WEEK0)(d)
    names = [f"item_{i}" for i in range(12)]
    assert TT.present_q72(outs, names) == JT.present_q72(outs, names)
    assert TT.present_q72(outs, names)


# ------------------------------------------------- the JVM door's entries


@pytest.fixture
def cpu_entries(monkeypatch):
    """The door initialized on the CPU with four CPU ranks allowed;
    afterwards its pools stopped and its state as it was."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CPU_DEVICES", "4")
    J._INITIALIZED = False
    J.initialize()
    try:
        yield J
    finally:
        jni_mesh.stop_pools()
        J._INITIALIZED = False
        platform.set_entry_device("cuda")
        platform.set_mesh_cpu_ranks(1)


def test_mesh_entries_equal_the_jax_entries(cpu_entries):
    """The slice as a whole: the port's JVM mesh entries return the JAX
    entries' lists on the same arguments, and a second call reuses the
    started ranks."""
    for n in (4, 2):
        assert J.flagship_q5_mesh(n, 256, 6) == JJ.flagship_q5_mesh(
            n, 256, 6)
        assert J.flagship_q72_mesh(n, 192, 12) == JJ.flagship_q72_mesh(
            n, 192, 12)
    pids = {p.pid for pool in jni_mesh._POOLS.values()
            for p in pool._procs}
    assert len(pids) == 6
    gold = []
    for row in JT.oracle_q5(JT.q5_mesh_data(600, 5, 4), 5):
        gold.extend(int(x) for x in row)
    assert J.flagship_q5_mesh(4, 600, 5) == gold
    assert {p.pid for pool in jni_mesh._POOLS.values()
            for p in pool._procs} == pids
    assert jni_mesh.LAST_CALL["backend"] == "gloo"
    assert len(jni_mesh.LAST_CALL["ranks"]) == 4


def test_mesh_entry_learns_its_join_capacity(cpu_entries):
    """Past the JAX entries' fixed 4096 join pairs the ranks double
    together (the JAX entry raises there) and keep what they learned."""
    flat = J.flagship_q5_mesh(2, 40_000, 6)
    gold = []
    for row in JT.oracle_q5(JT.q5_mesh_data(40_000, 6, 2), 6):
        gold.extend(int(x) for x in row)
    assert flat == gold
    first = jni_mesh.LAST_CALL["ranks"]
    assert {r["doublings"] for r in first} == {1}
    assert {r["capacity"] for r in first} == {1 << 13}
    assert J.flagship_q5_mesh(2, 40_000, 6) == gold
    assert {r["doublings"] for r in jni_mesh.LAST_CALL["ranks"]} == {0}
    with pytest.raises(Exception, match="q5 mesh overflow"):
        JJ.flagship_q5_mesh(2, 40_000, 6)


def test_mesh_entries_refuse_more_ranks_than_allowed(cpu_entries,
                                                     monkeypatch):
    with pytest.raises(ShimStateError, match="mesh wants 5 devices, "
                                             "backend has 4"):
        J.flagship_q5_mesh(5, 256, 6)
    with pytest.raises(ShimStateError, match="mesh wants 8 devices"):
        J.flagship_q72_mesh(8, 192, 12)
    assert not jni_mesh._POOLS
    # without SPARK_RAPIDS_TPU_CPU_DEVICES one CPU rank, like JAX's one
    # CPU device
    J._INITIALIZED = False
    platform.set_mesh_cpu_ranks(1)
    monkeypatch.delenv("SPARK_RAPIDS_TPU_CPU_DEVICES")
    J.initialize()
    with pytest.raises(ShimStateError, match="backend has 1"):
        J.flagship_q5_mesh(2, 256, 6)
    J._INITIALIZED = False
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CPU_DEVICES", "four")
    with pytest.raises(ValueError):
        J.initialize()


def test_an_oom_inside_a_rank_reruns_the_entry_on_fresh_ranks(
        cpu_entries, tmp_path):
    """A rank that runs out of memory inside its step fails its pool;
    the entry runs the whole call again on new ranks."""
    mark = str(tmp_path / "failed_once")
    assert jni_mesh.run_entry(2, MR.oom_once_rank, mark) == [2]
    assert os.path.exists(mark)
    pools = list(jni_mesh._POOLS.values())
    assert len(pools) == 1 and not pools[0].closed
    assert [r["rank"] for r in jni_mesh.LAST_CALL["ranks"]] == [0, 1]


def test_shutdown_stops_the_mesh_pools(cpu_entries):
    assert J.flagship_q72_mesh(2, 192, 12) == JJ.flagship_q72_mesh(
        2, 192, 12)
    pools = list(jni_mesh._POOLS.values())
    J.shutdown()
    assert not jni_mesh._POOLS
    assert all(p.closed and not any(q.is_alive() for q in p._procs)
               for p in pools)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_dryrun_at_four_ranks():
    got = dryrun.dryrun(4)
    assert got["ranks"] == 4 and got["aggregate_rows"] == 64
    assert got["join_pairs"] == len(dryrun.host_join(
        *_dryrun_join_inputs()))


def _dryrun_join_inputs():
    rng = np.random.default_rng(0)
    rng.integers(0, 1000, 64, dtype=np.int64)
    lk = rng.integers(0, 50, 32, dtype=np.int64)
    rk = rng.integers(0, 50, 32, dtype=np.int64)
    return lk, np.arange(32), rk, np.arange(32) + 1000
