"""PyTorch port: the tiered spill store (memory/spill.py), the
out-of-core join and group-by (ops/out_of_core.py), the stage over
spilled partitions (plan/compiler.CompiledStage.run_spilled), the kudo
merger under a forced split, the capacity retry under a RetryPolicy,
HostTable and the JNI door's spill entries — held against the JAX
package's on the same seeded host arrays, on CPU tensors.

Victim order, ensure_headroom, pins, host-to-disk demotion, corrupt
spill files (recompute from source, or an error naming the file and
the spill generation) and the restore/close race follow
tests/test_spill.py; the spilled bytes, ``columns_nbytes`` and the
partition counts equal the JAX store's; out-of-core results at 4x over
budget equal the JAX package's and the port's in-memory calls byte for
byte.  ``SPARK_RAPIDS_TPU_FORCE_DEVICE_SHUFFLE=1`` sends CPU batches
through the path a CUDA batch takes (the device split's blob and the
device assemble)."""

import json
import os
import threading
import time

os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from spark_rapids_tpu.memory import spill as JS  # noqa: E402
from spark_rapids_tpu.ops import out_of_core as JO  # noqa: E402
from spark_rapids_tpu.shim import jni_api as jjni  # noqa: E402
from spark_rapids_tpu_torch.columns import dtypes  # noqa: E402
from spark_rapids_tpu_torch.columns.column import Column  # noqa: E402
from spark_rapids_tpu_torch.columns.table import Table  # noqa: E402
from spark_rapids_tpu_torch.memory import exceptions as pexc  # noqa: E402
from spark_rapids_tpu_torch.memory import rmm_spark  # noqa: E402
from spark_rapids_tpu_torch.memory import spill as PS  # noqa: E402
from spark_rapids_tpu_torch.memory.spill import (  # noqa: E402
    TIER_DEVICE, TIER_DISK, TIER_FREED, TIER_HOST, SpillStore)
from spark_rapids_tpu_torch.ops import groupby as PG  # noqa: E402
from spark_rapids_tpu_torch.ops import joins as PJ  # noqa: E402
from spark_rapids_tpu_torch.ops import out_of_core as PO  # noqa: E402
from spark_rapids_tpu_torch.robustness import retry as PR  # noqa: E402
from spark_rapids_tpu_torch.shim import jni_api  # noqa: E402
from spark_rapids_tpu_torch.shuffle import kudo as K  # noqa: E402
from torch_port_data import (host_column, host_strings,  # noqa: E402
                             jax_table, nested_specs, port_table,
                             table_parts)

FORCE = "SPARK_RAPIDS_TPU_FORCE_DEVICE_SHUFFLE"


@pytest.fixture(autouse=True)
def _fresh_router(tmp_path, monkeypatch):
    """The join router unpinned, with a throwaway verdict file."""
    from spark_rapids_tpu.perf import calibrate as JCAL
    from spark_rapids_tpu_torch.perf import calibrate as CAL
    monkeypatch.delenv("SPARK_RAPIDS_TPU_PATH_JOIN_INNER", raising=False)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CALIB_CACHE",
                       str(tmp_path / "calib.json"))
    CAL.forget()
    JCAL.forget()


@pytest.fixture(params=["host", "device"])
def path(request, monkeypatch):
    """The host writer and merger, or the device split and assemble
    (the path a CUDA batch takes), on CPU tensors."""
    monkeypatch.setenv(FORCE, "1" if request.param == "device" else "0")
    return request.param


def every_kind_specs(seed, rows=41):
    rng = np.random.default_rng(seed)
    flat = [host_column(rng, k, rows, nullable=i % 2 == 0)
            for i, k in enumerate(["int64", "int32", "float64", "float32",
                                   "int8", "bool8", "uint64",
                                   "decimal128", "string"])]
    return flat + nested_specs(rng, rows, skew=2)


def small_cols(v=1):
    return [Column.from_pylist([v, v + 1, None], dtypes.INT64,
                               device="cpu")]


def same_cols(got, want):
    assert table_parts(Table(list(got))) == table_parts(Table(list(want)))


class StubAdaptor:
    """The memory_ledger + spill-range surface the store touches."""

    def __init__(self, resident):
        self.resident = dict(resident)
        self.freed = 0
        self.acquired = 0

    def memory_ledger(self, timeline=0):
        return {"allocated_bytes": sum(self.resident.values()),
                "tasks": {str(t): {"active_bytes": b}
                          for t, b in self.resident.items()}}

    def spill_range_start(self):
        pass

    def spill_range_done(self):
        pass

    def deallocate(self, n):
        self.freed += n

    def allocate(self, n):
        self.acquired += n


# ------------------------------------------------------ bytes and sizes


@pytest.mark.parametrize("seed", [1, 2])
def test_columns_nbytes_matches_reference(seed):
    specs = every_kind_specs(seed)
    assert PS.columns_nbytes(port_table(specs).columns) == \
        JS.columns_nbytes(jax_table(specs).columns)


@pytest.mark.parametrize("nbytes,budget,parts",
                         [(1000, 250, None), (1000, 126, None),
                          (10**9, 10**6, None), (5, 10, None),
                          (1000, 10, 3), (1000, 10, 200)])
def test_partition_count_matches_reference(nbytes, budget, parts):
    assert PO._partition_count(nbytes, budget, parts) == \
        JO._partition_count(nbytes, budget, parts)


def test_budget_knobs_match_reference(monkeypatch):
    for raw in ("", "12345", "junk"):
        monkeypatch.setenv("SPARK_RAPIDS_TPU_DEVICE_BUDGET_BYTES", raw)
        assert PS.device_budget_bytes() == JS.device_budget_bytes()
    monkeypatch.setenv("SPARK_RAPIDS_TPU_SPILL_PARTITIONS", "5")
    assert PO._partition_count(10, 1, None) == \
        JO._partition_count(10, 1, None) == 8
    monkeypatch.setenv("SPARK_RAPIDS_TPU_SPILL_HOST_LIMIT_BYTES", "77")
    assert SpillStore().host_limit_bytes() == 77


@pytest.mark.parametrize("seed", [3, 4])
def test_spilled_bytes_match_reference(seed, path, tmp_path):
    specs = every_kind_specs(seed)
    jstore = JS.SpillStore(spill_dir=str(tmp_path / "j"),
                           host_limit_bytes=0)
    pstore = SpillStore(spill_dir=str(tmp_path / "p"))
    jh = jstore.register(jax_table(specs).columns, name="t")
    table = port_table(specs)
    ph = pstore.register(table.columns, name="t")
    jh.spill()
    assert ph.spill() == PS.columns_nbytes(table.columns)
    assert ph.tier == TIER_HOST and ph.columns is None
    with open(jh.path, "rb") as f:
        want = f.read()
    assert bytes(ph.payload) == want
    # demoted to disk, the file holds the same bytes
    pstore._host_limit = 0
    pstore._enforce_host_limit()
    assert ph.tier == TIER_DISK
    with open(ph.path, "rb") as f:
        assert f.read() == want
    assert os.path.basename(ph.path) == os.path.basename(jh.path)
    got = ph.get()
    # the kudo round trip rebases sliced offsets: the columns come back
    # as the JAX store gives them back
    from spark_rapids_tpu.columns.table import Table as JTable
    assert table_parts(Table(got)) == table_parts(JTable(jh.get()))
    assert all(c.device == table.device for c in got)
    assert ph.tier == TIER_DEVICE and ph.path is None
    jstore.close()
    pstore.close()


def test_host_table_round_trip_matches_reference():
    from spark_rapids_tpu.memory.host_table import HostTable as JHT
    from spark_rapids_tpu_torch.memory.host_table import HostTable
    rng = np.random.default_rng(12)
    specs = [host_column(rng, k, 37, nullable=True)
             for k in ("int64", "float64", "decimal128", "string")]
    specs += nested_specs(rng, 37)
    pt = port_table(specs)
    pt.names = [f"c{i}" for i in range(len(specs))]
    ht = HostTable.from_table(pt)
    assert ht.buffer == JHT.from_table(jax_table(specs)).buffer
    back = ht.to_table()
    assert table_parts(back) == table_parts(pt)
    assert back.names == pt.names and back.device == pt.device


# ------------------------------------------------------ victims and pins


def test_victims_follow_priority_then_ledger(tmp_path):
    orders = []
    for mod, cols in ((JS, lambda: []), (PS, small_cols)):
        store = mod.SpillStore(spill_dir=str(tmp_path))
        stub = StubAdaptor({1: 100, 2: 500})
        store._adaptor = lambda stub=stub: stub
        hs = [store.register(cols(), device_bytes=b, name=n, task_id=t)
              for n, b, t in (("pool", 64, None), ("t1", 100, 1),
                              ("t2a", 50, 2), ("t2b", 200, 2))]
        order = [[h.name for h in store._victims()],
                 store.spillable_bytes()]
        hs[1]._priority = -1
        order.append(store._victims()[0].name)
        hs[1]._priority = None
        order.append(store.ensure_headroom(1))
        order.append(store.ensure_headroom(1 << 40))
        order.append(stub.freed)
        order.append(store.stats()["spills_host"])
        orders.append(order)
        store.close()
    assert orders[1] == orders[0]
    assert orders[1] == [["t2b", "t2a", "t1", "pool"], 414, "t1", 200,
                         214, 414, 4]


def test_pinned_handles_are_not_victims(tmp_path):
    store = SpillStore(spill_dir=str(tmp_path))
    stub = StubAdaptor({2: 500})
    store._adaptor = lambda: stub
    h1 = store.register(small_cols(), device_bytes=100, name="a",
                        task_id=2)
    h2 = store.register(small_cols(), device_bytes=50, name="b", task_id=2)
    with h1.pin() as cols:
        assert cols is h1.columns
        assert [h.name for h in store._victims()] == ["b"]
        assert store.spillable_bytes() == 50
        assert store.stats()["spillable_bytes"] == 50
        assert store.ensure_headroom(1 << 40) == 50
        assert h1.tier == TIER_DEVICE and h2.tier == TIER_HOST
        assert h1.spill() == 0
    assert h1.pins == 0
    assert store.ensure_headroom(1 << 40) == 100
    assert h1.tier == TIER_HOST
    with h1.pin() as cols:
        same_cols(cols, small_cols())
        assert h1.tier == TIER_DEVICE and h1.pins == 1
        assert stub.acquired == 100
    store.close()


def test_oldest_host_payload_demotes_first(tmp_path, path):
    store = SpillStore(spill_dir=str(tmp_path))
    h1 = store.register(small_cols(1), name="first")
    h2 = store.register(small_cols(9), name="second")
    h1.spill()
    payload_len = store._host_bytes
    assert payload_len > 0 and h1.tier == TIER_HOST
    store._host_limit = payload_len
    h2.spill()
    assert h1.tier == TIER_DISK and h2.tier == TIER_HOST
    assert h1.path.endswith("first.g1.kudo") and os.path.exists(h1.path)
    st = store.stats()
    assert st["spills_host"] == 2 and st["spills_disk"] == 1
    assert st["tiers"][TIER_HOST]["bytes"] == payload_len
    assert st["tiers"][TIER_DISK]["bytes"] == payload_len
    same_cols(h1.get(), small_cols(1))
    assert h1.tier == TIER_DEVICE and h1.path is None
    assert store.stats()["restores"] == 1
    assert store.stats()["tiers"][TIER_DISK]["bytes"] == 0
    store.close()
    assert store.stats()["handles"] == 0 and store._host_bytes == 0


# -------------------------------------------------------- corrupt files


def flip(path, at=40):
    with open(path, "r+b") as f:
        f.seek(at)
        raw = f.read(4)
        f.seek(at)
        f.write(bytes(b ^ 0xFF for b in raw))


def to_disk(tmp_path, cols, recompute=None):
    store = SpillStore(spill_dir=str(tmp_path), host_limit_bytes=0)
    h = store.register(list(cols), name="t", recompute=recompute)
    h.spill()
    assert h.tier == TIER_DISK and os.path.exists(h.path)
    return store, h


def test_corrupt_file_recomputes_from_source(tmp_path, path):
    cols = small_cols(5)
    store, h = to_disk(tmp_path, cols, recompute=lambda: list(cols))
    flip(h.path)
    same_cols(h.get(), cols)
    st = store.stats()
    assert st["corrupt"] == 1 and st["recomputes"] == 1
    store.close()


def test_corrupt_file_without_recompute_names_file(tmp_path, path):
    store, h = to_disk(tmp_path, small_cols(5))
    file = h.path
    flip(file)
    with pytest.raises(K.KudoCorruptException) as ei:
        h.get()
    assert ei.value.path == file and ei.value.generation == 1
    assert file in str(ei.value) and "generation 1" in str(ei.value)
    assert store.stats()["corrupt"] == 1
    # the JAX store names the same file and generation for the same bytes
    jstore = JS.SpillStore(spill_dir=str(tmp_path / "j"),
                           host_limit_bytes=0)
    jh = jstore.register(jax_table([("int64", np.array([5, 6, 0]),
                                     np.array([1, 1, 0], np.uint8))]
                                   ).columns, name="t")
    jh.spill()
    flip(jh.path)
    with pytest.raises(Exception) as jei:
        jh.get()
    assert str(jei.value).replace(jh.path, file) == str(ei.value)
    jstore.close()
    store.close()


def test_ooc_partition_recompute_regathers_from_source(tmp_path):
    """A corrupt spilled partition of an out-of-core join recomputes by
    re-gathering the caller's table at the partition's row indices."""
    left, right = join_tables(600, 300, 50)
    store = SpillStore(spill_dir=str(tmp_path), host_limit_bytes=0)
    lw, rw, *_ = __import__(
        "spark_rapids_tpu_torch.ops.hash_join",
        fromlist=["x"]).join_key_words(left, right, PJ.NULL_EQUAL)
    rows = PO.partition_rows(rw, 4)
    handles = PO._spill_partitions(store, right, rows, "ooc_join")
    assert [h.tier for h in handles] == [TIER_DISK] * 4
    for h in handles:
        flip(h.path, 30)
    for h, ix in zip(handles, rows):
        same_cols(h.get(), PO.gather_table(right, ix).columns)
    assert store.stats()["recomputes"] == 4
    store.close()


# ------------------------------------------------------- close race


def slow_restore(store):
    in_restore = threading.Event()
    orig = store._deserialize

    def slow(*a, **kw):
        in_restore.set()
        time.sleep(0.05)
        return orig(*a, **kw)

    store._deserialize = slow
    return in_restore


def race_close(h, in_restore):
    out = {}

    def reader():
        try:
            out["cols"] = h.get()
        except BaseException as e:  # noqa: BLE001
            out["error"] = e

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    assert in_restore.wait(timeout=10)
    h.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert "error" not in out, out.get("error")
    return out["cols"]


def test_restore_close_race_reader_wins_nothing_leaks(tmp_path, path):
    cols = small_cols(3)
    store = SpillStore(spill_dir=str(tmp_path), host_limit_bytes=0)
    h = store.register(list(cols), name="raced")
    h.spill()
    file = h.path
    got = race_close(h, slow_restore(store))
    same_cols(got, cols)
    assert h.closed and h.tier == TIER_FREED
    assert store._handles == {}
    assert store._host_bytes == 0 and store._disk_bytes == 0
    assert not os.path.exists(file)
    store.close()


def test_deferred_release_runs_outside_store_lock(tmp_path):
    store = SpillStore(spill_dir=str(tmp_path), host_limit_bytes=0)
    lock_free = []

    class Ad(StubAdaptor):
        def deallocate(self, n):
            got = {}

            def probe():
                got["ok"] = store._lock.acquire(timeout=5)
                if got["ok"]:
                    store._lock.release()

            t = threading.Thread(target=probe)
            t.start()
            t.join(10)
            lock_free.append(bool(got.get("ok")))

    stub = Ad({})
    store._adaptor = lambda: stub
    h = store.register(small_cols(3), name="raced2")
    h.spill()
    race_close(h, slow_restore(store))
    assert len(lock_free) == 2 and all(lock_free)
    assert h.tier == TIER_FREED
    store.close()


# -------------------------------------------------------- out of core


def join_tables(nl=4000, nr=2000, nkeys=600, seed=7, two_keys=False):
    rng = np.random.default_rng(seed)
    specs = []
    for n in (nl, nr):
        k = rng.integers(0, nkeys, n).astype(np.int64)
        v = (rng.random(n) >= 0.05).astype(np.uint8)
        side = [("int64", k, v)]
        if two_keys:
            side.append(("int32", (k % 7).astype(np.int32), None))
        specs.append(side)
    return port_table(specs[0]), port_table(specs[1])


def jax_of(table):
    from spark_rapids_tpu_torch.columns import interop
    return jax_table(interop.table_to_host(table))


@pytest.mark.parametrize("nulls", ["equal", "unequal"])
@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("two_keys", [False, True])
def test_join_at_4x_over_budget_matches_reference(nulls, tier, two_keys,
                                                  path, tmp_path):
    left, right = join_tables(two_keys=two_keys)
    cmp = {"equal": PJ.NULL_EQUAL, "unequal": PJ.NULL_UNEQUAL}[nulls]
    budget = PS.columns_nbytes(right.columns) // 4
    limit = 0 if tier == "disk" else None
    store = SpillStore(spill_dir=str(tmp_path), host_limit_bytes=limit)
    got_l, got_r = PO.out_of_core_hash_join(left, right, cmp,
                                            budget=budget, store=store)
    want_l, want_r = PJ.hash_inner_join(left, right, cmp)
    assert torch.equal(got_l, want_l) and torch.equal(got_r, want_r)
    assert got_l.dtype == torch.int32 and len(got_l) > 0
    ref_l, ref_r = JO.out_of_core_hash_join(
        jax_of(left), jax_of(right), cmp, budget=budget,
        store=JS.SpillStore(spill_dir=str(tmp_path / "j")))
    assert got_l.numpy().tobytes() == np.asarray(ref_l).tobytes()
    assert got_r.numpy().tobytes() == np.asarray(ref_r).tobytes()
    st = store.stats()
    assert st["spills_host"] == 4 and st["restores"] == 4
    assert st["spills_disk"] == (4 if tier == "disk" else 0)
    assert st["handles"] == 0
    assert not [f for f in os.listdir(str(tmp_path)) if f.endswith(".kudo")]
    store.close()


def test_join_disabled_and_under_budget_paths_are_direct(tmp_path):
    left, right = join_tables(64, 32, 8)
    want = PJ.hash_inner_join(left, right, PJ.NULL_EQUAL)
    store = SpillStore(spill_dir=str(tmp_path))
    for budget in (None, 1 << 30):
        got = PO.out_of_core_hash_join(left, right, PJ.NULL_EQUAL,
                                       budget=budget, store=store)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert store.stats()["spills_host"] == 0


def test_join_with_no_matches(tmp_path):
    left = port_table([("int64", np.arange(100, dtype=np.int64), None)])
    right = port_table([("int64", np.arange(1000, 1400, dtype=np.int64),
                         None)])
    li, ri = PO.out_of_core_hash_join(
        left, right, budget=100, store=SpillStore(spill_dir=str(tmp_path)))
    assert li.shape == (0,) and ri.shape == (0,) and li.dtype == torch.int32


GROUP_AGGS = ["sum", "count", "min", "max", "mean"]


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_groupby_at_4x_over_budget_matches_reference(tier, path,
                                                     tmp_path):
    rng = np.random.default_rng(11)
    n, ngroups = 6000, 500
    keys = [("int64", rng.integers(0, ngroups, n).astype(np.int64), None),
            ("int32", rng.integers(0, 3, n).astype(np.int32),
             (rng.random(n) >= 0.1).astype(np.uint8))]
    vals = [("float64", rng.standard_normal(n).view(np.uint64).copy(),
             (rng.random(n) >= 0.07).astype(np.uint8)),
            ("int32", rng.integers(-50, 50, n).astype(np.int32), None),
            host_column(rng, "int64", n, nullable=True),
            ("float64", rng.standard_normal(n).view(np.uint64).copy(),
             None),
            host_column(rng, "int16", n, nullable=True)]
    pk, pv = port_table(keys), port_table(vals)
    pk.names = ["k", "j"]
    budget = PS.columns_nbytes(list(pk.columns) + list(pv.columns)) // 4
    store = SpillStore(spill_dir=str(tmp_path),
                       host_limit_bytes=0 if tier == "disk" else None)
    got = PO.out_of_core_groupby(pk, pv.columns, GROUP_AGGS,
                                 budget=budget, store=store)
    want = PG.groupby_aggregate(pk, pv.columns, GROUP_AGGS)
    assert table_parts(got) == table_parts(want)
    assert got.names == want.names == ["k", "j"] + [
        f"agg{i}" for i in range(5)]
    jk = jax_table(keys)
    jk.names = ["k", "j"]
    ref = JO.out_of_core_groupby(
        jk, jax_table(vals).columns, GROUP_AGGS, budget=budget,
        store=JS.SpillStore(spill_dir=str(tmp_path / "j")))
    assert table_parts(got) == table_parts(ref)
    st = store.stats()
    assert st["spills_host"] == 4 and st["restores"] == 4
    assert st["handles"] == 0
    store.close()


def test_groupby_string_keys_take_the_direct_path(tmp_path):
    """Keys without a word encoding would have no partition hash: the
    reference runs them in one pass, and so does the port."""
    rng = np.random.default_rng(5)
    keys = [host_strings(rng, 300, max_len=4)]
    vals = [("int64", rng.integers(0, 9, 300).astype(np.int64), None)]
    pk, pv = port_table(keys), port_table(vals)
    got = PO.out_of_core_groupby(pk, pv.columns, ["sum"], budget=10,
                                 store=SpillStore(spill_dir=str(tmp_path)))
    ref = JO.out_of_core_groupby(jax_table(keys), jax_table(vals).columns,
                                 ["sum"], budget=10,
                                 store=JS.SpillStore(
                                     spill_dir=str(tmp_path / "j")))
    assert table_parts(got) == table_parts(ref)


# --------------------------------------------- spill under a real OOM


def test_alloc_failure_spills_before_bufn(tmp_path):
    """A task thread holds 800 of 1000 bytes through a registered
    spillable batch; an injected GpuRetryOOM and a real over-limit
    reservation both resolve through the retry loop WITHOUT shedding:
    the adaptor's alloc-failure path calls ensure_headroom, the store
    spills the batch, and the retried reservation lands."""
    ad = rmm_spark.set_event_handler(1000)
    store = PS.install(SpillStore(spill_dir=str(tmp_path)))
    out = {}

    def worker():
        try:
            tid = rmm_spark.current_thread_id()
            rmm_spark.start_dedicated_task_thread(tid, 7)
            ad.allocate(800)
            h = store.register(small_cols(), device_bytes=800, name="big",
                               task_id=7, stage="oom-test")
            rmm_spark.force_retry_oom(tid, 1)

            def attempt():
                PR.check_injected_oom("spill-oom")
                ad.allocate(600)
                return "ok"

            out["result"] = PR.with_retry(attempt, name="spill-oom")
            out["state"] = ad.get_state_of(tid)
            out["tier"] = h.tier
            ad.deallocate(600)
            h.close()
            rmm_spark.task_done(7)
        except BaseException as e:  # noqa: BLE001
            out["error"] = e

    try:
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "spill rescue deadlocked"
        assert "error" not in out, out.get("error")
        assert out["result"] == "ok" and out["tier"] == TIER_HOST
        assert store.stats()["spills_host"] == 1
        assert "RUNNING" in out["state"]
        assert ad.resource.used == 0
    finally:
        PS.uninstall()
        rmm_spark.clear_event_handler()


def test_split_floor_carries_ledger_evidence():
    from spark_rapids_tpu.memory import rmm_spark as jrmm
    from spark_rapids_tpu.robustness import retry as JR
    evidence = []
    for rmm, R, exc in ((jrmm, JR, __import__(
            "spark_rapids_tpu.memory.exceptions", fromlist=["x"])),
            (rmm_spark, PR, pexc)):
        ad = rmm.set_event_handler(1 << 20)
        try:
            out = {}

            def body():
                rmm.current_thread_is_dedicated_to_task(4)
                ad.allocate(4096)

                def boom(part):
                    raise exc.GpuSplitAndRetryOOM("will not fit")

                try:
                    R.split_and_retry(boom, [1, 2], name="floor",
                                      policy=R.RetryPolicy(
                                          base_backoff_s=0, jitter=False))
                except R.SplitFloorReached as e:
                    out["e"] = (e.reason, e.resident_bytes, str(e))
                ad.deallocate(4096)
                rmm.task_done(4)

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(10)
            assert not t.is_alive()
            evidence.append(out["e"])
        finally:
            rmm.clear_event_handler()
    assert evidence[1] == evidence[0]
    assert evidence[1][1] == {"4": 4096, "__total__": 4096}


# ------------------------------------------- stage over spilled inputs


def seg_plan(name):
    from spark_rapids_tpu_torch.plan import ir
    return ir.StagePlan(
        name=name,
        inputs=(ir.ScanBind("f", (ir.ColSpec("k"), ir.ColSpec("v"))),),
        nodes=(
            ir.Project("keep", ir.Bin(
                "and", ir.Mask("f"),
                ir.Bin("gt", ir.Col("v"), ir.Lit(0)))),
            ir.Project("w", ir.Where(ir.Col("keep"), ir.Col("v"),
                                     ir.Lit(0, "int64"))),
            ir.SegmentSum("sums", ir.Col("w"), ir.Col("k"), 16),
        ),
        outputs=("sums",)).validate()


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_run_spilled_equals_run(fusion, monkeypatch, tmp_path):
    from spark_rapids_tpu.plan import compiler as JPC
    from spark_rapids_tpu.plan import ir as JIR
    from spark_rapids_tpu_torch.plan import compiler as PC
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", fusion)
    rng = np.random.default_rng(3)
    n = 256                                  # same rows -> same bucket
    arrs = [rng.integers(lo, hi, n).astype(np.int64)
            for lo, hi in ((0, 16), (-5, 50), (0, 16), (-5, 50))]
    k0, v0, k1, v1 = (torch.from_numpy(a) for a in arrs)
    cs = PC.compile_stage(seg_plan(f"t_spill_seg_{fusion}"))
    store = SpillStore(spill_dir=str(tmp_path))
    h = store.register([Column(dtypes.INT64, n, data=k0),
                        Column(dtypes.INT64, n, data=v0)], name="p0")
    h.spill()
    (out0,) = cs.run_spilled([{"f": h}])
    compiles = cs.compiles
    (out1,) = cs.run_spilled([{"f": (k1, v1)}])
    assert cs.compiles == compiles            # no recompile
    assert store.stats()["restores"] == 1
    assert h.tier == TIER_DEVICE and h.pins == 0
    assert torch.equal(out0[0], cs.run({"f": (k0, v0)})[0])
    assert torch.equal(out1[0], cs.run({"f": (k1, v1)})[0])
    if fusion == "1":
        assert cs.compiles == 1
    # the JAX package's stage gives the same sums
    jplan = JIR.StagePlan(
        name=f"t_spill_seg_{fusion}",
        inputs=(JIR.ScanBind("f", (JIR.ColSpec("k"),
                                   JIR.ColSpec("v"))),),
        nodes=(JIR.Project("keep", JIR.Bin(
            "and", JIR.Mask("f"),
            JIR.Bin("gt", JIR.Col("v"), JIR.Lit(0)))),
            JIR.Project("w", JIR.Where(JIR.Col("keep"), JIR.Col("v"),
                                       JIR.Lit(0, "int64"))),
            JIR.SegmentSum("sums", JIR.Col("w"), JIR.Col("k"), 16)),
        outputs=("sums",)).validate()
    want = JPC.compile_stage(jplan).run({"f": (arrs[0], arrs[1])})
    assert out0[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    h.close()
    store.close()


def test_q5_over_spilled_partitions_equals_single_pass(monkeypatch,
                                                       tmp_path):
    """chip_smoke's memory phase in small: q5's facts hash-partitioned
    by store into 4 spilled partitions, q5_partials per partition
    through run_spilled, the partials summed and q5_finish run: byte
    for byte the single pass."""
    import chip_smoke as C
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    res = C.q5_spilled(dict(rows=4000, stores=12, days=60, seed=5),
                       capacity=1 << 12, parts=4, device="cpu",
                       store=SpillStore(spill_dir=str(tmp_path)),
                       iters=1)
    assert res["partitions"] == 4 and res["spills_host"] == 8


# ------------------------------------------------- kudo merge under split


def test_kudo_merge_under_forced_split_equals_unsplit():
    import io
    from spark_rapids_tpu_torch.shuffle.schema import schema_of_table
    specs = every_kind_specs(9, rows=40)
    table = port_table(specs)
    kts = []
    for lo in (0, 10, 20, 30):
        b = io.BytesIO()
        K.write_to_stream(table.columns, b, lo, 10)
        b.seek(0)
        kts.append(K.read_one_table(b))
    fields = schema_of_table(table)
    want = K.merge_to_table(kts, fields, device="cpu")
    rmm_spark.set_event_handler(1 << 20)
    out = {}

    def body():
        rmm_spark.current_thread_is_dedicated_to_task(21)
        rmm_spark.force_split_and_retry_oom(rmm_spark.current_thread_id(),
                                            1)
        out["t"] = K.merge_to_table(kts, fields, device="cpu")
        out["splits"] = rmm_spark.get_adaptor() \
            .get_and_reset_num_split_retry_throw(21)
        rmm_spark.task_done(21)

    try:
        t = threading.Thread(target=body, daemon=True)
        t.start()
        t.join(10)
        assert not t.is_alive()
    finally:
        rmm_spark.clear_event_handler()
    assert out["splits"] == 1
    assert table_parts(out["t"]) == table_parts(want)


# ------------------------------------------------------ capacity retry


def test_capacity_retry_deadline_policy_matches_reference():
    from spark_rapids_tpu.parallel import exchange as JX
    from spark_rapids_tpu.robustness import retry as JR
    from spark_rapids_tpu_torch.parallel import exchange as PX
    seen = []
    for X, R in ((JX, JR), (PX, PR)):
        clock = {"t": 0.0}
        sleeps = []

        def make(cap, clock=clock):
            def step():
                clock["t"] += 1.0
                return ("out", np.array([True]))
            return step

        pol = R.RetryPolicy(max_attempts=50, base_backoff_s=0.5,
                            jitter=False, deadline_s=2.5,
                            clock=lambda clock=clock: clock["t"],
                            sleep=sleeps.append)
        run = X.with_capacity_retry(make, 2, max_doublings=49, policy=pol)
        with pytest.raises(X.CapacityExceeded, match="deadline") as ei:
            run()
        seen.append((str(ei.value), ei.value.capacity,
                     ei.value.doublings, clock["t"], sleeps))
    assert seen[1] == seen[0]
    assert seen[1][3] < 10


def test_capacity_retry_attempts_policy_matches_reference():
    from spark_rapids_tpu.parallel import exchange as JX
    from spark_rapids_tpu.robustness import retry as JR
    from spark_rapids_tpu_torch.parallel import exchange as PX
    seen = []
    for X, R in ((JX, JR), (PX, PR)):
        observed = np.array([3, 11, 0, 7], np.int32)
        pol = R.RetryPolicy(max_attempts=3, base_backoff_s=0.0)
        run = X.with_capacity_retry(lambda cap: (lambda: ("o", observed)),
                                    2, policy=pol, counts_indicator=True)
        with pytest.raises(X.CapacityExceeded) as ei:
            run()
        e = ei.value
        ok = X.with_capacity_retry(
            lambda cap: (lambda: (cap, np.array([cap < 8]))), 2,
            max_doublings=4)()
        seen.append((str(e), e.capacity, e.doublings, e.send_counts, ok))
    assert seen[1] == seen[0]


# -------------------------------------------------------- the JNI door


def test_jni_spill_entries_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_SPILL_DIR", str(tmp_path))
    specs = every_kind_specs(6)
    from spark_rapids_tpu.memory import rmm_spark as jrmm
    from spark_rapids_tpu.memory import spill as jspill
    seen = []
    for api, rmm, mod, table in (
            (jjni, jrmm, jspill, jax_table(specs)),
            (jni_api, rmm_spark, PS, port_table(specs))):
        row = [api.spill_store_stats_json(), api.spill_ensure_headroom(5),
               api.spill_store_install()]
        store = mod.installed_store()
        h = store.register(table.columns, name="door", task_id=3)
        row.append(json.loads(api.spill_store_stats_json()))
        row.append(api.spill_ensure_headroom(1))
        row.append(json.loads(api.spill_store_stats_json()))
        h.close()
        api.spill_store_uninstall()
        row.append(mod.installed_store())
        rmm.set_event_handler(1 << 20)
        try:
            row.append(api.spill_store_install())
            assert rmm.get_adaptor()._spill_hook is mod.installed_store()
            api.spill_store_uninstall()
            assert rmm.get_adaptor()._spill_hook is None
        finally:
            rmm.clear_event_handler()
        seen.append(row)
    assert seen[1] == seen[0]
    assert seen[1][0] == '{"installed": false}' and seen[1][2] is False
    assert seen[1][4] == PS.columns_nbytes(port_table(specs).columns)
    assert seen[1][5]["spills_host"] == 1 and seen[1][-1] is True


# ------------------------------------- chip_smoke's memory phase in small


def test_memory_phase_rehearsal_on_cpu(path, monkeypatch, tmp_path):
    """chip_smoke.py's memory phase (step 11) end to end on CPU tensors
    at small sizes, with the card's group-id branch: the out-of-core
    join on both tiers, the out-of-core group-by, spill and restore with
    corrupt files, the four task threads under a limit of three batches
    (at least one spill; no reservation, thread or handle left) with
    forced retry and split, and the JNI door's entries."""
    import chip_smoke as C
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_GROUPBY", "1")
    j = C.ooc_join_cell("cpu", rows=1 << 14, returns=1 << 11, iters=1)
    assert j["host"]["spills_host"] == j["disk"]["spills_disk"] == 8
    assert j["disk"]["disk_bytes"] == j["disk"]["host_bytes"] > 0
    g = C.ooc_groupby_cell("cpu", rows=1 << 13, budget=1 << 17, iters=1)
    assert g["partitions"] == 4 and g["float_diff_of_bound"] == 0
    s = C.spill_frees_memory("cpu", rows=3000, corrupt_rows=2000)
    assert s["corrupt"] == {"rows": 2000, "corrupt": 2, "recomputes": 1}
    t = C.task_threads("cpu", rows=3000)
    assert t["limited"]["spills_host"] >= 1
    assert t["unlimited"]["spills_host"] == 0
    assert t["forced_retry"]["retries"] == 1
    assert t["forced_split"]["split_retries"] == 1
    assert t["float_diff_of_bound"] == 0
    d = C.jni_spill_entries("cpu", rows=500)
    assert d["freed_bytes"] == 31 * 500
    assert not os.path.exists(os.path.join(str(tmp_path), "spill",
                                           "disk", "ooc_join-p0.g1.kudo"))


def test_store_survives_concurrent_spill_restore_close(tmp_path):
    """More threads than cores registering, spilling (their own handles
    and, through ensure_headroom, each other's), restoring and closing
    at a short switch interval: every restore returns its own batch,
    and afterwards no handle, host byte, disk byte or file is left."""
    import sys
    store = SpillStore(spill_dir=str(tmp_path), host_limit_bytes=200)
    nthreads = max(8, 2 * (os.cpu_count() or 1))
    errors = []

    def worker(w):
        try:
            rng = np.random.default_rng(w)
            for i in range(20):
                v = int(rng.integers(0, 1 << 40))
                h = store.register(small_cols(v), name=f"w{w}i{i}",
                                   task_id=w)
                if rng.random() < 0.5:
                    h.spill()
                store.ensure_headroom(int(rng.integers(1, 200)))
                with h.pin() as cols:
                    same_cols(cols, small_cols(v))
                if rng.random() < 0.5:
                    h.spill()
                    same_cols(h.get(), small_cols(v))
                h.close()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "store deadlocked"
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]
    st = store.stats()
    assert st["handles"] == 0 and store._host_bytes == 0
    assert store._disk_bytes == 0
    assert not [f for f in os.listdir(str(tmp_path)) if f.endswith(".kudo")]
    assert st["spills_host"] > 0 and st["restores"] > 0
