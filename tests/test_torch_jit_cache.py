"""PyTorch port: the process compile cache (``perf/jit_cache.py``) held
against the JAX package's.

The same ``get_or_build`` sequences go through a JAX ``JitCache`` and a
port ``JitCache``; their ``stats()`` (less the measured compile
nanoseconds), the builds they ran, their evictions and the
``srt_jit_cache_*`` series they record are equal.  The capacity-retry
driver's steps ride both caches the same way, ``pad_axis0`` pads the
same values, and the shim entries give the same JSON keys.
Tolerance: exact everywhere; ``compile_ns_total`` is only required to
be positive after a build.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu.perf import jit_cache as JJC
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch.perf import jit_cache as JC
from torch_planes import isolate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def planes(monkeypatch, tmp_path):
    yield from isolate(monkeypatch, tmp_path)


def _stats(cache):
    st = cache.stats()
    ns = st.pop("compile_ns_total")
    assert ns >= 0
    return st


def _builder(built, tag):
    def build():
        built.append(tag)
        return lambda: tag
    return build


def _lru_sequence(mod):
    """The reference test's LRU and owner sequence; returns (results,
    builds, stats of both caches)."""
    cache = mod.JitCache(max_entries=2)
    built, got = [], []
    for digest, tag in (("a", "a"), ("b", "b"), ("a", "a2"), ("c", "c"),
                        ("a", "a3"), ("b", "b2")):
        got.append(cache.get_or_build("k", digest, 8,
                                      _builder(built, tag))())
    o1, o2 = object(), object()
    cache2 = mod.JitCache(max_entries=8)
    for owner, tag in ((o1, "o1"), (o2, "o2"), (o2, "x")):
        got.append(cache2.get_or_build("k", "d", 8, _builder(built, tag),
                                       owner=owner)())
    return got, built, _stats(cache), _stats(cache2)


def test_lru_eviction_and_owner_identity_match_reference():
    port, ref = _lru_sequence(JC), _lru_sequence(JJC)
    assert port == ref
    got, built, st, _st2 = port
    assert got == ["a", "b", "a", "c", "a", "b2", "o1", "o2", "o2"]
    assert built == ["a", "b", "c", "b2", "o1", "o2"]
    assert st["evictions"] == 2


@pytest.mark.parametrize("costs", [(60, 60), (30, 30, 50), (101,),
                                   (10, 95, 10)])
def test_byte_budget_eviction_matches_reference(costs):
    def run(mod):
        cache = mod.JitCache(max_entries=100, max_bytes=100)
        for i, c in enumerate(costs):
            cache.get_or_build("k", str(i), 8, lambda: (lambda: i),
                               cost_bytes=c)
        return _stats(cache)
    assert run(JC) == run(JJC)
    assert run(JC)["bytes"] <= max(100, max(costs))


def test_entry_budget_env_knob(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_JIT_CACHE_ENTRIES", "3")
    monkeypatch.setenv("SPARK_RAPIDS_TPU_JIT_CACHE_BYTES", "1000")

    def run(mod):
        cache = mod.JitCache()
        for i in range(7):
            cache.get_or_build(f"k{i % 2}", str(i), 8 << i,
                               lambda: (lambda: 0), cost_bytes=300)
        return _stats(cache)
    st = run(JC)
    assert st == run(JJC)
    assert st["max_entries"] == 3 and st["max_bytes"] == 1000
    assert st["entries"] == 3 and st["evictions"] == 4


def test_cache_records_match_reference():
    """hit / miss / eviction series equal in both registries (the
    compile-time histogram's values are times: present and counted)."""
    for o, mod in ((obs, JC), (jobs, JJC)):
        o.enable()
        cache = mod.JitCache(max_entries=1)
        cache.get_or_build("kern", "a", 8, lambda: (lambda: 1))
        cache.get_or_build("kern", "a", 8, lambda: (lambda: 1))
        cache.get_or_build("kern", "b", 8, lambda: (lambda: 2))
    for fam in ("srt_jit_cache_hits_total", "srt_jit_cache_misses_total",
                "srt_jit_cache_evictions_total"):
        assert obs.METRICS.family_snapshot(fam) == \
            jobs.METRICS.family_snapshot(fam)
    hist = obs.METRICS.family_snapshot("srt_jit_compile_ns")
    assert [s["count"] for s in hist["series"]] == [2]


def test_pad_axis0_matches_reference():
    import jax.numpy as jnp
    a = np.arange(10, dtype=np.int32)
    m = np.arange(12, dtype=np.uint8).reshape(3, 4)
    for src, bucket in ((a, 16), (m, 8), (a, 10)):
        got = JC.pad_axis0(torch.from_numpy(src), bucket)
        want = np.asarray(JJC.pad_axis0(jnp.asarray(src), bucket))
        assert got.numpy().tobytes() == want.tobytes()
        assert tuple(got.shape) == want.shape
        assert got.device.type == "cpu"
    t = torch.from_numpy(m)
    assert JC.pad_axis0(t, 3) is t


def test_tree_nbytes_counts_nested_tensors():
    args = (torch.zeros(8, dtype=torch.int64),
            [torch.zeros(4, dtype=torch.int32), None],
            {"x": torch.zeros(2, 3, dtype=torch.uint8)})
    assert JC._tree_nbytes(args) == 64 + 16 + 6


def test_cached_call_compiles_once_then_hits():
    cache = JC.JitCache()

    def fn(x, y):
        return x * 2 + y

    x = torch.arange(16, dtype=torch.int64)
    y = torch.ones(16, dtype=torch.int64)
    first = cache.cached_call("t.affine", "d", fn, (x, y), bucket=16)
    second = cache.cached_call("t.affine", "d", fn, (y, x), bucket=16)
    assert torch.equal(first, fn(x, y)) and torch.equal(second, fn(y, x))
    st = cache.stats()
    assert (st["misses"], st["hits"], st["compiles"]) == (1, 1, 1)
    assert st["kernels"] == {"t.affine": {"hits": 1, "misses": 1,
                                          "evictions": 0}}
    assert st["bytes"] == 2 * 16 * 8 and st["compile_ns_total"] > 0


def _retry_steps(mod_exchange, cache):
    calls = []

    def make_step(cap):
        calls.append(cap)
        return lambda x: (x * 2, np.zeros(1))     # never overflows

    run = mod_exchange.with_capacity_retry(make_step, 8)
    outs = [run(3)[0][0], run(5)[0][0]]

    def make_step2(cap):
        calls.append(-cap)
        return lambda x: (x * 3, np.zeros(1))

    outs.append(mod_exchange.with_capacity_retry(make_step2, 8)(3)[0][0])
    return outs, calls, cache.stats()["kernels"].get("exchange.step")


def test_exchange_steps_ride_the_cache_like_reference():
    from spark_rapids_tpu.parallel import exchange as JX
    from spark_rapids_tpu_torch.parallel import exchange as X
    port = _retry_steps(X, JC.CACHE)
    ref = _retry_steps(JX, JJC.CACHE)
    assert port == ref
    outs, calls, ks = port
    assert outs == [6, 10, 9] and calls == [8, -8]
    assert ks == {"hits": 1, "misses": 2, "evictions": 0}
    assert JC.CACHE.stats()["compiles"] == 0    # steps count no compile


def test_exchange_steps_cache_disabled(monkeypatch):
    from spark_rapids_tpu_torch.parallel.exchange import with_capacity_retry
    monkeypatch.setenv("SPARK_RAPIDS_TPU_JIT_CACHE", "0")
    calls = []

    def make_step(cap):
        calls.append(cap)
        return lambda x: (x + cap, np.zeros(1))

    run = with_capacity_retry(make_step, 4)
    assert run(1)[0][0] == 5 and run(2)[0][0] == 6
    assert calls == [4]
    assert JC.CACHE.stats()["misses"] == 0


def test_hash_join_factory_is_one_cache_owner_per_shape():
    from spark_rapids_tpu_torch.ops import hash_join as HJ
    f1 = HJ._device_step_factory(2, 64, 32, "d")
    assert HJ._device_step_factory(2, 64, 32, "d") is f1
    assert HJ._device_step_factory(2, 64, 64, "d") is not f1
    rng = np.random.default_rng(5)
    lw = [torch.from_numpy(rng.integers(0, 9, 50)) for _ in range(2)]
    rw = [torch.from_numpy(rng.integers(0, 9, 20)) for _ in range(2)]
    ones = [torch.ones(n, dtype=torch.bool) for n in (50, 20)]
    a = HJ.device_hash_join(lw, rw, *ones, "d")
    b = HJ.device_hash_join(lw, rw, *ones, "d")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ks = JC.CACHE.stats()["kernels"]["exchange.step"]
    assert ks["hits"] >= 1 and ks["misses"] >= 1


def test_cache_enabled_env_is_dynamic(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_JIT_CACHE", "0")
    assert not JC.cache_enabled() and not JC.CACHE.stats()["enabled"]
    monkeypatch.delenv("SPARK_RAPIDS_TPU_JIT_CACHE")
    assert JC.cache_enabled() == JJC.cache_enabled() is True


def test_shim_stats_and_clear_match_reference():
    from spark_rapids_tpu.shim import jni_entry as JE
    from spark_rapids_tpu_torch.shim import jni_api, jni_entry
    for cache in (JC.CACHE, JJC.CACHE):
        cache.get_or_build("k", "a", 8, lambda: (lambda: 0))
    port = json.loads(jni_entry.jit_cache_stats())
    ref = json.loads(JE.jit_cache_stats())
    for st in (port, ref):
        st.pop("compile_ns_total")
        st.pop("max_bytes")     # the JAX default budget is also 8 GiB
    assert port["max_entries"] == ref["max_entries"] == 256
    assert port == ref
    assert jni_api.jit_cache_clear() == 1 == JE.jit_cache_clear()
    port = json.loads(jni_api.jit_cache_stats())
    assert port["entries"] == 0 and port["misses"] == 1
    assert jni_entry.jit_cache_clear(True) == 0
    assert json.loads(jni_api.jit_cache_stats())["misses"] == 0


def test_perf_package_exports_the_cache():
    import spark_rapids_tpu_torch.perf as P
    assert P.CACHE is JC.CACHE and P.JitCache is JC.JitCache
    assert P.pad_axis0 is JC.pad_axis0


def test_new_modules_import_without_jax():
    mods = ["spark_rapids_tpu_torch", "spark_rapids_tpu_torch.perf.jit_cache",
            "spark_rapids_tpu_torch.perf.result_cache"] + [
        f"spark_rapids_tpu_torch.observability.{m}" for m in (
            "anomaly", "attribution", "critical_path", "flight_recorder",
            "profile", "slo", "stats", "timeseries")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'spark_rapids_tpu']\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=REPO))
