"""PyTorch port: the fixed-capacity device join probe, row buckets,
operand digests and the capacity-doubling retry, each held against the
JAX package on the same seeded numpy arrays.  Join outputs are compared
as exact bytes (int32 pair indices, bool slots, int64 totals)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import device_join as JJ
from spark_rapids_tpu.parallel import exchange as JX
from spark_rapids_tpu.perf.calibrate import operands_digest as j_digest
from spark_rapids_tpu.perf.jit_cache import bucket_rows as j_bucket
from spark_rapids_tpu_torch.ops import device_join as TJ
from spark_rapids_tpu_torch.parallel import exchange as TX
from spark_rapids_tpu_torch.perf.calibrate import operands_digest
from spark_rapids_tpu_torch.perf.jit_cache import bucket_rows

I64_MAX = 2**63 - 1


def _join_case(name):
    """(left keys, right keys, left valid, right valid, capacity)."""
    rng = np.random.default_rng(JOIN_CASES.index(name))
    if name == "unique":
        lk = rng.permutation(300).astype(np.int32)
        rk = rng.permutation(300).astype(np.int32)[:200]
        return lk, rk, None, None, 512
    if name == "duplicates":
        lk = rng.integers(0, 20, 400).astype(np.int64)
        rk = rng.integers(0, 20, 150).astype(np.int64)
        return lk, rk, None, None, 4096
    if name == "null_keys":
        lk = rng.integers(0, 10, 200).astype(np.int32)
        rk = rng.integers(0, 10, 90).astype(np.int32)
        lv = rng.random(200) < 0.7
        rv = rng.random(90) < 0.6
        return lk, rk, lv, rv, 4096
    if name == "int64_max_keys":
        lk = rng.choice(np.array([I64_MAX, 5, -3, I64_MAX - 1], np.int64),
                        100)
        rk = rng.choice(np.array([I64_MAX, 5, 7], np.int64), 60)
        rv = rng.random(60) < 0.5     # invalid rows sort as INT64_MAX too
        return lk, rk, None, rv, 4096
    if name == "empty_left":
        return (np.zeros(0, np.int32), np.arange(10, dtype=np.int32),
                None, None, 16)
    if name == "empty_right":
        return (np.arange(10, dtype=np.int32), np.zeros(0, np.int32),
                None, None, 16)
    if name == "overflow":
        lk = rng.integers(0, 4, 300).astype(np.int32)
        rk = rng.integers(0, 4, 300).astype(np.int32)
        return lk, rk, None, None, 1000   # about 22500 true pairs
    raise KeyError(name)


JOIN_CASES = ["unique", "duplicates", "null_keys", "int64_max_keys",
              "empty_left", "empty_right", "overflow"]


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name", JOIN_CASES)
def test_inner_join_matches_reference(name):
    lk, rk, lv, rv, cap = _join_case(name)
    ref = JJ.inner_join_device(_j(lk), _j(rk), cap, left_valid=_j(lv),
                               right_valid=_j(rv))
    got = TJ.inner_join_device(_t(lk), _t(rk), cap, left_valid=_t(lv),
                               right_valid=_t(rv))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        g = g.numpy()
        assert g.dtype == r.dtype and g.shape == r.shape
        assert g.tobytes() == r.tobytes()
    if name == "overflow":
        assert int(got.total) > cap and bool(got.valid.all())


def test_inner_join_runs_on_the_keys_device():
    got = TJ.inner_join_device(torch.arange(4), torch.arange(2), 8)
    assert all(t.device.type == "cpu" for t in got)
    assert int(got.total) == 2 and got.valid.tolist() == [True] * 2 + \
        [False] * 6


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 255, 256, 257, 4000,
                               1 << 25, (1 << 25) + 1])
def test_bucket_rows_matches_reference(n):
    assert bucket_rows(n) == j_bucket(n)
    assert bucket_rows(n, 32) == j_bucket(n, 32)


def test_operands_digest_matches_reference():
    parts = [("int32,int32,int64,int64", 4096), ("int32", 8),
             ("int64(16,),bool()", 0)]
    assert operands_digest(parts) == j_digest(parts)
    assert operands_digest(parts, "x") == j_digest(parts, "x")
    # rows fold as their bucket: 3000 and 4096 share one class
    assert operands_digest([("a", 3000)]) == operands_digest([("a", 4096)])
    assert operands_digest([("a", 3000)]) != operands_digest([("a", 5000)])


def _steps(need, counts=False):
    """A capacity-parameterized program that overflows below `need`, and
    the capacities it was built at."""
    built = []

    def make_step(cap):
        built.append(cap)

        def step(x):
            over = (np.array([need, 1]) if counts
                    else np.array(need > cap))
            return x * cap, over
        return step

    return make_step, built


@pytest.mark.parametrize("need,initial,doublings", [
    (5, 8, 6), (100, 8, 6), (1000, 8, 6), (1000, 8, 3)])
def test_capacity_retry_matches_reference(need, initial, doublings):
    results = []
    for mod in (JX, TX):
        make_step, built = _steps(need)
        run = mod.with_capacity_retry(make_step, initial,
                                      max_doublings=doublings)
        try:
            out, cap = run(3)
            results.append(("ok", cap, int(out[0]), built))
        except mod.CapacityExceeded as e:
            results.append(("raised", str(e), e.capacity, e.doublings,
                            built))
    assert results[0] == results[1]


def test_capacity_retry_counts_indicator_and_check():
    calls = []
    for mod in (JX, TX):
        make_step, built = _steps(70, counts=True)
        run = mod.with_capacity_retry(
            make_step, 4, max_doublings=2, counts_indicator=True,
            check=lambda: calls.append(1))
        with pytest.raises(mod.CapacityExceeded) as e:
            run(1)
        assert e.value.send_counts == [70, 1]
        assert e.value.capacity == 16 and built == [4, 8, 16]
    assert len(calls) == 6           # every attempt, in both packages
    make_step, built = _steps(70, counts=True)
    out, cap = TX.with_capacity_retry(make_step, 4, counts_indicator=True,
                                      overflow_index=1)(1)
    assert cap == 128 and built == [4, 8, 16, 32, 64, 128]


def test_capacity_retry_reads_a_device_flag():
    """The indicator may be a tensor: it is read on the host."""
    def make_step(cap):
        return lambda: (torch.tensor(cap), torch.tensor(cap < 64))

    out, cap = TX.with_capacity_retry(make_step, 16)()
    assert cap == 64 and int(out[0]) == 64
