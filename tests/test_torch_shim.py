"""PyTorch port: the JVM door.  The handle registry's contract, and each
of the seven ported `jni_api` entries held against the JAX package's
`jni_api` on the same host values."""

import inspect
import threading

import pytest

from spark_rapids_tpu.columns import dtypes as jdtypes
from spark_rapids_tpu.shim import jni_api as JA
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.shim import jni_api as A
from spark_rapids_tpu_torch.shim.errors import (ShimArgumentError,
                                                ShimStateError)
from spark_rapids_tpu_torch.shim.handles import REGISTRY, HandleRegistry

COLUMNS = [   # (kind, scale, values)
    ("int32", 0, [1, None, -(2**31), 2**31 - 1, 0, 7]),
    ("int64", 0, [None, 2**63 - 1, -5, 0, 1, -(2**63)]),
    ("string", 0, ["spark", None, "", "héllo", "x" * 40, "abc"]),
    ("decimal128", -2, [12345, -1, None, 2**100, -(2**127), 0]),
    ("bool8", 0, [True, False, None, True, True, False]),
    ("float64", 0, [0.5, -0.0, None, float("nan"), 1e300, -2.0]),
    ("int8", 0, [-128, 127, None, 0, 1, -1]),
]


def _make(kinds=COLUMNS):
    ours = [A.make_column_from_host(v, dtypes.DType(k, s), device="cpu")
            for k, s, v in kinds]
    ref = [JA.make_column_from_host(v, jdtypes.DType(k, s))
           for k, s, v in kinds]
    return ours, ref


def _release(ours, ref):
    for h in ours:
        A.release_column(h)
    for h in ref:
        JA.release_column(h)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y or (x != x and y != y)   # NaN rows


def test_handle_contract():
    reg = HandleRegistry()
    a, b = reg.register("a"), reg.register(0)
    assert reg.get(b) == 0 and reg.live_count() == 2
    assert reg.release(a) == "a" and not reg.is_live(a)
    with pytest.raises(ValueError):
        reg.release(a)
    with pytest.raises(ValueError):
        reg.get(a)
    c = reg.register("c")
    assert c not in (a, b) and c > b        # ids are never reused
    reg.release(b)
    reg.release(c)
    assert reg.live_count() == 0


def test_handles_survive_racing_releases():
    """Many threads release the same handles: each handle is released
    once, every other attempt gets the ValueError, nothing else breaks."""
    reg = HandleRegistry()
    hs = [reg.register(i) for i in range(200)]
    won, lost = [], []

    def worker():
        for h in hs:
            try:
                reg.release(h)
                won.append(h)
            except ValueError:
                lost.append(h)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(won) == hs and len(lost) == 3 * len(hs)
    assert reg.live_count() == 0


def test_shim_errors_keep_their_builtin_bases():
    assert issubclass(ShimArgumentError, ValueError)
    assert issubclass(ShimStateError, RuntimeError)


def test_entries_default_to_the_card():
    assert inspect.signature(
        A.make_column_from_host).parameters["device"].default == "cuda"


@pytest.mark.parametrize("kind,scale,values", COLUMNS)
def test_make_column_and_column_to_host_match_reference(kind, scale, values):
    start = REGISTRY.live_count()
    ours, ref = _make([(kind, scale, values)])
    _same(A.column_to_host(ours[0]), JA.column_to_host(ref[0]))
    _release(ours, ref)
    assert REGISTRY.live_count() == start
    with pytest.raises(ValueError):
        A.release_column(ours[0])


@pytest.mark.parametrize("seed", [42, 0])
def test_hash_entries_match_reference(seed):
    start = REGISTRY.live_count()
    ours, ref = _make()
    for fn, jfn in ((A.murmur_hash3_32, JA.murmur_hash3_32),
                    (A.xx_hash_64, JA.xx_hash_64)):
        for keys in ([0, 1, 2], list(range(len(COLUMNS)))):
            h = fn(seed, [ours[k] for k in keys])
            j = jfn(seed, [ref[k] for k in keys])
            assert A.column_to_host(h) == JA.column_to_host(j)
            A.release_column(h)
            JA.release_column(j)
    _release(ours, ref)
    assert REGISTRY.live_count() == start


@pytest.mark.parametrize("with_strings", [True, False])
def test_row_conversion_entries_match_reference(with_strings):
    kinds = [c for c in COLUMNS if with_strings or c[0] != "string"]
    start = REGISTRY.live_count()
    ours, ref = _make(kinds)
    rows, jrows = A.convert_to_rows(ours), JA.convert_to_rows(ref)
    assert A.column_to_host(rows) == JA.column_to_host(jrows)
    type_ids = [k for k, _s, _v in kinds]
    scales = [s for _k, s, _v in kinds]
    back = A.convert_from_rows(rows, type_ids, scales)
    jback = JA.convert_from_rows(jrows, type_ids, scales)
    for h, j, (_k, _s, values) in zip(back, jback, kinds):
        got = A.column_to_host(h)
        _same(got, JA.column_to_host(j))
        _same(got, values)
    _release(ours + back + [rows], ref + jback + [jrows])
    assert REGISTRY.live_count() == start
