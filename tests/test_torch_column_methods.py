"""PyTorch port: the Column methods the JAX Column has
(``has_validity``, ``null_count``, ``from_numpy`` with
``dtypes.from_numpy``, ``to_numpy``), each held to the JAX method on the
same values.  FLOAT64 is native float64 in the port, so its
``to_numpy`` gives the float64 values the JAX method views from raw
bits: the same values, compared bit for bit.
"""

import numpy as np
import pytest

from spark_rapids_tpu.columns import dtypes as jdtypes
from spark_rapids_tpu.columns.column import Column as JColumn
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column

NUMPY = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
         "uint64", "float32", "float64", "bool"]


def values(np_dtype, rows=37, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(np_dtype)
    if dt == np.bool_:
        return rng.random(rows) < 0.5
    if dt.kind == "f":
        v = rng.normal(size=rows).astype(dt)
        v[:4] = [np.nan, -0.0, np.inf, -np.inf]
        return v
    info = np.iinfo(dt)
    v = rng.integers(info.min, info.max, rows, dtype=dt, endpoint=True)
    v[:2] = [info.min, info.max]
    return v


def same_column(port, ref):
    assert port.dtype.kind == ref.dtype.kind
    assert port.dtype.scale == ref.dtype.scale
    assert port.length == ref.length
    assert port.has_validity == ref.has_validity
    assert port.null_count() == ref.null_count()
    got, want = port.to_numpy(), ref.to_numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("np_dtype", NUMPY)
def test_dtypes_from_numpy_matches(np_dtype):
    ours = dtypes.from_numpy(np.dtype(np_dtype))
    ref = jdtypes.from_numpy(np.dtype(np_dtype))
    assert (ours.kind, ours.scale) == (ref.kind, ref.scale)


@pytest.mark.parametrize("bad", ["complex64", "object", "U4", "float16"])
def test_dtypes_from_numpy_refuses_what_jax_refuses(bad):
    for mod in (dtypes, jdtypes):
        with pytest.raises(ValueError, match="no column dtype"):
            mod.from_numpy(np.dtype(bad))


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("np_dtype", NUMPY)
def test_from_numpy_to_numpy_match_jax(np_dtype, nulls):
    arr = values(np_dtype)
    validity = (np.arange(arr.shape[0]) % 5 != 0) if nulls else None
    port = Column.from_numpy(arr, validity, device="cpu")
    ref = JColumn.from_numpy(arr, validity)
    same_column(port, ref)
    assert port.to_pylist() == ref.to_pylist() or np_dtype.startswith(
        "float")      # NaN != NaN in the lists: the bytes compared above


@pytest.mark.parametrize("kind,np_dtype", [
    ("timestamp_days", "int32"), ("timestamp_micros", "int64"),
    ("int64", "int32"), ("float64", "float32"), ("bool8", "bool"),
    ("decimal64", "int64")])
def test_from_numpy_with_a_dtype(kind, np_dtype):
    arr = values(np_dtype, seed=3)
    scale = -2 if kind == "decimal64" else 0
    port = Column.from_numpy(arr, dtype=dtypes.DType(kind, scale),
                             device="cpu")
    ref = JColumn.from_numpy(arr, dtype=jdtypes.DType(kind, scale))
    same_column(port, ref)


def test_null_count_and_has_validity_on_other_columns():
    vals = [1, None, 3, None, None]
    port = Column.from_pylist(vals, dtypes.INT32, device="cpu")
    ref = JColumn.from_pylist(vals, jdtypes.INT32)
    assert (port.has_validity, port.null_count()) == (
        ref.has_validity, ref.null_count()) == (True, 3)
    strs = ["a", None, "bc"]
    port = Column.from_strings(strs, device="cpu")
    ref = JColumn.from_strings(strs)
    assert (port.has_validity, port.null_count()) == (
        ref.has_validity, ref.null_count()) == (True, 1)
    port = Column.from_pylist([1, 2], dtypes.INT64, device="cpu")
    assert (port.has_validity, port.null_count()) == (False, 0)


def test_to_numpy_without_a_data_buffer_raises():
    child = Column.from_pylist([1, 2], dtypes.INT32, device="cpu")
    jchild = JColumn.from_pylist([1, 2], jdtypes.INT32)
    for col in (Column.make_struct(2, [child]),
                JColumn.make_struct(2, [jchild])):
        with pytest.raises(ValueError, match="has no data buffer"):
            col.to_numpy()
