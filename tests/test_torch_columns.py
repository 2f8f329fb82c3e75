"""PyTorch port: dtypes, Column/Table, host interop, and the import rule
(the port loads neither JAX nor the JAX package)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columns import dtypes as jdtypes
from spark_rapids_tpu_torch.columns import bytesview, dtypes, interop
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table

from torch_port_data import CYCLE, EXTRA, host_table, jax_table

REPO = Path(__file__).resolve().parents[1]


def test_import_loads_no_jax():
    code = ("import sys, spark_rapids_tpu_torch\n"
            "import spark_rapids_tpu_torch.models.flagship\n"
            "import spark_rapids_tpu_torch.ops.row_assembly_cuda\n"
            "import spark_rapids_tpu_torch.columns.interop\n"
            "import spark_rapids_tpu_torch.shim.jni_api\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'spark_rapids_tpu.')) or "
            "m == 'spark_rapids_tpu')\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("kind", CYCLE + EXTRA + ["decimal128", "string",
                                                  "list", "struct"])
def test_dtype_table_matches_reference(kind):
    ours, ref = dtypes.DType(kind), jdtypes.DType(kind)
    assert ours.is_fixed_width == ref.is_fixed_width
    assert ours.is_decimal == ref.is_decimal
    assert ours.is_nested == ref.is_nested
    if ref.is_fixed_width:
        assert ours.size_bytes == ref.size_bytes
        assert ours.np_dtype == ref.np_dtype
        assert torch.empty(0, dtype=ours.torch_dtype).element_size() == \
            ref.np_dtype.itemsize


@pytest.mark.parametrize("rows", [0, 1, 257])
def test_interop_round_trip_is_bit_exact(rows):
    rng = np.random.default_rng(11 + rows)
    specs = host_table(rng, rows, CYCLE + EXTRA + ["decimal128"],
                       null_every=2)
    t = interop.table_from_host(specs, device="cpu")
    assert t.num_rows == rows and t.num_columns == len(specs)
    f64 = t.columns[CYCLE.index("float64")]
    assert f64.data.dtype == torch.float64
    for (k, d, v), (k2, d2, v2) in zip(specs, interop.table_to_host(t)):
        assert k == k2 and d.dtype == d2.dtype
        assert d.tobytes() == d2.tobytes()
        assert (v is None) == (v2 is None)
        if v is not None:
            np.testing.assert_array_equal(v, v2)


def test_interop_keeps_nan_payloads_and_negative_zero():
    bits = np.array([0x7FF0000000000001, 0xFFF8000000000123,
                     0x8000000000000000, 0x7FF8000000000000], np.uint64)
    t = interop.table_from_host([("float64", bits, None)], device="cpu")
    assert t.columns[0].data.view(torch.int64).numpy().view(
        np.uint64).tolist() == bits.tolist()
    back = interop.table_to_host(t)[0][1]
    assert back.dtype == np.uint64 and back.tolist() == bits.tolist()


def test_interop_matches_reference_host_view():
    """What the JAX package holds for a column is what the port gives
    back through table_to_host."""
    rng = np.random.default_rng(5)
    specs = host_table(rng, 64, CYCLE + ["decimal128"], null_every=3)
    ref = jax_table(specs)
    ours = interop.table_to_host(interop.table_from_host(specs, "cpu"))
    for rc, (_k, d, v) in zip(ref.columns, ours):
        assert np.asarray(rc.data).tobytes() == d.tobytes()
        if rc.validity is not None:
            np.testing.assert_array_equal(np.asarray(rc.validity), v)


@pytest.mark.parametrize("spec,err", [
    (("int32", np.zeros(3, np.int64), None), ValueError),
    (("decimal128", np.zeros((3, 2), np.int32), None), ValueError),
    (("int8", np.zeros(3, np.int8), np.ones(4, np.uint8)), ValueError),
    (("string", np.zeros(3, np.uint8), None), ValueError),   # no offsets
])
def test_interop_rejects_mismatched_host_data(spec, err):
    with pytest.raises(err):
        interop.table_from_host([spec], device="cpu")


def test_rows_from_host_accepts_bytes_and_packed_words():
    words = np.arange(6, dtype=np.uint32)        # 24 bytes, 3 rows of 8
    offs = np.array([0, 8, 16, 24], np.int32)
    a = interop.rows_from_host(offs, words, device="cpu")
    b = interop.rows_from_host(offs, words.tobytes(), device="cpu")
    assert a.dtype.kind == "list" and a.length == 3
    assert bytesview.to_host_bytes(a.children[0].data, 24) == \
        words.tobytes()
    assert torch.equal(a.children[0].data, b.children[0].data)
    assert a.offsets.dtype == torch.int32
    with pytest.raises(ValueError):
        interop.rows_from_host(np.array([0, 32], np.int32), words, "cpu")


def test_column_and_table_basics():
    a = Column(dtypes.INT32, 3, data=torch.tensor([1, 2, 3],
                                                  dtype=torch.int32))
    b = Column(dtypes.INT8, 3, data=torch.tensor([1, 2, 3], dtype=torch.int8),
               validity=torch.tensor([1, 0, 1], dtype=torch.uint8))
    assert a.device.type == "cpu" and len(b) == 3
    t = Table([a, b], names=["a", "b"])
    assert t.num_rows == 3 and t["b"] is b and t.device.type == "cpu"
    with pytest.raises(ValueError):
        Table([a, Column(dtypes.INT32, 2,
                         data=torch.zeros(2, dtype=torch.int32))])
    with pytest.raises(ValueError):
        Column.make_list_from_parts(torch.zeros(2, dtype=torch.int32),
                                    torch.zeros(4, dtype=torch.int32))
