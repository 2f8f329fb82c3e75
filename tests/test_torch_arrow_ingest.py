"""PyTorch port: the zero-copy Arrow door (io/arrow_cabi and the shim's
arrow_ingest) against the JAX package's on the same batches: buffer for
buffer (FLOAT64 as its bits), pointer identity over the wrapped buffers
on device="cpu", sliced batches, C-interface exporters, lifetime across
batch free and handle-registry churn, the typed refusals, and ingested
columns through the kudo shuffle."""

import gc
import io

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")

from spark_rapids_tpu.io import arrow_cabi as JA  # noqa: E402
from spark_rapids_tpu_torch.io import arrow_cabi as A  # noqa: E402
from spark_rapids_tpu_torch.shim import jni_api  # noqa: E402
from spark_rapids_tpu_torch.shim.handles import REGISTRY  # noqa: E402
from test_arrow_ingest import sample_batch  # noqa: E402
from torch_port_data import col_parts  # noqa: E402


def ingest_both(obj):
    """The port's columns (CPU) after checking them against the JAX
    package's, buffer for buffer."""
    cols, names = A.ingest(obj, device="cpu")
    jcols, jnames = JA.ingest(obj)
    assert names == jnames
    for c, j in zip(cols, jcols):
        assert c.dtype == type(c.dtype)(j.dtype.kind, j.dtype.scale)
        assert col_parts(c) == col_parts(j)
        assert c.device.type == "cpu"
    return cols, names


def test_pointer_identity_zero_copy():
    batch = sample_batch()
    cols, names = ingest_both(batch)
    assert names == batch.schema.names
    # fixed-width data buffers alias the arrow memory exactly, float64
    # (native) and decimal128 (limbs) included
    for name in ["i64", "i32", "f32", "ts", "f64", "dec"]:
        j = names.index(name)
        assert cols[j].data.data_ptr() == \
            batch.column(j).buffers()[1].address, name
    assert cols[names.index("f64")].data.dtype == torch.float64
    assert cols[names.index("dec")].data.shape == (batch.num_rows, 4)
    # string offsets and chars alias
    j = names.index("s")
    assert cols[j].offsets.data_ptr() == batch.column(j).buffers()[1].address
    assert cols[j].data.data_ptr() == batch.column(j).buffers()[2].address


def test_values_and_nulls_round_trip():
    batch = sample_batch()
    cols, names = ingest_both(batch)
    for j, name in enumerate(names):
        got = cols[j].to_pylist()
        if name == "ts":
            ref = batch.column(j).cast(pa.int64()).to_pylist()
        elif name == "dec":
            ref = [None if v is None else int(v.scaleb(2))
                   for v in batch.column(j).to_pylist()]
        else:
            ref = batch.column(j).to_pylist()
        assert got == ref, name


def test_more_fixed_types():
    rng = np.random.default_rng(4)
    n = 77
    batch = pa.record_batch({
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-2**15, 2**15, n).astype(np.int16)),
        "u8": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "u16": pa.array(rng.integers(0, 2**16, n).astype(np.uint16)),
        "u32": pa.array(rng.integers(0, 2**32, n).astype(np.uint32)),
        "u64": pa.array(rng.integers(0, 2**63, n).astype(np.uint64)),
        "d32": pa.array(rng.integers(-20000, 20000, n).astype(np.int32),
                        pa.date32()),
        "bin": pa.array([bytes([i % 256]) * (i % 5) for i in range(n)],
                        pa.binary()),
    })
    cols, names = ingest_both(batch)
    for j, name in enumerate(names):
        if name in ("bin", "d32"):
            continue
        assert cols[j].data.data_ptr() == \
            batch.column(j).buffers()[1].address, name


def test_sliced_batch_fixed_width_stays_zero_copy():
    b = pa.record_batch({"x": pa.array(np.arange(100, dtype=np.int64)),
                         "s": pa.array([f"r{i}" for i in range(100)])})
    s = b.slice(10, 50)
    cols, _ = ingest_both(s)
    assert cols[0].to_pylist() == list(range(10, 60))
    assert cols[0].data.data_ptr() == \
        s.column(0).buffers()[1].address + 10 * 8
    # the documented exception: sliced strings re-base with one copy
    assert cols[1].to_pylist() == [f"r{i}" for i in range(10, 60)]
    assert int(cols[1].offsets[0]) == 0


def test_c_interface_protocol_exporter():
    class Exporter:
        """Anything speaking __arrow_c_array__."""

        def __init__(self, b):
            self._b = b

        def __arrow_c_array__(self, requested_schema=None):
            return self._b.__arrow_c_array__(requested_schema)

    b = pa.record_batch({"y": pa.array([1.5, None, 2.5])})
    cols, names = ingest_both(Exporter(b))
    assert names == ["y"] and cols[0].to_pylist() == [1.5, None, 2.5]


def test_survives_batch_free():
    batch = sample_batch(64)
    cols, _ = A.ingest(batch, device="cpu")
    ref = [c.to_pylist() for c in cols]
    del batch
    gc.collect()
    assert [c.to_pylist() for c in cols] == ref


def test_shim_handle_registry_churn():
    """arrow_ingest through the shim: handles live through registry
    churn, survive the source batch being freed, and a double release
    stays a clean error."""
    before = REGISTRY.live_count()
    batch = sample_batch(128)
    handles = jni_api.arrow_ingest(batch, device="cpu")
    assert len(handles) == batch.num_columns
    ref = jni_api.column_to_host(handles[0])
    del batch
    gc.collect()
    from spark_rapids_tpu_torch.columns import dtypes
    other = [jni_api.make_column_from_host(list(range(32)), dtypes.INT64,
                                           device="cpu")
             for _ in range(8)]
    for h in other:
        jni_api.release_column(h)
    assert jni_api.column_to_host(handles[0]) == ref
    out = jni_api.murmur_hash3_32(42, [handles[0], handles[1]])
    jni_api.release_column(out)
    for h in handles:
        jni_api.release_column(h)
    with pytest.raises(ValueError):
        jni_api.release_column(handles[0])
    assert REGISTRY.live_count() == before


def test_shim_hash_matches_reference():
    """An op over ingested handles gives the JAX package's bytes."""
    from spark_rapids_tpu.shim import jni_api as JJ
    batch = sample_batch(128)
    hs = jni_api.arrow_ingest(batch, device="cpu")
    jhs = JJ.arrow_ingest(batch)
    try:
        out = jni_api.xx_hash_64(7, hs[:2] + hs[5:6])
        jout = JJ.xx_hash_64(7, jhs[:2] + jhs[5:6])
        assert jni_api.column_to_host(out) == JJ.column_to_host(jout)
        jni_api.release_column(out)
        JJ.release_column(jout)
    finally:
        for h in hs:
            jni_api.release_column(h)
        for h in jhs:
            JJ.release_column(h)


def test_ingest_table_and_empty_batch():
    t = pa.table({"a": pa.array([], pa.int64()),
                  "s": pa.array([], pa.string())})
    table = A.ingest_table(t, device="cpu")
    assert table.num_rows == 0 and table.names == ["a", "s"]
    assert table.column("s").to_pylist() == []
    ingest_both(t)


def test_typed_refusals():
    def same(obj, match):
        with pytest.raises(A.ArrowIngestException, match=match) as got:
            A.ingest(obj, device="cpu")
        with pytest.raises(JA.ArrowIngestException) as want:
            JA.ingest(obj)
        assert str(got.value) == str(want.value)

    same(42, "cannot ingest")
    same(pa.record_batch({"t": pa.array([1], pa.timestamp("ns"))}), "unit")
    same(pa.record_batch({"l": pa.array([[1]], pa.list_(pa.int64()))}),
         "contract")
    multi = pa.concat_tables([pa.table({"x": pa.array([1, 2])}),
                              pa.table({"x": pa.array([3])})])
    assert multi.column("x").num_chunks == 2
    same(multi, "multi-chunk")
    one = pa.table({"x": pa.array(np.arange(8, dtype=np.int64))})
    cols, _ = ingest_both(one)
    assert cols[0].to_pylist() == list(range(8))


def test_ingest_feeds_kudo_shuffle():
    """Ingested columns flow through the engine: kudo write -> merge."""
    from spark_rapids_tpu_torch.shuffle import kudo
    from spark_rapids_tpu_torch.shuffle.schema import Field
    batch = pa.record_batch({
        "k": pa.array(np.arange(40, dtype=np.int64)),
        "s": pa.array([None if i % 4 == 0 else f"r{i}" for i in range(40)]),
    })
    cols, _ = A.ingest(batch, device="cpu")
    buf = io.BytesIO()
    kudo.write_to_stream(cols, buf, 0, 40)
    buf.seek(0)
    merged = kudo.merge_to_table(
        kudo.read_tables(buf),
        [Field(cols[0].dtype), Field(cols[1].dtype)], device="cpu")
    assert merged.columns[0].to_pylist() == cols[0].to_pylist()
    assert merged.columns[1].to_pylist() == cols[1].to_pylist()


def test_ingest_defaults_to_the_card():
    """Without a device the door uploads to "cuda": here, with no card,
    the upload refuses rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        A.ingest(pa.record_batch({"x": pa.array([1, 2])}))
