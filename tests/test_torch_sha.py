"""PyTorch port: SHA-224/256/384/512 (ops/sha_device's lane-per-row
compression and ops/sha's router and host path) and host_crc32, held
to hashlib and byte for byte to the JAX package's device SHA, with the
cases of tests/test_sha_device.py: strings across every block boundary,
FLOAT32, FLOAT64 (the port's native float64 hashes the same bits as the
reference's uint64), DECIMAL128 and nulls."""

import hashlib
import random
import zlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import sha_device as JSD
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import sha as S
from spark_rapids_tpu_torch.ops import sha_device as SD
from torch_port_data import (col_parts, host_column, jax_column,
                             port_column, strings_spec)

BITS = [224, 256, 384, 512]


def oracle(bits, vals):
    return [None if v is None else hashlib.new(
        f"sha{bits}", v if isinstance(v, bytes) else v.encode()).hexdigest()
        for v in vals]


def string_values():
    rng = random.Random(42)
    vals = ["", "a", "abc", "x" * 55, "y" * 56, "z" * 63, "w" * 64,
            "v" * 65, "longer " * 40, None, "测试中文", "q" * 111,
            "q" * 112, "r" * 119, "r" * 120, "s" * 129, "t" * 239]
    vals += ["".join(chr(rng.randrange(32, 127))
                     for _ in range(rng.randrange(0, 200)))
             for _ in range(40)]
    return vals


@pytest.mark.parametrize("bits", BITS)
def test_strings_match_hashlib_and_reference(bits):
    vals = string_values()
    spec = strings_spec(vals)
    got = SD._sha_device(port_column(spec), bits)
    assert got.to_pylist() == oracle(bits, vals)
    assert col_parts(got) == col_parts(JSD._sha_device(jax_column(spec),
                                                       bits))


@pytest.mark.parametrize("kind", ["int64", "int32", "int8", "bool8",
                                  "float32", "float64", "decimal128",
                                  "uint64", "timestamp_days"])
def test_fixed_width_matches_hashlib_and_reference(kind):
    """Each row hashes its little-endian storage bytes; floats their
    IEEE-754 bits (NaN payloads, -0.0, infinities planted), DECIMAL128
    its four limbs; nulls stay null."""
    rng = np.random.default_rng(len(kind))
    spec = host_column(rng, kind, 64, nullable=True)
    col = port_column(spec)
    host = spec[1]
    mask = spec[2].astype(bool)
    for bits in (256, 512):
        got = SD._sha_device(col, bits)
        assert got.to_pylist() == oracle(bits, [
            host[i].tobytes() if mask[i] else None for i in range(64)])
        assert col_parts(got) == col_parts(
            JSD._sha_device(jax_column(spec), bits))


def test_decimal128_goldens():
    vals = [0, 1, -1, 12345678901234567890123456789, None, -(1 << 126)]
    col = Column.from_pylist(vals, dtypes.DType("decimal128", 2), "cpu")
    want = [None if v is None else hashlib.sha256(
        (v & ((1 << 128) - 1)).to_bytes(16, "little")).hexdigest()
        for v in vals]
    assert SD.sha256_device(col).to_pylist() == want


def test_router_and_host_path(monkeypatch):
    """A CPU column goes to hashlib at any size (a card column goes to the
    device lanes: tests/test_torch_gpu.py); the pin picks either engine."""
    monkeypatch.delenv("SPARK_RAPIDS_TPU_SHA", raising=False)
    vals = [f"row{i}" if i % 7 else None for i in range(100)]
    col = Column.from_strings(vals, "cpu")
    dev = SD._sha_device(col, 256)
    host = S._sha_impl("sha256", col)
    assert dev.to_pylist() == host.to_pylist() == oracle(256, vals)
    assert col_parts(dev) == col_parts(host)
    calls = []
    monkeypatch.setattr(SD, "_sha_device",
                        lambda c, b: calls.append(b) or host)
    assert S.sha256_nulls_preserved(col).to_pylist() == oracle(256, vals)
    small = Column.from_strings(["a", None, "b"], "cpu")
    assert S.sha512_nulls_preserved(small).to_pylist() == \
        oracle(512, ["a", None, "b"])
    assert calls == []                           # CPU columns: hashlib
    monkeypatch.setenv("SPARK_RAPIDS_TPU_SHA", "device")
    S.sha224_nulls_preserved(small)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_SHA", "host")
    S.sha384_nulls_preserved(col)
    assert calls == [224]


@pytest.mark.parametrize("kind", ["string", "int64", "float64"])
@pytest.mark.parametrize("nulls", ["none", "all_valid", "some"])
def test_host_and_device_engines_give_the_same_buffers(kind, nulls):
    """A card column goes to the device lanes and its CPU copy to hashlib:
    the two engines agree buffer for buffer, validity included."""
    n = 40
    rng = np.random.default_rng(11)
    valid = {"none": None, "all_valid": np.ones(n, bool),
             "some": rng.random(n) > 0.3}[nulls]
    if kind == "string":
        col = Column.from_strings([f"key-{i}" * (i % 5) for i in range(n)],
                                  "cpu")
        col = Column(col.dtype, n, data=col.data, offsets=col.offsets)
    else:
        data = torch.from_numpy(rng.standard_normal(n)) \
            if kind == "float64" else torch.from_numpy(
                rng.integers(-2**40, 2**40, n))
        col = Column(dtypes.FLOAT64 if kind == "float64" else dtypes.INT64,
                     n, data=data)
    if valid is not None:
        col = Column(col.dtype, n, data=col.data, offsets=col.offsets,
                     validity=torch.from_numpy(valid.astype(np.uint8)))
    for bits in (224, 256, 384, 512):
        assert col_parts(SD._sha_device(col, bits)) == \
            col_parts(S._sha_impl(f"sha{bits}", col))


def test_all_valid_and_empty_columns():
    col = Column.from_strings(["a", "bb"], "cpu")
    out = SD.sha256_device(col)
    assert out.validity is None and out.to_pylist() == oracle(256,
                                                             ["a", "bb"])
    empty = Column.from_strings([], "cpu")
    assert SD.sha512_device(empty).length == 0


def test_host_crc32():
    data = np.arange(1000, dtype=np.uint8)
    assert S.host_crc32(0, data) == zlib.crc32(data.tobytes())
    assert S.host_crc32(7, b"hello", 3) == zlib.crc32(b"hel", 7)
    assert S.host_crc32(123, None, 0) == 123
    with pytest.raises(ValueError):
        S.host_crc32(0, None, 5)
