"""PyTorch port: murmur3_32 and xxhash64 held bit for bit against the JAX
package on the same seeded host tables, plus Spark-derived goldens."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import hash as JH
from spark_rapids_tpu_torch.columns import dtypes, interop
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import hash as H

from torch_port_data import CYCLE, EXTRA, host_table, jax_table, port_table


def _both(specs, seed):
    jt, pt = jax_table(specs), port_table(specs)
    return [
        (np.asarray(JH.murmur3_32(jt, seed).data),
         H.murmur3_32(pt, seed).data.numpy()),
        (np.asarray(JH.xxhash64(jt, seed).data),
         H.xxhash64(pt, seed).data.numpy()),
    ]


@pytest.mark.parametrize("rows,null_every,seed", [
    (300, 3, 42),    # the 8-dtype cycle, nullable columns
    (97, 0, 0),      # no nulls, seed 0
    (64, 2, -1),     # seed wraps to all ones
])
def test_row_hashes_match_reference_on_cycle(rows, null_every, seed):
    rng = np.random.default_rng(rows)
    specs = host_table(rng, rows, CYCLE * 2, null_every=null_every)
    for ref, got in _both(specs, seed):
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("kind", CYCLE + EXTRA)
def test_single_column_hashes_match_reference(kind):
    """One column per kind: NaN payloads, +-0.0, integer extremes and
    negatives of INT8/INT16, DECIMAL32/64 as longs, with nulls."""
    rng = np.random.default_rng(len(kind))
    specs = host_table(rng, 200, [kind], null_every=1)
    for ref, got in _both(specs, 42):
        np.testing.assert_array_equal(ref, got)


def test_float_normalization_rules():
    """murmur keeps -0.0 distinct from 0.0, xxhash64 does not; every NaN
    hashes like the canonical one in both."""
    bits = np.array([0x0, 0x8000000000000000, 0x7FF8000000000000,
                     0x7FF0000000000001, 0xFFFFFFFFFFFFFFFF], np.uint64)
    t = interop.table_from_host([("float64", bits, None)], device="cpu")
    mm = H.murmur3_32(t, 42).data.tolist()
    xx = H.xxhash64(t, 42).data.tolist()
    assert mm[0] != mm[1] and xx[0] == xx[1]
    assert len(set(mm[2:])) == 1 and len(set(xx[2:])) == 1


def test_spark_goldens():
    """Values Spark itself returns (reference HashTest.java)."""
    v0 = Column(dtypes.INT32, 6,
                data=torch.tensor([0, 100, 0, 0, -(2**31), 0],
                                  dtype=torch.int32),
                validity=torch.tensor([1, 1, 0, 0, 1, 0], dtype=torch.uint8))
    v1 = Column(dtypes.INT32, 6,
                data=torch.tensor([0, 0, -100, 0, 0, 2**31 - 1],
                                  dtype=torch.int32),
                validity=torch.tensor([1, 0, 1, 0, 0, 1], dtype=torch.uint8))
    assert H.murmur3_32([v0, v1], 42).data.tolist() == [
        59727262, 751823303, -1080202046, 42, 723455942, 133916647]
    ts = Column(dtypes.DType("timestamp_micros"), 5, data=torch.tensor(
        [0, 100, -100, 0x123456789ABCDEF, -0x123456789ABCDEF]))
    assert H.murmur3_32([ts], 42).data.tolist() == [
        -1670924195, 1114849490, 904948192, 657182333, -57193045]


@pytest.mark.parametrize("kind", ["list", "struct"])
def test_unported_kinds_raise(kind):
    col = Column(dtypes.DType(kind), 2,
                 data=torch.zeros((2, 4), dtype=torch.int32))
    for fn in (H.murmur3_32, H.xxhash64):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn([col])


def _xxhash64_4byte(bits: int, seed: int) -> int:
    """Spark xxhash64 of one 4-byte value, in Python integers."""
    m = (1 << 64) - 1
    p1, p2, p3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    p5 = 0x27D4EB2F165667C5

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    h = (seed + p5 + 4) & m
    h ^= (bits * p1) & m
    h = (rotl(h, 23) * p2 + p3) & m
    h ^= h >> 33
    h = (h * p2) & m
    h ^= h >> 29
    h = (h * p3) & m
    h ^= h >> 32
    return h - (1 << 64) if h >= 1 << 63 else h


def test_xxhash64_float32_denormals_are_not_zero():
    """Spark normalizes only -0.0 to 0.0; a denormal keeps its bits.  (The
    JAX package on XLA's CPU backend hashes denormals as 0.0: ROADMAP
    Queue C.)"""
    bits = np.array([0x00000001, 0x807FFFFF, 0x80000000, 0x0], np.uint32)
    t = interop.table_from_host(
        [("float32", bits.view(np.float32), None)], device="cpu")
    got = H.xxhash64(t, 42).data.tolist()
    assert got == [_xxhash64_4byte(0x00000001, 42),
                   _xxhash64_4byte(0x807FFFFF, 42),
                   _xxhash64_4byte(0, 42), _xxhash64_4byte(0, 42)]
