"""PyTorch port: murmur3_32 and xxhash64 over STRING and DECIMAL128
columns held bit for bit against the JAX package, around every block
boundary of both hashes (murmur's 4-byte blocks and sign-extended tail,
xxhash64's 32-byte stripes, 8-byte and 4-byte chunks and zero-extended
tail)."""

import numpy as np
import pytest

from spark_rapids_tpu.ops import hash as JH
from spark_rapids_tpu_torch.ops import hash as H

from torch_port_data import (CYCLE, host_strings, host_table, jax_table,
                             port_table)

LENGTHS = [0, 1, 3, 4, 5, 7, 8, 15, 31, 32, 33, 63, 64, 100]


def _check(specs, seed=42, max_str_len=None):
    jt, pt = jax_table(specs), port_table(specs)
    for ref_fn, fn in ((JH.murmur3_32, H.murmur3_32),
                       (JH.xxhash64, H.xxhash64)):
        ref = np.asarray(ref_fn(jt, seed, max_str_len=max_str_len).data)
        got = fn(pt, seed, max_str_len=max_str_len).data.numpy()
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("length", LENGTHS)
def test_string_hash_at_each_length_matches_reference(length):
    """Every row one length, bytes with the top bit set in the tails (the
    sign- vs zero-extension difference), a null row among them."""
    rng = np.random.default_rng(length)
    spec = host_strings(rng, 24, lens=[length] * 24, nullable=True)
    _check([spec])


@pytest.mark.parametrize("seed", [42, 0, -1])
def test_string_hash_mixed_lengths_matches_reference(seed):
    rng = np.random.default_rng(7)
    lens = np.array(LENGTHS * 3)
    _check([host_strings(rng, lens.size, lens=lens, nullable=True, skew=3)],
           seed=seed)


def test_decimal128_hash_matches_reference():
    """Java BigInteger.toByteArray lengths 1..16, with the extra sign
    byte at 127/128, -128/-129, 2^63 and the 128-bit extremes."""
    vals = [0, 1, -1, -128, 127, 128, -129, 255, 256, 2**63, -(2**63),
            2**63 - 1, -(2**127), 2**127 - 1, 2**64, -(2**64), 2**120 + 5,
            -(2**96) - 3]
    u = np.array([v & ((1 << 128) - 1) for v in vals], dtype=object)
    limbs = np.array([[(int(x) >> (32 * j)) & 0xFFFFFFFF for j in range(4)]
                      for x in u], dtype=np.uint32).view(np.int32)
    valid = np.ones(len(vals), np.uint8)
    valid[3] = 0
    _check([("decimal128", limbs, None)])
    _check([("decimal128", limbs, valid)], seed=7)


@pytest.mark.parametrize("rows,null_every", [(150, 3), (33, 0)])
def test_mixed_table_hash_matches_reference(rows, null_every):
    """Strings and DECIMAL128 chained with the fixed-width cycle."""
    rng = np.random.default_rng(rows)
    kinds = CYCLE + ["string", "decimal128", "string"]
    _check(host_table(rng, rows, kinds, null_every=null_every))


def test_max_str_len_bounds_the_strings():
    rng = np.random.default_rng(3)
    spec = host_strings(rng, 30, max_len=20, lens=[20] + [5] * 29)
    _check([spec], max_str_len=20)
    _check([spec], max_str_len=64)
    pt = port_table([spec])
    for fn in (H.murmur3_32, H.xxhash64):
        with pytest.raises(ValueError, match="max_str_len"):
            fn(pt, 42, max_str_len=19)


def test_empty_string_column_hashes():
    _check([host_strings(np.random.default_rng(0), 0)])
    _check([host_strings(np.random.default_rng(0), 5, lens=[0] * 5)])
