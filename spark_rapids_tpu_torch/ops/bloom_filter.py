"""Spark BloomFilter create/put/probe/merge (reference bloom_filter.cu/
bloom_filter.hpp, BloomFilter.java) -- byte-compatible with Spark's
serialized sketch formats:

  V1: [version=1, numHashes, numLongs] big-endian + longs big-endian
      (BloomFilterImpl hash loop: combined = h1 + i*h2, i in 1..n, int32)
  V2: [version=2, numHashes, seed, numLongs] + longs
      (BloomFilterImplV2: combined int64 = h1*INT32_MAX (+= h2 per probe))

The bitset lives as 32-bit words (int32 bit patterns) with the
reference's big-endian swizzle (word index ^ 1, bit index ^ 0x18,
bloom_filter.cu gpu_bit_to_word_mask), so the word buffer's
little-endian byte image equals Spark's big-endian long array.

A put of N rows with K hashes computes the (N, K) bit positions in one
pass on the filter's device, index-puts True into a bool bit array (the
same value written twice is harmless, so duplicate positions need no
bitwise-OR reduction, which torch's scatter_reduce lacks), packs it to
words and ORs them into the filter."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops.hash import M32, _murmur_blocks, _split_u64

_I64 = torch.int64

INT32_MAX = 2147483647


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 lanes -> the same bits as int32 values (in
    int64 lanes)."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


@dataclass
class BloomFilter:
    version: int
    num_hashes: int
    seed: int                 # 0 for v1 (not serialized)
    words: torch.Tensor       # (num_longs*2,) int32, swizzled layout

    @property
    def num_longs(self) -> int:
        return int(self.words.shape[0]) // 2

    @property
    def num_bits(self) -> int:
        return self.num_longs * 64


def create(num_hashes: int, num_longs: int, version: int = 2,
           seed: int = 0, device="cuda") -> BloomFilter:
    if version not in (1, 2):
        raise ValueError("bloom filter version must be 1 or 2")
    return BloomFilter(version, num_hashes, seed if version == 2 else 0,
                       torch.zeros(num_longs * 2, dtype=torch.int32,
                                   device=device))


def _hash_pair(col: Column, seed: int):
    """(h1, h2) int32 murmur hashes of an INT64 column, as int32 values
    in int64 lanes (bloom_filter.cu:95-100)."""
    v = col.data.to(_I64)
    lo, hi = _split_u64(v)
    h1u = _murmur_blocks(torch.full(v.shape, seed & M32, dtype=_I64,
                                    device=v.device), [lo, hi], 8)
    h2u = _murmur_blocks(h1u, [lo, hi], 8)
    return _as_i32(h1u), _as_i32(h2u)


def _bit_positions(bf: BloomFilter, col: Column) -> torch.Tensor:
    """(rows, num_hashes) int64 bit positions."""
    h1, h2 = _hash_pair(col, bf.seed if bf.version == 2 else 0)
    k = bf.num_hashes
    steps = torch.arange(1, k + 1, dtype=_I64, device=h1.device)[None, :]
    if bf.version == 1:
        combined = _as_i32(h1[:, None] + steps * h2[:, None])  # int32 wrap
    else:
        combined = (h1 * INT32_MAX)[:, None] + steps * h2[:, None]
    pos = torch.where(combined < 0, ~combined, combined)
    return pos % bf.num_bits


def _word_and_bit(pos: torch.Tensor):
    """gpu_bit_to_word_mask (bloom_filter.cu): big-endian swizzle."""
    return (pos // 32) ^ 1, (pos % 32) ^ 0x18


def put(bf: BloomFilter, col: Column) -> BloomFilter:
    """Insert all valid rows of an INT64 column; returns the updated
    filter (a new one: filters are values)."""
    if col.length == 0:
        return bf
    pos = _bit_positions(bf, col)
    word, bit = _word_and_bit(pos)
    flat = (word * 32 + bit).reshape(-1)
    if col.validity is not None:
        keep = (col.validity != 0)[:, None].expand(pos.shape).reshape(-1)
        flat = torch.where(keep, flat, bf.num_bits)        # dropped
    bits = torch.zeros(bf.num_bits + 1, dtype=torch.bool,
                       device=bf.words.device)
    bits[flat] = True
    shifts = torch.arange(32, dtype=_I64, device=bits.device)
    packed = (bits[: bf.num_bits].reshape(-1, 32).to(_I64) << shifts).sum(1)
    return BloomFilter(bf.version, bf.num_hashes, bf.seed,
                       bf.words | _as_i32(packed).to(torch.int32))


def probe(bf: BloomFilter, col: Column) -> Column:
    """BOOL8 column: row possibly in the filter (bloom_filter.hpp probe)."""
    if col.length == 0:
        return Column(dtypes.BOOL8, 0, data=torch.zeros(
            0, dtype=torch.uint8, device=bf.words.device))
    pos = _bit_positions(bf, col)
    word, bit = _word_and_bit(pos)
    w = bf.words[word.clamp(0, bf.words.shape[0] - 1)]
    found = (((w >> bit) & 1) != 0).all(dim=1)
    return Column(dtypes.BOOL8, col.length, data=found.to(torch.uint8),
                  validity=col.validity)


def merge(filters: Sequence[BloomFilter]) -> BloomFilter:
    """OR-combine filters built with identical parameters
    (bloom_filter.hpp merge)."""
    first = filters[0]
    words = first.words
    for f in filters[1:]:
        if (f.version, f.num_hashes, f.seed, f.num_longs) != \
                (first.version, first.num_hashes, first.seed,
                 first.num_longs):
            raise ValueError("incompatible bloom filters")
        words = words | f.words
    return BloomFilter(first.version, first.num_hashes, first.seed, words)


def serialize(bf: BloomFilter) -> bytes:
    """Spark sketch bytes (BE header + BE longs; the swizzled LE word
    image IS the BE long image)."""
    if bf.version == 1:
        header = struct.pack(">iii", 1, bf.num_hashes, bf.num_longs)
    else:
        header = struct.pack(">iiii", 2, bf.num_hashes, bf.seed,
                             bf.num_longs)
    return header + bf.words.cpu().numpy().astype("<i4").tobytes()


def deserialize(data: bytes, device="cuda") -> BloomFilter:
    version = struct.unpack(">i", data[:4])[0]
    if version == 1:
        _, num_hashes, num_longs = struct.unpack(">iii", data[:12])
        seed, off = 0, 12
    elif version == 2:
        _, num_hashes, seed, num_longs = struct.unpack(">iiii", data[:16])
        off = 16
    else:
        raise ValueError(f"unsupported bloom filter version {version}")
    words = np.frombuffer(data, "<i4", num_longs * 2, off).copy()
    return BloomFilter(version, num_hashes, seed,
                       torch.from_numpy(words).to(device))
