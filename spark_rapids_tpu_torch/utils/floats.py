"""IEEE-754 bit helpers on int64 lanes.

FLOAT64 columns are native torch.float64; the Spark hash rules that
normalize NaN and -0.0, and the total-order keys that MIN/MAX and sorts
use, work on `.view(torch.int64)` bit patterns.  Masks and constants
below 2^63 are plain ints; the sign bit is -2^63.
"""

from __future__ import annotations

import torch

F64_SIGN = -(1 << 63)               # 0x8000000000000000 as int64
F64_ABS_MASK = 0x7FFFFFFFFFFFFFFF
F64_QNAN = 0x7FF8000000000000
F64_INF = 0x7FF0000000000000
F32_QNAN = 0x7FC00000
F32_SIGN = 0x80000000          # float32 -0.0 as a u32 in int64


def is_nan_bits(bits: torch.Tensor) -> torch.Tensor:
    """NaN test on int64 float64 bit patterns."""
    return (bits & F64_ABS_MASK) > F64_INF


def normalize_nans_f64_bits(bits: torch.Tensor) -> torch.Tensor:
    """Every NaN becomes the canonical quiet NaN (murmur3 rule)."""
    return torch.where(is_nan_bits(bits), F64_QNAN, bits)


def normalize_nans_zeros_f64_bits(bits: torch.Tensor) -> torch.Tensor:
    """Canonical NaN and -0.0 -> +0.0 (xxhash64 rule)."""
    bits = torch.where(bits == F64_SIGN, 0, bits)
    return normalize_nans_f64_bits(bits)


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone int64 key of a float64 tensor: orders like IEEE-754
    totalOrder (negatives reversed, -0.0 below 0.0, NaNs above +inf
    and below -inf by sign), one key per bit pattern.  The JAX
    package's key on raw bits, computed in signed lanes: a negative
    pattern flips its magnitude bits, a positive one stays."""
    bits = x.view(torch.int64)
    return torch.where(bits < 0, bits ^ F64_ABS_MASK, bits)


def from_total_order_key(key: torch.Tensor) -> torch.Tensor:
    """The float64 whose total_order_key is ``key`` (exact bits)."""
    return torch.where(key < 0, key ^ F64_ABS_MASK, key).view(torch.float64)


def f32_order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 total-order key in [0, 2^32) as int64: the u32 bits with
    a negative pattern inverted and a positive one's sign bit set."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= F32_SIGN, bits ^ 0xFFFFFFFF, bits | F32_SIGN)


def from_f32_order_key(key: torch.Tensor) -> torch.Tensor:
    """The float32 of an f32_order_key, clamped into [0, 2^32) first."""
    k = key.clamp(0, 0xFFFFFFFF)
    bits = torch.where(k < F32_SIGN, k ^ 0xFFFFFFFF, k ^ F32_SIGN)
    bits = torch.where(bits >= F32_SIGN, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)
