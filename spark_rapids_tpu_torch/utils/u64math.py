"""u64 lane arithmetic for the device numeric engines (Ryu in
ops/ftos_device.py, Eisel-Lemire in ops/stod_device.py): 128-bit
products from 32-bit limbs, count-leading-zeros, and the unsigned shift,
compare and remainder that int64 lanes need.

Torch has no shift or compare for uint64, so a u64 value rides in the
int64 with the same bits (ops/hash.py does the same): products and sums
wrap alike, a logical right shift is an arithmetic one with the copied
sign bits cleared, and an unsigned compare flips both sign bits first.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def shr(x: torch.Tensor, s: Union[int, torch.Tensor]) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64 by s in [0, 63]
    (an int or a tensor of per-lane counts)."""
    if isinstance(s, int):
        return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)
    keep = (torch.ones_like(x) << (64 - s).clamp(max=63)) - 1
    return torch.where(s == 0, x, (x >> s) & keep)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """a < b as u64 values."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def urem(x: torch.Tensor, b: int) -> torch.Tensor:
    """x mod b for u64 bits held in int64, b an int in [1, 2^31]: the
    remainder in 32-bit halves, ((hi mod b)(2^32 mod b) + lo mod b) mod
    b, with hi and lo non-negative, so no product passes 2^62."""
    if not 1 <= b <= 1 << 31:
        raise ValueError(f"urem divisor {b} outside [1, 2^31]")
    hi, lo = shr(x, 32), x & M32
    return ((hi % b) * ((1 << 32) % b) + lo % b) % b


def umul128(a: torch.Tensor, b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) of the 128-bit product of two u64 lanes."""
    a_lo, a_hi = a & M32, shr(a, 32)
    b_lo, b_hi = b & M32, shr(b, 32)
    p_ll = a_lo * b_lo
    p_lh = a_lo * b_hi
    p_hl = a_hi * b_lo
    mid = shr(p_ll, 32) + (p_lh & M32) + (p_hl & M32)
    lo = (p_ll & M32) | (mid << 32)
    hi = a_hi * b_hi + shr(p_lh, 32) + shr(p_hl, 32) + shr(mid, 32)
    return lo, hi


def clz64(x: torch.Tensor) -> torch.Tensor:
    """countl_zero of u64 lanes (binary steps, no float rounding), int32.
    The reference's `v < 2^(64 - bits)` is unsigned: here it is a test
    that the top `bits` bits are clear."""
    out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    v = x
    for bits in (32, 16, 8, 4, 2, 1):
        m = shr(v, 64 - bits) == 0
        out = torch.where(m, out + bits, out)
        v = torch.where(m, v << bits, v)
    return torch.where(x == 0, 64, out)
