"""Z-order and Hilbert clustering indexes for Delta/Iceberg OPTIMIZE
(reference zorder.cu/zorder.hpp, ZOrder.java).

interleave_bits: rows of N same-typed fixed-width columns -> per-row byte
blob of bit-interleaved values, MSB of column 0 first (zorder.cu kernel
:160-190 bit ordering).  hilbert_index: N INT32 columns -> INT64 Hilbert
curve index via the Skilling transform (zorder.cu:92-150).

Both are bit shuffles on the columns' device: (rows, bits) boolean
tensors reshaped and packed with fixed index maps; the Skilling loops
are Python loops of tensor ops.  Values ride in int64 lanes (u32 values
masked to 32 bits; a u64 as its bit pattern), so every right shift
that matters reads a bit below the sign.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind

_I64 = torch.int64
M32 = 0xFFFFFFFF


def _value_bits_msb(col: Column) -> torch.Tensor:
    """(rows, 8*size) bool bits, most significant first; null rows are 0."""
    size = col.dtype.size_bytes
    nbits = 8 * size
    # the storage bits (FLOAT32/64 raw IEEE-754), zero-extended
    u = col.data.view(dtypes.SIGNED_OF_WIDTH[size]).to(_I64)
    if nbits < 64:
        u = u & ((1 << nbits) - 1)
    if col.validity is not None:
        u = torch.where(col.validity != 0, u, 0)
    # 32-bit lanes where the value fits: a quarter of the bytes moved
    lane = torch.int32 if nbits <= 32 else _I64
    shifts = torch.arange(nbits - 1, -1, -1, dtype=lane, device=u.device)
    return ((u.to(lane)[:, None] >> shifts[None, :]) & 1).to(torch.bool)


def interleave_bits(cols: Sequence[Column]) -> Column:
    """LIST<UINT8> column: per-row interleaved bits of all columns
    (ZOrder.interleaveBits)."""
    if not cols:
        raise ValueError("The input table must have at least one column.")
    t0 = cols[0].dtype
    if not t0.is_fixed_width:
        raise ValueError("Only fixed width columns can be used")
    if any(c.dtype != t0 for c in cols):
        raise ValueError("All columns of the input table must be the same "
                         "type.")
    rows = cols[0].length
    bits = torch.stack([_value_bits_msb(c) for c in cols], dim=1)
    # (rows, nc, B) -> output bit b*nc + c = bits[:, c, b]
    inter = bits.transpose(1, 2).reshape(rows, -1)
    nbytes = inter.shape[1] // 8
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=inter.device)
    packed = (inter.reshape(rows, nbytes, 8).to(torch.uint8)
              * weights).sum(dim=2, dtype=torch.int32).to(torch.uint8)
    offsets = torch.arange(rows + 1, dtype=torch.int32,
                           device=inter.device) * nbytes
    return Column.make_list_from_parts(offsets, packed.reshape(-1))


def hilbert_index(num_bits: int, cols: Sequence[Column]) -> Column:
    """INT64 Hilbert index of N INT32 coordinate columns (zorder.hpp:34;
    Skilling transform per zorder.cu)."""
    if not cols:
        raise ValueError("at least one column is required.")
    if any(c.dtype.kind != Kind.INT32 for c in cols):
        raise ValueError("All columns of the input table must be INT32.")
    if not 0 < num_bits <= 32:
        raise ValueError("the number of bits must be >0 and <= 32")
    if num_bits * len(cols) > 64:
        raise ValueError("num_bits * num_columns must be <= 64")
    n = len(cols)
    mask_val = (1 << num_bits) - 1
    x: List[torch.Tensor] = []
    for c in cols:
        u = c.data.to(_I64) & mask_val
        if c.validity is not None:
            u = torch.where(c.validity != 0, u, 0)
        x.append(u)

    m = 1 << (num_bits - 1)
    # Inverse undo (zorder.cu:104-115)
    q = m
    while q > 1:
        p = q - 1
        for i in range(n):
            cond = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            new_x0 = torch.where(cond, x[0] ^ p, x[0] ^ t)
            new_xi = torch.where(cond, x[i], x[i] ^ t)
            x[0] = new_x0
            x[i] = new_xi if i != 0 else x[0]
        q >>= 1
    # Gray encode
    for i in range(1, n):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = m
    while q > 1:
        t = torch.where((x[n - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(n):
        x[i] = x[i] ^ t

    # interleave transposed bits (to_hilbert_index zorder.cu:58-73)
    out = torch.zeros(cols[0].length, dtype=_I64, device=x[0].device)
    b_index = num_bits * n - 1
    mask = 1 << (num_bits - 1)
    for _ in range(num_bits):
        for j in range(n):
            bit = ((x[j] & mask) != 0).to(_I64)
            out = out | (bit << b_index)
            b_index -= 1
        mask >>= 1
    return Column(dtypes.INT64, cols[0].length, data=out)
