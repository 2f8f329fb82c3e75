"""Device SHA-2: lane-per-row SHA-224/256/384/512.

Reference: src/main/cpp/src/hash/sha.cpp delegates to cudf's device SHA
(one thread per row); here every row is a vector lane and the block and
round loops are Python loops of tensor ops on the column's device.

Message padding (0x80, zero fill, 8/16-byte big-endian bit length) is
materialized as a (rows, max_blocks*B) byte matrix with closed-form
selects, then packed big-endian into 32/64-bit schedule words.  Rows
with fewer blocks than max_blocks mask their state updates off once
their block count is reached, so mixed-length columns hash correctly in
one pass.  Output is the lowercase hex digest as a strings column,
matching hashlib/cudf byte for byte.

SHA-224/256 words are u32 values in int64 lanes (adds masked to 32
bits); SHA-384/512 words are u64 bit patterns in int64 lanes, whose adds
wrap alike and whose right shifts are logical (sign bits cleared).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.utils.u64math import shr

_I64 = torch.int64
M32 = 0xFFFFFFFF


def _signed64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


_K256 = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
    0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
    0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
    0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
    0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
    0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
    0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
    0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_IV256 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]
_IV224 = [0xc1059ed8, 0x367cd507, 0x3070dd17, 0xf70e5939,
          0xffc00b31, 0x68581511, 0x64f98fa7, 0xbefa4fa4]

_K512 = [_signed64(k) for k in [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f,
    0xe9b5dba58189dbbc, 0x3956c25bf348b538, 0x59f111f1b605d019,
    0x923f82a4af194f9b, 0xab1c5ed5da6d8118, 0xd807aa98a3030242,
    0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235,
    0xc19bf174cf692694, 0xe49b69c19ef14ad2, 0xefbe4786384f25e3,
    0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65, 0x2de92c6f592b0275,
    0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f,
    0xbf597fc7beef0ee4, 0xc6e00bf33da88fc2, 0xd5a79147930aa725,
    0x06ca6351e003826f, 0x142929670a0e6e70, 0x27b70a8546d22ffc,
    0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6,
    0x92722c851482353b, 0xa2bfe8a14cf10364, 0xa81a664bbc423001,
    0xc24b8b70d0f89791, 0xc76c51a30654be30, 0xd192e819d6ef5218,
    0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99,
    0x34b0bcb5e19b48a8, 0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb,
    0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3, 0x748f82ee5defb2fc,
    0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915,
    0xc67178f2e372532b, 0xca273eceea26619c, 0xd186b8c721c0c207,
    0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178, 0x06f067aa72176fba,
    0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc,
    0x431d67c49c100d4c, 0x4cc5d4becb3e42b6, 0x597f299cfc657e2a,
    0x5fcb6fab3ad6faec, 0x6c44198c4a475817]]

_IV512 = [_signed64(v) for v in [
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
    0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
    0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]]
_IV384 = [_signed64(v) for v in [
    0xcbbb9d5dc1059ed8, 0x629a292a367cd507, 0x9159015a3070dd17,
    0x152fecd8f70e5939, 0x67332667ffc00b31, 0x8eb44a8768581511,
    0xdb0c2e0d64f98fa7, 0x47b5481dbefa4fa4]]


def _padded_message(chars: torch.Tensor, lens: torch.Tensor,
                    block_bytes: int, len_bytes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, nblocks*B) padded message matrix + (rows,) block counts.
    `chars` is zero past each row's length.  Only 0x80 and the length
    field's bytes are written into it, one (rows, len_bytes) scatter:
    no matrix wider than a byte per message byte is made."""
    rows, L = chars.shape
    device = chars.device
    maxblocks = max((L + len_bytes + 1 + block_bytes - 1) // block_bytes,
                    1)
    total = maxblocks * block_bytes
    lens = lens.to(_I64)
    nblk = (lens + len_bytes + 1 + block_bytes - 1) // block_bytes
    msg = torch.zeros((rows, total), dtype=torch.uint8, device=device)
    msg[:, :L] = chars
    msg.scatter_(1, lens[:, None], 0x80)
    # big-endian bit length in the trailing len_bytes of the last block
    # (always past the 0x80: nblk leaves room for both)
    lpos = torch.arange(len_bytes, dtype=_I64, device=device)
    shift = (len_bytes - 1 - lpos) * 8
    # a shift by 64 or more is undefined: for the 16-byte SHA-384/512
    # length field only the low 8 bytes can be nonzero for a 64-bit bit
    # length, so the rest are forced to 0
    shift_ok = shift < 64
    lbyte = torch.where(shift_ok, ((lens * 8)[:, None]
                                   >> torch.where(shift_ok, shift, 0))
                        & 0xFF, 0)
    msg.scatter_(1, (nblk * block_bytes - len_bytes)[:, None] + lpos,
                 lbyte.to(torch.uint8))
    return msg, nblk


def _rotr32(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _rotr64(x, n):
    return shr(x, n) | (x << (64 - n))


def _sha2_core(chars, lens, iv, *, bits64: bool) -> List[torch.Tensor]:
    """Shared SHA-256/512 compression: the message blocks, each over
    NR rounds, the 16-word schedule extended as the rounds go."""
    rows = chars.shape[0]
    device = chars.device
    if bits64:
        B, LB, NR, K = 128, 16, 80, _K512
        r1, r2, r3 = (1, 8, 7), (19, 61, 6), (14, 18, 41)
        r0 = (28, 34, 39)
        rot, sh = _rotr64, shr

        def add(*xs):
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
    else:
        B, LB, NR, K = 64, 8, 64, _K256
        r1, r2, r3 = (7, 18, 3), (17, 19, 10), (6, 11, 25)
        r0 = (2, 13, 22)
        rot = _rotr32

        def sh(x, n):
            return x >> n

        def add(*xs):
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out & M32
    msg, nblk = _padded_message(chars, lens, B, LB)
    maxblocks = msg.shape[1] // B
    nbw = B // 16                                  # bytes per word
    # big-endian words: each word's bytes reversed, then read as one
    # little-endian integer of the word's width
    be = msg.reshape(rows, maxblocks * 16, nbw).flip(2).contiguous()
    if bits64:
        words = be.view(_I64).reshape(rows, maxblocks, 16)
    else:
        words = (be.view(torch.int32).to(_I64) & M32).reshape(
            rows, maxblocks, 16)
    del be
    state = [torch.full((rows,), v, dtype=_I64, device=device) for v in iv]
    for b in range(maxblocks):
        w = [words[:, b, t] for t in range(16)]
        a, bb, cc, d, e, f, g, h = state
        for t in range(NR):
            if t >= 16:
                wm15, wm2 = w[t - 15], w[t - 2]
                s0 = rot(wm15, r1[0]) ^ rot(wm15, r1[1]) ^ sh(wm15, r1[2])
                s1 = rot(wm2, r2[0]) ^ rot(wm2, r2[1]) ^ sh(wm2, r2[2])
                w.append(add(w[t - 16], s0, w[t - 7], s1))
                w[t - 16] = None           # the schedule's 16-word window
            S1 = rot(e, r3[0]) ^ rot(e, r3[1]) ^ rot(e, r3[2])
            ch = (e & f) ^ (~e & g)
            t1 = add(h, S1, ch, K[t], w[t])
            S0 = rot(a, r0[0]) ^ rot(a, r0[1]) ^ rot(a, r0[2])
            maj = (a & bb) ^ (a & cc) ^ (bb & cc)
            t2 = add(S0, maj)
            a, bb, cc, d, e, f, g, h = (add(t1, t2), a, bb, cc, add(d, t1),
                                        e, f, g)
        upd = b < nblk
        state = [torch.where(upd, add(s, n), s)
                 for s, n in zip(state, (a, bb, cc, d, e, f, g, h))]
    return state


def _hex_column(state, word_bits: int, out_words: int,
                validity) -> Column:
    """8/6/4-word big-endian state -> lowercase hex strings column,
    built in uint8: each word's bytes reversed out of its little-endian
    image, then two hex digits a byte by arithmetic."""
    rows = state[0].shape[0]
    device = state[0].device
    words = torch.stack(state[:out_words], dim=1)        # (rows, W)
    if word_bits == 32:
        words = words.to(torch.int32)
    nb = word_bits // 8
    be = words.contiguous().view(torch.uint8).reshape(
        rows, out_words, nb).flip(2)
    n = out_words * nb * 2
    nib = torch.stack([be >> 4, be & 0xF], dim=3).reshape(rows, n)
    hexmat = nib + 48 + (nib > 9).to(torch.uint8) * 39   # 0-9, a-f
    if validity is None:
        offs = torch.arange(rows + 1, dtype=torch.int32, device=device) * n
        return Column(dtypes.STRING, rows, data=hexmat.reshape(rows * n),
                      offsets=offs)
    vmask = validity[:rows] != 0
    lens = torch.where(vmask, n, 0)
    offs = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(lens, 0, out=offs[1:])
    return Column(dtypes.STRING, rows, data=hexmat[vmask].reshape(-1),
                  validity=vmask.to(torch.uint8),
                  offsets=offs.to(torch.int32))


def _col_bytes_matrix(col: Column):
    """(rows, L) byte matrix + lengths for string or fixed-width input:
    a fixed-width row hashes the little-endian bytes of its storage,
    matching numpy .tobytes() and cudf's byte-wise SHA of the element.
    Floats hash their IEEE-754 bits (FLOAT64 is native float64), and
    DECIMAL128 its four little-endian limbs, limb 0 first."""
    if col.dtype.is_string:
        return col.to_padded_chars()
    rows = col.length
    itemsize = col.dtype.size_bytes
    data = col.data.contiguous()
    chars = data.view(torch.uint8).reshape(rows, itemsize)
    lens = torch.full((rows,), itemsize, dtype=torch.int32,
                      device=data.device)
    return chars, lens


_SPECS = {224: (_IV224, False, 32, 7), 256: (_IV256, False, 32, 8),
          384: (_IV384, True, 64, 6), 512: (_IV512, True, 64, 8)}


def _sha_device(col: Column, bits: int) -> Column:
    chars, lens = _col_bytes_matrix(col)
    iv, bits64, word_bits, out_words = _SPECS[bits]
    state = _sha2_core(chars, lens, iv, bits64=bits64)
    return _hex_column(state, word_bits, out_words, col.validity)


def sha224_device(col: Column) -> Column:
    return _sha_device(col, 224)


def sha256_device(col: Column) -> Column:
    return _sha_device(col, 256)


def sha384_device(col: Column) -> Column:
    return _sha_device(col, 384)


def sha512_device(col: Column) -> Column:
    return _sha_device(col, 512)
