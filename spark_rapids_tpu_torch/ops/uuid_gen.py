"""random_uuids column generator (reference uuid.cu/uuid.hpp:2): a
strings column of version-4 variant-2 UUIDs.

The bits come from a torch.Generator on the target device seeded with
`seed`: the same (rows, seed, device) gives the same column, but not the
JAX package's bytes (its threefry stream has no torch counterpart) nor
the same bytes on the CPU and the card.  Formatting is nibble-to-hex
byte assembly on the device."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column

_I64 = torch.int64

_UUID_LEN = 36
_DASH_POS = (8, 13, 18, 23)
# output position -> nibble index, -1 for a dash
_OUT_MAP = []
for _pos in range(_UUID_LEN):
    _OUT_MAP.append(-1 if _pos in _DASH_POS
                    else _pos - sum(p < _pos for p in _DASH_POS))
del _pos


def random_uuids(rows: int, seed: int = 0, device="cuda") -> Column:
    """STRING column of random UUIDs (xxxxxxxx-xxxx-4xxx-yxxx-xxxxxxxxxxxx,
    y in 8..b)."""
    g = torch.Generator(device=device).manual_seed(seed)
    words = torch.randint(0, 1 << 32, (rows, 4), generator=g, dtype=_I64,
                          device=device)
    msb = (words[:, 0] << 32) | words[:, 1]
    lsb = (words[:, 2] << 32) | words[:, 3]
    # version 4 + IETF variant
    msb = (msb & -61441) | 0x4000              # & 0xFFFFFFFFFFFF0FFF
    lsb = (lsb & 0x3FFFFFFFFFFFFFFF) | -(1 << 63)
    # 32 hex nibbles, most significant first
    shifts = torch.arange(60, -4, -4, dtype=_I64, device=device)
    nibbles = torch.cat([(msb[:, None] >> shifts) & 0xF,
                         (lsb[:, None] >> shifts) & 0xF], dim=1)
    hex_bytes = torch.where(nibbles < 10, nibbles + 48, nibbles + 87)
    out_map = torch.tensor(_OUT_MAP, dtype=_I64, device=device)
    text = torch.where(out_map >= 0, hex_bytes[:, out_map.clamp(min=0)],
                       45).to(torch.uint8)               # '-'
    offsets = torch.arange(rows + 1, dtype=torch.int32,
                           device=device) * _UUID_LEN
    return Column(dtypes.STRING, rows, data=text.reshape(-1),
                  offsets=offsets)
