"""Fixed-capacity inner join on the device, for use inside a compiled
stage: static shapes, a caller-chosen pair capacity, and a true pair
count so overflow is detectable (``total > capacity``; the caller
retries bigger, `parallel/exchange.with_capacity_retry`).

The right side is sorted by key (callers canonicalize floats and
strings to integer ranks first); each left row's run of matches comes
from two searchsorteds over the sorted keys, and pair slot j maps back
to its (left row, offset within the run) by a third searchsorted over
the runs' exclusive prefix sum.  No data-dependent loop, no dynamic
shape: O(P log N) work for P = capacity.
"""

from typing import NamedTuple, Optional

import torch

_I64_MAX = 2**63 - 1


class JoinPairs(NamedTuple):
    left_indices: torch.Tensor   # (capacity,) int32 into the left table
    right_indices: torch.Tensor  # (capacity,) int32 into the right table
    valid: torch.Tensor          # (capacity,) bool: slot holds a pair
    total: torch.Tensor          # () int64 TRUE pair count (may exceed
    #                                capacity: caller must retry bigger)


def inner_join_device(left_keys: torch.Tensor, right_keys: torch.Tensor,
                      capacity: int,
                      left_valid: Optional[torch.Tensor] = None,
                      right_valid: Optional[torch.Tensor] = None
                      ) -> JoinPairs:
    """Inner join on integer key columns, on their device.  Rows with
    valid=False never match (NULL-inequality semantics).  Pairs come in
    left-row order, each left row's matches in right-row order."""
    dev = left_keys.device
    nl = left_keys.shape[0]
    nr = right_keys.shape[0]
    if nl == 0 or nr == 0:
        z = torch.zeros(capacity, dtype=torch.int32, device=dev)
        return JoinPairs(z, z, torch.zeros(capacity, dtype=torch.bool,
                                           device=dev),
                         torch.zeros((), dtype=torch.int64, device=dev))
    lk = left_keys.to(torch.int64)
    rk = right_keys.to(torch.int64)
    if left_valid is None:
        left_valid = torch.ones(nl, dtype=torch.bool, device=dev)
    if right_valid is None:
        right_valid = torch.ones(nr, dtype=torch.bool, device=dev)

    # sort the right side by (invalid, key, row): two stable sorts, the
    # minor key first.  Invalid keys map to INT64_MAX so the sorted keys
    # stay ascending, as searchsorted needs; the n_valid_r clip below
    # breaks the tie when valid keys equal INT64_MAX.
    r_sortkey = torch.where(right_valid, rk, _I64_MAX)
    r_order = torch.sort(r_sortkey, stable=True).indices
    invalid = (~right_valid).to(torch.int32)[r_order]
    r_order = r_order[torch.sort(invalid, stable=True).indices]
    rk_sorted = r_sortkey[r_order]
    n_valid_r = right_valid.sum()

    # each left key's run within the valid prefix
    lo = torch.minimum(torch.searchsorted(rk_sorted, lk), n_valid_r)
    hi = torch.minimum(torch.searchsorted(rk_sorted, lk, right=True),
                       n_valid_r)
    # pair accounting is int64: two 64k-row sides sharing one key are
    # 2^32 pairs, which would wrap int32 and hide the overflow
    counts = torch.where(left_valid, hi - lo, 0)
    offs = torch.cumsum(counts, 0) - counts     # exclusive prefix sum
    total = offs[-1] + counts[-1]

    # pair slot j -> left row i with offs[i] <= j < offs[i+1]; the clips
    # keep every gather index in range, so none can fault on the card
    j = torch.arange(capacity, dtype=torch.int64, device=dev)
    i = (torch.searchsorted(offs, j, right=True) - 1).clamp(0, nl - 1)
    k = j - offs[i]
    valid = (j < total) & (k < counts[i])
    r_pos = (lo[i] + k).clamp(0, nr - 1)
    right_idx = r_order[r_pos].to(torch.int32)
    return JoinPairs(torch.where(valid, i, 0).to(torch.int32),
                     torch.where(valid, right_idx, 0), valid, total)
