"""Hash-keyed inner join engines.

Keys reduce to the device word encoding of ops/joins.py
(`_device_equality_cols`: fixed-width ranks, packed string words and
the length, DECIMAL128 as two words, a mask word before the zeroed
values of a nullable column); one xxhash64 pass over the word columns
gives each row a 64-bit group id; only the RIGHT side is organised (a
bucket table or a sort), so the probe is a gather; candidate pairs are
verified by exact word comparison, so hash quality changes speed only,
never the pairs.

Two engines share that skeleton:

``host_hash_join`` (numpy)
    A direct-address bucket table: ``slot = hash & (m-1)`` with m a
    power of two at load factor <= 1/4, right rows counting-sorted by
    slot, probes resolved by gathers.  When the one key word is an
    integer whose value span fits a small table, the identity is a
    perfect hash: ``slot = key - min``, no collisions and no verify
    (the direct path), a single gather when the build keys are unique.

``device_hash_join`` (the tensors' device)
    The hash ids go through ops/device_join.inner_join_device (sort and
    searchsorted run expansion) at a fixed pair capacity with a true
    count, the equality verify fused after it, and the capacity doubled
    by parallel/exchange.with_capacity_retry when the count says so.
    The capacity that sufficed is remembered per shape, so a steady
    workload whose joins fan out does not relearn it every batch.

Pair order is the same for every engine and for the host rank oracle
(ops/joins._sort_merge_inner_join_host): grouped by left row
ascending, right indices ascending within each group.  A left row's
candidates all carry its one hash, and the right side is sorted stably
by hash, so a collision cannot reorder them.
"""

from typing import List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import joins as J
from spark_rapids_tpu_torch.ops.device_join import inner_join_device
from spark_rapids_tpu_torch.ops.hash import (_XXP5, _signed64,
                                             _xx_finalize, _xx_update8)
from spark_rapids_tpu_torch.parallel.exchange import with_capacity_retry
from spark_rapids_tpu_torch.perf.jit_cache import bucket_rows

JOIN_HASH_SEED = 42

# perfect-hash (direct-address) table budget: the key span must fit a
# table no larger than this many slots AND no larger than a small
# multiple of the data (a sparse 2^40 keyspace must not allocate 2^40
# counters)
DIRECT_MAX_SLOTS = 1 << 23
DIRECT_SPAN_FACTOR = 4


# --------------------------------------------------------------- key prep

def join_key_words(left: Table, right: Table, compare_nulls: str):
    """Per-side int64 word columns and validity for the join keys, on
    the keys' device.

    Mirrors ops/joins._device_ids: nullable key columns (on EITHER
    side) contribute a mask word followed by their zeroed value words,
    and NULL_UNEQUAL rows with any null key become invalid.  Returns
    (lwords, rwords, lvalid, rvalid, digest_extra); raises ValueError
    when a key kind has no word encoding (the router sends those to
    the host rank path)."""
    lwords: List[torch.Tensor] = []
    rwords: List[torch.Tensor] = []
    vl = torch.ones(left.num_rows, dtype=torch.bool, device=left.device)
    vr = torch.ones(right.num_rows, dtype=torch.bool, device=right.device)
    shape = []
    for lc, rc in zip(left.columns, right.columns):
        if lc.dtype.kind != rc.dtype.kind:
            raise ValueError("join key dtypes must match")
        pad = (max(lc.max_string_length(), rc.max_string_length())
               if lc.dtype.kind == Kind.STRING else 0)
        lvals = J._device_equality_cols(lc, pad)
        rvals = J._device_equality_cols(rc, pad)
        if lvals is None or rvals is None:
            raise ValueError(f"no device key path for {lc.dtype}")
        nullable = lc.validity is not None or rc.validity is not None
        if nullable or compare_nulls == J.NULL_UNEQUAL:
            lm, rm = J._col_mask(lc), J._col_mask(rc)
        if nullable:
            lwords.append(lm.to(torch.int64))
            rwords.append(rm.to(torch.int64))
            lwords.extend(torch.where(lm, v, 0) for v in lvals)
            rwords.extend(torch.where(rm, v, 0) for v in rvals)
        else:
            lwords.extend(lvals)
            rwords.extend(rvals)
        if compare_nulls == J.NULL_UNEQUAL:
            vl = vl & lm
            vr = vr & rm
        shape.append(f"{lc.dtype.kind}:{len(lvals)}:{int(nullable)}")
    extra = f"{compare_nulls}|{';'.join(shape)}"
    return lwords, rwords, vl, vr, extra


# ------------------------------------------------------------- key hashes

def key_hashes(words) -> torch.Tensor:
    """(rows,) int64 xxhash64 group ids of int64 word columns, on their
    device: seed 42, plus P5 and the byte length 8k, one 8-byte update a
    word (chained past xxhash64's 32-byte stripe threshold), then the
    avalanche.  Internal group ids only, not the Spark row hash
    (ops/hash.xxhash64 keeps that); u64 values ride in int64 lanes.

    ROADMAP A14: the JAX package compiles this once per power-of-two
    row bucket through its process compile cache; here it runs
    eagerly."""
    rows = int(words[0].shape[0])
    dev = words[0].device
    start = _signed64((JOIN_HASH_SEED + _XXP5 + 8 * len(words))
                      % (1 << 64))
    h = torch.full((rows,), start, dtype=torch.int64, device=dev)
    for w in words:
        h = _xx_update8(h, w.to(torch.int64))
    return _xx_finalize(h)


# ------------------------------------------------------------ host engine

def _expand_runs(starts: np.ndarray, counts: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(left_out, positions) for per-left-row candidate runs: left row
    i contributes counts[i] consecutive positions starts[i]..  One
    np.repeat of the fused (start - exclusive_offset) adjustment plus
    an arange keeps the temporaries to two total-sized arrays."""
    nl = len(counts)
    total = int(counts.sum())
    idx_dtype = np.int32 if total < 2**31 and nl < 2**31 else np.int64
    left_out = np.repeat(np.arange(nl, dtype=idx_dtype), counts)
    ends = np.cumsum(counts, dtype=np.int64)
    adj = starts.astype(np.int64) - (ends - counts)
    pos = np.repeat(adj, counts) + np.arange(total, dtype=np.int64)
    return left_out, pos


def _host_join_from_slots(lslot, rslot, m, lcount_mask, verify,
                          rcounts=None) -> Tuple[np.ndarray, np.ndarray]:
    """Shared bucket-table core: build over right slots, probe with
    left slots, expand runs, then ``verify(left_out, cand)`` filters
    candidate pairs to true matches (None skips the pass: a perfect
    hash).  ``rcounts`` is the caller's ``np.bincount(rslot,
    minlength=m)`` when it has one.  Returns (left_out,
    right_out_in_filtered_space)."""
    nr = len(rslot)
    order_r = np.argsort(rslot, kind="stable")
    if order_r.dtype != np.int32 and nr < 2**31:
        order_r = order_r.astype(np.int32)
    bcount = (np.bincount(rslot, minlength=m) if rcounts is None
              else rcounts)
    bstart = np.zeros(m + 1, np.int64)
    np.cumsum(bcount, out=bstart[1:])
    if nr < 2**31:
        bcount = bcount.astype(np.int32)
        bstart32 = bstart[:-1].astype(np.int32)
    else:  # pragma: no cover - >2^31-row build side
        bstart32 = bstart[:-1]
    starts = bstart32[lslot]
    counts = bcount[lslot]
    if lcount_mask is not None:
        counts = np.where(lcount_mask, counts, 0)
    left_out, pos = _expand_runs(starts, counts)
    cand = order_r[pos]
    if verify is not None:
        eq = verify(left_out, cand)
        if not eq.all():
            left_out = left_out[eq]
            cand = cand[eq]
    return left_out, cand


def host_hash_join(lwords, rwords, lvalid, rvalid
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """numpy bucket-table hash join over host word columns.

    lwords/rwords: lists of (rows,) int64 numpy arrays (the word
    encoding copied to the host); lvalid/rvalid: bool masks
    (NULL_UNEQUAL exclusion).  Returns int32 numpy (left_indices,
    right_indices) in oracle order."""
    nl = len(lwords[0]) if lwords else 0
    nr = len(rwords[0]) if rwords else 0
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
    if nl == 0 or nr == 0 or not lwords:
        return empty

    ridx = None
    if not rvalid.all():
        ridx = np.nonzero(rvalid)[0].astype(np.int32)
        rwords = [w[ridx] for w in rwords]
        nr = len(ridx)
        if nr == 0:
            return empty
    lmask = None if lvalid.all() else lvalid

    # ---- perfect-hash path: one integer word, small value span
    if len(lwords) == 1:
        lo = int(rwords[0].min())
        hi = int(rwords[0].max())
        span = hi - lo + 1
        if span <= min(DIRECT_MAX_SLOTS,
                       max(1 << 16, DIRECT_SPAN_FACTOR * (nl + nr))):
            lk = lwords[0]
            rk0 = rwords[0] - lo if lo else rwords[0]
            bcount = np.bincount(rk0, minlength=span)
            if int(bcount.max()) <= 1:
                # unique build keys (the PK-FK join): the probe is ONE
                # gather through a dense lookup, no run expansion
                lookup = np.full(span, -1, np.int32)
                lookup[rk0] = np.arange(nr, dtype=np.int32)
                if int(lk.min()) >= lo and int(lk.max()) <= hi:
                    cand = lookup[lk - lo if lo else lk]
                else:
                    inr = (lk >= lo) & (lk <= hi)
                    cand = lookup[np.where(inr, lk - lo, 0)]
                    cand = np.where(inr, cand, np.int32(-1))
                ok = cand >= 0
                if lmask is not None:
                    ok &= lmask
                if ok.all():
                    left_out = np.arange(nl, dtype=np.int32)
                    right_out = cand
                else:
                    left_out = np.nonzero(ok)[0].astype(np.int32,
                                                        copy=False)
                    right_out = cand[left_out]
                if ridx is not None:
                    right_out = ridx[right_out]
                return left_out, right_out
            inr = (lk >= lo) & (lk <= hi)
            if lmask is not None:
                inr &= lmask
            lslot = np.where(inr, lk - lo, 0)
            left_out, cand = _host_join_from_slots(
                lslot, rk0, span, inr, None, rcounts=bcount)
            right_out = cand if ridx is None else ridx[cand]
            return (left_out.astype(np.int32, copy=False),
                    right_out.astype(np.int32, copy=False))

    # ---- general path: xxhash64 bucket table + exact verify
    lh = key_hashes([torch.from_numpy(w) for w in lwords]).numpy()
    rh = key_hashes([torch.from_numpy(w) for w in rwords]).numpy()
    m = 1 << min(max(4, int(nr - 1).bit_length() + 2), 26)
    lslot = lh & (m - 1)
    rslot = rh & (m - 1)

    def verify(left_out, cand):
        eq = np.ones(len(left_out), bool)
        for lw, rw in zip(lwords, rwords):
            eq &= lw[left_out] == rw[cand]
        return eq

    left_out, cand = _host_join_from_slots(lslot, rslot, m, lmask,
                                           verify)
    right_out = cand if ridx is None else ridx[cand]
    return (left_out.astype(np.int32, copy=False),
            right_out.astype(np.int32, copy=False))


# ---------------------------------------------------------- device engine

def _device_step_factory(capacity: int):
    """The hash-join program at one pair capacity: pairs of equal hash
    ids, each verified word by word, the true pair count, and the
    overflow flag with_capacity_retry reads.

    ROADMAP A14: the JAX package memoizes this factory per (word count,
    row buckets, digest) so one process compile-cache entry owns each
    capacity's executable; eager PyTorch has nothing to compile."""
    def run(lh, rh, lv, rv, lwords, rwords):
        pairs = inner_join_device(lh, rh, capacity, lv, rv)
        eq = pairs.valid
        for lw, rw in zip(lwords, rwords):
            eq = eq & (lw[pairs.left_indices] == rw[pairs.right_indices])
        overflow = pairs.total > capacity
        return (pairs.left_indices, pairs.right_indices, eq, pairs.total,
                overflow)
    return run


# pair-capacity memo per (digest, words, row buckets): a steady workload
# whose joins fan out (duplicate keys, null-equal clusters) must not
# relearn the budget by doubling from scratch on every batch
_LEARNED_CAPACITY: dict = {}
# the last device_hash_join call's capacities: where it started, what
# sufficed, and the doublings in between
LAST_CAPACITY = {"initial": 0, "used": 0, "doublings": 0}


def device_hash_join(lwords, rwords, lvalid, rvalid, digest_extra: str,
                     initial_capacity=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash join on the words' device: xxhash64 ids, fixed-capacity pair
    expansion (ops/device_join), the fused equality verify, the
    capacity doubled by the exchange retry loop.  Returns int32
    (left_indices, right_indices) in oracle order, compacted on the
    device."""
    nl = int(lwords[0].shape[0]) if lwords else 0
    nr = int(rwords[0].shape[0]) if rwords else 0
    if nl == 0 or nr == 0 or not lwords:
        dev = (lwords or rwords or [lvalid])[0].device
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z
    lh = key_hashes(lwords)
    rh = key_hashes(rwords)
    cap_key = (digest_extra, len(lwords), bucket_rows(nl), bucket_rows(nr))
    cap0 = (int(initial_capacity) if initial_capacity
            else max(1 << max(4, nl.bit_length()),
                     _LEARNED_CAPACITY.get(cap_key, 0)))
    run = with_capacity_retry(_device_step_factory, cap0,
                              overflow_index=-1, max_doublings=20)
    (li, ri, eq, total, _of), cap_used = run(lh, rh, lvalid, rvalid,
                                             lwords, rwords)
    if len(_LEARNED_CAPACITY) > 256:     # bounded memo
        _LEARNED_CAPACITY.clear()
    _LEARNED_CAPACITY[cap_key] = int(cap_used)
    LAST_CAPACITY.update(initial=cap0, used=int(cap_used),
                         doublings=(cap_used // cap0).bit_length() - 1)
    # collisions are rare, so eq is usually the valid prefix
    tot = int(total)
    if tot and bool(eq[:tot].all()):
        return li[:tot], ri[:tot]
    keep = torch.nonzero(eq).squeeze(1)
    return li[keep], ri[keep]
