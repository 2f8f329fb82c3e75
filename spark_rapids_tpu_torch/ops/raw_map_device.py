"""Device from_json raw map: a multi-capture JSON scan on the column's
device.

Reference: src/main/cpp/src/from_json_to_raw_map.cu:1-894 (kernels
behind JSONUtils.extractRawMapFromJsonString -- every top-level key and
value of a JSON object row into MAP<STRING,STRING>).

Unlike get_json_object/from_json-to-structs (one capture register per
row), raw map needs EVERY depth-1 pair, so this is a scan of its own: a
Python loop over the padded char columns in which each row carries a
token-mode DFA plus a pair cursor, and key/value spans land in
(rows, MAX_PAIRS) registers through pair-index one-hot writes.

Device scope (everything else flags the row to the host oracle,
json_utils.from_json_to_raw_map): flat objects of plain double-quoted
keys and primitive values -- strings without escapes, numbers without
leading zeros, true/false/null.  Nested values, escapes, single quotes,
control characters, >MAX_PAIRS pairs, and potential duplicate keys
(detected after the scan by span length + content probes) all fall back
per row.  Rows whose first non-whitespace byte is not '{' are null
directly (the host nulls every non-object row, valid JSON or not).

Duplicate-key note: raw map keeps the FIRST position but the LAST value
of a duplicated key; rather than cross-compare 32x32 spans on device,
potential duplicates route to the host (false positives only cost a
fallback, never correctness).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.strbuild import (build_string_column,
                                                     host_row_bytes)
from spark_rapids_tpu_torch.ops.json_device import at, run_steps, store

MAX_PAIRS = 32
DEVICE_ROW_CHUNK = 1 << 15   # bounds the (rows, MAX_PAIRS) registers

# DFA modes
_M_PRE = 0        # before '{' (only ws allowed)
_M_KEY_OR_END = 1  # after '{': key quote or '}'
_M_KEY = 2        # inside key string
_M_COLON = 3      # after key: ws then ':'
_M_VAL_START = 4  # ws then a value first-char
_M_VAL_PRIM = 5   # inside number/true/false/null token
_M_VAL_STR = 6    # inside string value
_M_AFTER_VAL = 7  # ws then ',' or '}'
_M_KEY_REQ = 8    # after ',': key quote required
_M_END = 9        # after final '}': only ws allowed

_NUM_W = 26   # validation window: longer primitives fall back

# the scan's carry, in the order step() unpacks and stores it
_CARRY = ("mode", "fb", "npairs", "last_nonws", "ks", "ke", "vs", "ve",
          "vstr")

# statistics from the most recent call: rows sent to the host parse and
# the scan steps (padded width) of each chunk
last_stats = {"rows": 0, "fallback_rows": 0, "chunk_steps": []}


def _scan_raw_map(chars_t: torch.Tensor, lens: torch.Tensor):
    """chars_t: (L, rows) padded chars.  Returns (is_obj, ok, npairs,
    ks, ke, vs, ve, val_is_str): spans are row-relative; ok=False rows
    need the host oracle."""
    L, R = chars_t.shape
    dev = chars_t.device
    pair_lane = torch.arange(MAX_PAIRS, dtype=torch.int64,
                             device=dev)[None, :]
    chars_l = chars_t.to(torch.int64)

    zeros = torch.zeros((R, MAX_PAIRS), dtype=torch.int64, device=dev)
    st = dict(zip(_CARRY, (
        torch.full((R,), _M_PRE, dtype=torch.int64, device=dev),  # mode
        torch.zeros(R, dtype=torch.bool, device=dev),             # fb
        torch.zeros(R, dtype=torch.int64, device=dev),            # npairs
        torch.zeros(R, dtype=torch.int64, device=dev),        # last_nonws
        zeros, zeros.clone(), zeros.clone(), zeros.clone(),  # ks ke vs ve
        torch.zeros((R, MAX_PAIRS), dtype=torch.bool, device=dev))))

    def step(j, in_place):
        mode, fb, npairs, last_nonws, ks, ke, vs, ve, vstr = (
            st[k] for k in _CARRY)
        c = at(chars_l, j)
        in_row = lens > j
        is_ws = (c == 32) | (c == 9) | (c == 10) | (c == 13)
        bad_ctrl = (c < 0x20) & ~is_ws
        high = c >= 0x80
        lane_at = pair_lane == npairs[:, None]

        def put(reg, val, active):
            return torch.where(lane_at & active[:, None],
                               torch.as_tensor(val, device=dev).expand(
                                   R)[:, None], reg)

        act = in_row & ~fb
        m_pre, m_koe, m_key, m_col, m_vs, m_vp, m_vstr, m_after, \
            m_kreq, m_end = (act & (mode == v) for v in range(10))

        # _M_PRE: ws* then '{' (anything else parks the row: null)
        to_obj = m_pre & (c == 123)
        pre_other = m_pre & ~is_ws & (c != 123)

        # key start / object end
        key_ok = m_koe | m_kreq
        kq = key_ok & (c == 34)
        obj_end_early = m_koe & (c == 125)
        key_bad = key_ok & ~is_ws & (c != 34) & ~obj_end_early

        # inside key
        key_end = m_key & (c == 34)
        key_esc = m_key & ((c == 92) | bad_ctrl | high)

        # colon
        colon = m_col & (c == 58)
        colon_bad = m_col & ~is_ws & (c != 58)

        # value start
        vschar = m_vs & ~is_ws
        v_str = vschar & (c == 34)
        v_nest = vschar & ((c == 123) | (c == 91))
        v_prim_ok = vschar & (((c >= 48) & (c <= 57)) | (c == 45)
                              | (c == 116) | (c == 102) | (c == 110))
        v_bad = vschar & ~v_str & ~v_nest & ~v_prim_ok

        # inside string value
        vs_end = m_vstr & (c == 34)
        vs_esc = m_vstr & ((c == 92) | bad_ctrl | high)

        # inside primitive value: ends at ws, ',' or '}'
        vp_delim = m_vp & (is_ws | (c == 44) | (c == 125))
        vp_bad = m_vp & (bad_ctrl | (c == 91) | (c == 123) | (c == 34))

        # after value
        more = (m_after & (c == 44)) | (vp_delim & (c == 44))
        obj_end = (m_after & (c == 125)) | (vp_delim & (c == 125)) \
            | obj_end_early
        after_bad = m_after & ~is_ws & (c != 44) & (c != 125)

        # after '}': only trailing ws
        end_bad = m_end & ~is_ws

        new_fb = fb | key_esc | vs_esc | colon_bad | v_bad | v_nest \
            | vp_bad | after_bad | end_bad | key_bad \
            | (kq & (npairs >= MAX_PAIRS))

        # span writes (one-hot at the current pair index)
        ks = put(ks, j + 1, kq)
        ke = put(ke, j, key_end)
        v_any = v_str | v_prim_ok
        vs = put(vs, torch.where(v_str, j + 1, j), v_any)
        # string value end: at the closing quote; primitive end: the
        # last non-ws position + 1
        ve = put(ve, j, vs_end)
        ve = put(ve, last_nonws + 1, vp_delim)
        vstr = torch.where(lane_at & v_any[:, None], v_str[:, None], vstr)

        n_npairs = npairs + (vs_end | vp_delim).to(torch.int64)
        n_last = torch.where(m_vp & ~is_ws & ~vp_delim, j, last_nonws)

        mode_new = torch.where(
            to_obj, _M_KEY_OR_END,
            torch.where(kq, _M_KEY,
            torch.where(key_end, _M_COLON,
            torch.where(colon, _M_VAL_START,
            torch.where(v_str, _M_VAL_STR,
            torch.where(v_prim_ok, _M_VAL_PRIM,
            torch.where(vs_end, _M_AFTER_VAL,
            torch.where(vp_delim & ~more & (c != 125), _M_AFTER_VAL,
            torch.where(more, _M_KEY_REQ,
            torch.where(obj_end, _M_END, mode))))))))))
        # a non-'{' first char parks the row in _M_PRE for good, as a
        # null row rather than a fallback
        store(st, (torch.where(act & ~pre_other, mode_new, mode),
                   torch.where(pre_other, fb, new_fb), n_npairs, n_last,
                   ks, ke, vs, ve, vstr), in_place)

    run_steps(step, L, dev)
    mode, fb, npairs, _ln, ks, ke, vs, ve, vstr = (st[k] for k in _CARRY)

    # structural completion: mode must be _M_END (or _M_PRE for
    # non-object rows); unterminated rows are invalid -> null (the host
    # agrees: invalid JSON nulls the row), EXCEPT fb rows (host decides)
    return mode == _M_END, ~fb, npairs, ks, ke, vs, ve, vstr


def _prim_rules(s: int, c: int) -> int:
    dig = 48 <= c <= 57
    new = 8
    if s == 0 and c == 45:
        new = 1
    if s in (0, 1, 2) and dig:
        new = 2
    if s == 2 and c == 46:
        new = 3
    if s in (3, 4) and dig:
        new = 4
    if s in (2, 4) and c in (101, 69):
        new = 5
    if s == 5 and c in (43, 45):
        new = 6
    if s in (5, 6, 7) and dig:
        new = 7
    return new


@functools.lru_cache(maxsize=8)
def _num_table(device) -> torch.Tensor:
    """(9, 256) strict JSON number DFA: 0 start, 1 after '-', 2 int
    digits, 3 after '.', 4 frac digits, 5 after e, 6 after e-sign,
    7 exp digits, 8 reject."""
    return torch.tensor([[_prim_rules(s, c) for c in range(256)]
                         for s in range(9)], dtype=torch.int64,
                        device=device)


def _primitive_token_ok(chars: torch.Tensor, vs, ve, pvalid
                        ) -> torch.Tensor:
    """Per-pair primitive validation: exact true/false/null, or the
    strict JSON number grammar run as a small DFA over a fixed window
    (anything else -- NaN, hex, overlong -- host decides).  Returns the
    (R, MAX_PAIRS) ok mask (True where not a primitive)."""
    R, L = chars.shape
    dev = chars.device
    tok_len = torch.where(pvalid, ve - vs, 0)
    w = torch.arange(_NUM_W, device=dev)
    win_idx = (vs[:, :, None] + w[None, None, :]).clamp(max=L - 1)
    win = chars[torch.arange(R, device=dev)[:, None, None], win_idx] \
        .to(torch.int64)
    inlen = w[None, None, :] < tok_len[:, :, None]
    win = torch.where(inlen, win, 0)

    def is_word(word: bytes):
        m = tok_len == len(word)
        for i, b in enumerate(word):
            m = m & (win[:, :, i] == b)
        return m

    word_ok = is_word(b"true") | is_word(b"false") | is_word(b"null")
    tbl = _num_table(dev)
    state = torch.zeros(tok_len.shape, dtype=torch.int64, device=dev)
    for i in range(_NUM_W):
        state = torch.where(inlen[:, :, i], tbl[state, win[:, :, i]],
                            state)
    num_ok = ((state == 2) | (state == 4) | (state == 7)) \
        & (tok_len <= _NUM_W)
    return ~pvalid | word_ok | num_ok


def _dup_key_suspects(chars: torch.Tensor, ks, ke, npairs
                      ) -> torch.Tensor:
    """Rows that MIGHT contain duplicate keys (probe: length + first/
    last byte); false positives just fall back to host."""
    R, L = chars.shape
    dev = chars.device
    lane = torch.arange(MAX_PAIRS, device=dev)[None, :]
    rr = torch.arange(R, device=dev)[:, None]
    valid = lane < npairs[:, None]
    klen = torch.where(valid, ke - ks, -lane)      # unique when empty
    first = torch.where(valid, chars[rr, ks.clamp(max=L - 1)].to(
        torch.int64), 0)
    last = torch.where(valid, chars[rr, (ke - 1).clamp(0, L - 1)].to(
        torch.int64), 0)
    probe = (klen << 32) | (first << 16) | last
    srt = torch.sort(torch.where(valid, probe, lane - 100_000), dim=1
                     ).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    return dup & (npairs > 1)


def from_json_to_raw_map_device(col: Column,
                                allow_leading_zeros: bool = False
                                ) -> Optional[Column]:
    """Device raw-map extraction; None -> the caller must run the host
    path entirely (the router in json_utils handles that)."""
    if col.length == 0:
        return None

    from spark_rapids_tpu_torch.ops.json_path import _Invalid, _Parser
    from spark_rapids_tpu_torch.ops.json_utils import _raw_pairs

    rows = col.length
    dev = col.device
    in_valid_all = col.valid_mask()
    counts_p: List[torch.Tensor] = []
    valid_p: List[torch.Tensor] = []
    key_parts: List[Column] = []
    val_parts: List[Column] = []
    steps = []
    n_host = 0

    for b0 in range(0, rows, DEVICE_ROW_CHUNK):
        b1 = min(rows, b0 + DEVICE_ROW_CHUNK)
        R = b1 - b0
        sub = Column(col.dtype, R, data=col.data,
                     offsets=col.offsets[b0:b1 + 1])
        chars, lens = sub.to_padded_chars()
        L = chars.shape[1]
        steps.append(L)
        is_obj, ok, npairs, ks, ke, vs, ve, vstr = _scan_raw_map(
            chars.T.contiguous(), lens)
        in_valid = in_valid_all[b0:b1]

        # Spark leading-zero number rule: the scan is agnostic, so rows
        # with a primitive value '0<digit>...' fall back to the host
        # parser (which owns the allow_leading_zeros knob)
        lane = torch.arange(MAX_PAIRS, device=dev)[None, :]
        pvalid = (lane < npairs[:, None]) & ~vstr
        rr = torch.arange(R, device=dev)[:, None]
        c0 = chars[rr, vs.clamp(max=L - 1)]
        c1 = chars[rr, (vs + 1).clamp(max=L - 1)]
        neg = c0 == 45
        d0 = torch.where(neg, c1, c0)
        lead_zero = pvalid & (d0 == 48) & \
            ((ve - vs) > (1 + neg.to(torch.int64)))
        ok = ok & ~lead_zero.any(1)
        ok = ok & _primitive_token_ok(chars, vs, ve, pvalid).all(1)
        ok = ok & ~_dup_key_suspects(chars, ks, ke, npairs)

        # host fallback rows: parse once per row, Spark semantics; only
        # these rows' bytes cross to the host
        host_rows = torch.nonzero(in_valid & ~ok).squeeze(1)
        host_maps = {}
        for hi, raw in zip(host_rows.tolist(),
                           host_row_bytes(sub, host_rows)):
            try:
                tree = _Parser(raw.decode("utf-8", errors="replace"),
                               allow_leading_zeros).parse()
            except _Invalid:
                tree = None
            host_maps[hi] = (None if tree is None or tree[0] != "obj"
                             else _raw_pairs(tree))
        n_host += len(host_maps)

        dev_ok = in_valid & ok & is_obj
        c_counts = torch.where(dev_ok, npairs, 0)
        valid_rows = dev_ok.clone()
        hp = [(i, p) for i, p in host_maps.items() if p is not None]
        if hp:
            hi = torch.tensor([i for i, _ in hp], dtype=torch.int64,
                              device=dev)
            c_counts[hi] = torch.tensor([len(p) for _, p in hp],
                                        dtype=torch.int64, device=dev)
            valid_rows[hi] = True
        counts_p.append(c_counts)
        valid_p.append(valid_rows)

        # flat pair stream (row-major): device spans + host patches
        lane_valid = (lane < npairs[:, None]) & dev_ok[:, None]
        pair_base = torch.zeros(R + 1, dtype=torch.int64, device=dev)
        torch.cumsum(c_counts, 0, out=pair_base[1:])
        total_pairs = int(pair_base[-1])
        fp_row, fp_lane = torch.nonzero(lane_valid, as_tuple=True)
        gidx = pair_base[fp_row] + fp_lane
        k_start, k_len, v_start, v_len = (
            torch.zeros(total_pairs, dtype=torch.int64, device=dev)
            for _ in range(4))
        k_start[gidx] = fp_row * L + ks[fp_row, fp_lane]
        k_len[gidx] = (ke - ks)[fp_row, fp_lane]
        v_start[gidx] = fp_row * L + vs[fp_row, fp_lane]
        v_len[gidx] = (ve - vs)[fp_row, fp_lane]
        key_patch, val_patch = {}, {}
        bases = pair_base[[i for i, _ in hp]].tolist() if hp else []
        for (_i, pairs), b in zip(hp, bases):
            for p, (k, v) in enumerate(pairs):
                key_patch[b + p] = k
                val_patch[b + p] = v
        flat = chars.reshape(-1)
        key_parts.append(build_string_column(flat, k_start, k_len, None,
                                             key_patch or None))
        val_parts.append(build_string_column(flat, v_start, v_len, None,
                                             val_patch or None))

    if len(key_parts) == 1:
        keys_col, vals_col = key_parts[0], val_parts[0]
    else:
        from spark_rapids_tpu_torch.ops.copying import concat_columns
        keys_col = concat_columns(key_parts)
        vals_col = concat_columns(val_parts)
    last_stats.update(rows=rows, fallback_rows=n_host, chunk_steps=steps)

    counts = torch.cat(counts_p)
    offs = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offs[1:])
    valid = torch.cat(valid_p)
    st = Column.make_struct(keys_col.length, [keys_col, vals_col])
    return Column(dtypes.LIST, rows,
                  validity=None if bool(valid.all())
                  else valid.to(torch.uint8),
                  offsets=offs.to(torch.int32), children=(st,))
