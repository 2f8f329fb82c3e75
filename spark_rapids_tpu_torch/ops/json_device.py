"""Device get_json_object: a per-row JSON pushdown automaton on the
column's device.

Reference: get_json_object.cu:820-888 (thread-per-row pull-parse kernel)
and json_parser.cuh (tolerant parser).  As in the JAX package, one scan
over the padded char axis carries, for every row of a chunk at once:

  * a tolerant-JSON validity DFA (single quotes, unescaped control
    chars, Spark leading-zero number rules),
  * a bounded container stack (type / path-position / element ordinal)
    implementing JSONPath evaluation with Spark's implicit array
    flattening under named access,
  * capture registers for the matched value's byte span, and
  * "verbatim-safety" flags telling whether the matched span can be
    copied byte-for-byte (the overwhelmingly common case for compact
    machine JSON).

The scan is a Python loop over the chunk's L+1 char columns (the last
one a virtual terminator), each step one pass of elementwise tensor ops
over the carry.  Key-name and literal-token recognition is hoisted out
of the loop as shifted-window equality over the padded chars, so each
step reads a precomputed "key-matches-here" lane.  Each chunk of
DEVICE_ROW_CHUNK rows is padded on its own, to its own longest row: a
long document sets the step count of its chunk only.

Rows whose rendering needs host work (Java double normalization of
fractional numbers, escape rewriting, whitespace-stripped re-rendering,
multiple wildcard matches, nesting deeper than the tracked stack) are
flagged and routed through the host evaluator in ops/json_path.py --
per-row fallback, never whole-column; only those rows' bytes cross to
the host.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.strbuild import (build_string_column,
                                                     host_row_bytes)

MAX_NEST_TRACK = 16   # container stack depth tracked on device; deeper
                      # rows fall back to host (path depth is <=16)
DEVICE_ROW_CHUNK = 1 << 17  # rows per scan (bounds stack memory)
_WINDOW_PAD = 64      # zero rows past the terminator for window probes

# parser DFA states
_PS_VALUE = 0        # expect a value (root / after '[', ',', ':')
_PS_VAL_OR_CLOSE = 1  # just after '[': value or ']'
_PS_KEY_OR_CLOSE = 2  # just after '{': key or '}'
_PS_KEY = 3          # after ',' in object: key required
_PS_COLON = 4        # after key: ':' required
_PS_AFTER = 5        # after a value: ',' / close / end
_PS_PRIM = 6         # consuming a number token
_PS_LIT = 7          # consuming the tail of true/false/null

# number DFA states
_N_SIGN, _N_ZERO, _N_DIG, _N_DOT, _N_FRAC, _N_E, _N_ESIGN, _N_EDIG, \
    _N_BAD = range(1, 10)

# match kinds
_K_STR, _K_NUM, _K_LIT, _K_OBJ, _K_ARR = range(5)

# path instruction kinds
_INS_NAMED, _INS_INDEX, _INS_WILD = range(3)

# char class bits (one table lookup per step instead of a chain of
# compares)
_C_HEX, _C_ESC_SAFE, _C_ESC_OK, _C_NUMCONT, _C_WS, _C_LITSTART, \
    _C_NUMSTART, _C_QUOTE, _C_STRUCT, _C_FLOATCH = (1 << i for i in range(10))


def _class_table() -> List[int]:
    t = [0] * 256
    for c in b"0123456789abcdefABCDEF":
        t[c] |= _C_HEX
    for c in b'"\\nrt':
        t[c] |= _C_ESC_SAFE | _C_ESC_OK
    for c in b"'/bfu":
        t[c] |= _C_ESC_OK
    for c in b"0123456789.eE+-":
        t[c] |= _C_NUMCONT
    for c in b".eE":
        t[c] |= _C_FLOATCH
    for c in b" \t\n\r":
        t[c] |= _C_WS
    for c in b"tfn":
        t[c] |= _C_LITSTART
    for c in b"0123456789-":
        t[c] |= _C_NUMSTART
    for c in b"\"'":
        t[c] |= _C_QUOTE
    for c in b" \t\n\r{}[],:\"'0123456789-tfn":
        t[c] |= _C_STRUCT
    return t


def _num_table(allow_leading_zeros: bool) -> List[int]:
    """(10 * 256) number-DFA transitions: state * 256 + char -> state
    (states 0 and _N_BAD have no way out)."""
    t = [0] * (10 * 256)
    for s in range(10):
        for c in range(256):
            d = 48 <= c <= 57
            dot = c == 46
            ee = c in (101, 69)
            pm = c in (43, 45)
            ns = s
            if s == _N_SIGN:
                ns = _N_ZERO if c == 48 else (_N_DIG if d else _N_BAD)
            elif s == _N_ZERO:
                ns = _N_DOT if dot else _N_E if ee else (
                    (_N_DIG if d else _N_BAD) if allow_leading_zeros
                    else _N_BAD)
            elif s == _N_DIG:
                ns = _N_DIG if d else _N_DOT if dot else \
                    _N_E if ee else _N_BAD
            elif s in (_N_DOT, _N_FRAC):
                ns = _N_FRAC if d else _N_E if ee else _N_BAD
            elif s == _N_E:
                ns = _N_EDIG if d else _N_ESIGN if pm else _N_BAD
            elif s in (_N_ESIGN, _N_EDIG):
                ns = _N_EDIG if d else _N_BAD
            t[s * 256 + c] = ns
    return t


@functools.lru_cache(maxsize=16)
def _tables(device, allow_leading_zeros: bool):
    """(class bits, number transitions, number-accepting states, the
    number DFA's start state per char) as tensors on `device`, built
    once per device."""
    cls = torch.tensor(_class_table(), dtype=torch.int32, device=device)
    num = torch.tensor(_num_table(allow_leading_zeros), dtype=torch.int64,
                       device=device)
    accept = torch.zeros(10, dtype=torch.bool, device=device)
    accept[[_N_ZERO, _N_DIG, _N_DOT, _N_FRAC, _N_EDIG]] = True
    start = torch.full((256,), _N_DIG, dtype=torch.int64, device=device)
    start[45] = _N_SIGN
    start[48] = _N_ZERO
    return cls, num, accept, start


def _compile_path(instructions) -> Tuple:
    """Static spec describing the path for embedding into the scan."""
    from spark_rapids_tpu_torch.ops.json_path import Index, Named
    P = len(instructions)
    kinds, idxv, names = [], [], []
    for ins in instructions:
        if isinstance(ins, Named):
            kinds.append(_INS_NAMED)
            idxv.append(0)
            names.append(ins.name.encode("utf-8"))
        elif isinstance(ins, Index):
            kinds.append(_INS_INDEX)
            idxv.append(ins.index)
            names.append(b"")
        else:
            kinds.append(_INS_WILD)
            idxv.append(0)
            names.append(b"")
    return (P, tuple(kinds), tuple(idxv), tuple(names))


class PaddedChunk:
    """One row chunk's chars, padded and transposed: ``ext`` is
    (L+1+pad, rows) uint8 -- row r's bytes down column r, then zeros
    (the terminator at L and the window pad after it)."""
    __slots__ = ("r0", "r1", "L1", "ext", "lens")

    def __init__(self, r0, r1, L1, ext, lens):
        self.r0, self.r1, self.L1, self.ext, self.lens = \
            r0, r1, L1, ext, lens

    @property
    def chars_t(self) -> torch.Tensor:
        """(L+1, rows): the scanned char columns, terminator included."""
        return self.ext[:self.L1]

    def window(self, k: int) -> torch.Tensor:
        """(L+1, rows): the chars k positions on (zeros past the end)."""
        if k + self.L1 > self.ext.shape[0]:
            more = k + self.L1 - self.ext.shape[0]
            self.ext = torch.cat([self.ext, torch.zeros(
                (more, self.ext.shape[1]), dtype=torch.uint8,
                device=self.ext.device)])
        return self.ext[k:k + self.L1]


def _pad_chunk(col: Column, r0: int, r1: int) -> PaddedChunk:
    offs = col.offsets[r0:r1 + 1].to(torch.int64)
    lens = offs[1:] - offs[:-1]
    R = r1 - r0
    L = int(lens.max()) if R else 0
    L1 = L + 1
    dev = offs.device
    j = torch.arange(L1 + _WINDOW_PAD, dtype=torch.int64, device=dev)
    idx = offs[None, :-1] + j[:, None]
    in_row = j[:, None] < lens[None, :]
    n = col.data.shape[0]
    if n:
        ext = torch.where(in_row, col.data[idx.clamp_(0, n - 1)], 0)
    else:
        ext = torch.zeros(idx.shape, dtype=torch.uint8, device=dev)
    return PaddedChunk(r0, r1, L1, ext.to(torch.uint8).contiguous(), lens)


def padded_chunks(col: Column) -> List[PaddedChunk]:
    """The column's DEVICE_ROW_CHUNK-row chunks, each padded to its own
    longest row: built once and shared by every path's scan."""
    return [_pad_chunk(col, r0, min(col.length, r0 + DEVICE_ROW_CHUNK))
            for r0 in range(0, col.length, DEVICE_ROW_CHUNK)]


# the scan's carry, in the order step() unpacks and stores it
_CARRY = ("qs", "esc", "u_rem", "ps", "valid", "depth", "pend", "is_key",
          "key_match", "key_live", "pstate", "pneg", "pfloat", "lrem",
          "sact", "mcount", "mstart", "mend", "mkind", "mdepth", "mfloat",
          "mneg", "f_ws", "f_sq", "f_escun", "f_ctrl", "f_anyesc",
          "f_float", "f_negz", "fb", "s_isobj", "s_cvpos", "s_elem")


def store(st, values, in_place: bool) -> None:
    """Write a step's new carry into `st`: by assignment, or into the
    existing tensors (a CUDA graph replays on fixed buffers)."""
    for k, v in zip(st, values):
        if not in_place:
            st[k] = v
        elif v is not st[k]:
            st[k].copy_(v)


def at(t: torch.Tensor, j) -> torch.Tensor:
    """Row j of `t`: j an int, or a (1,) device tensor (a gather, since
    a 0-dim index would be read back to the host)."""
    if isinstance(j, int):
        return t[j]
    return t.index_select(0, j).squeeze(0)


def run_steps(step, steps: int, device) -> None:
    """step(0), ..., step(steps - 1).  On a CUDA device the first step
    runs eagerly, then one step (the char index a device counter) is
    captured as a CUDA graph and replayed for the rest: the same kernels,
    launched once per step instead of a few hundred times."""
    dev = torch.device(device)
    if dev.type != "cuda" or steps < 2:
        for j in range(steps):
            step(j, False)
        return
    j_t = torch.zeros(1, dtype=torch.int64, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(j_t, True)
        j_t += 1
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(j_t, True)
        j_t += 1
    for _ in range(steps - 1):
        graph.replay()


def _scan_chunk(pc: PaddedChunk, path_key, allow_leading_zeros=False):
    """The path-matching scan over one padded chunk: (valid, mcount,
    mstart, mend, mkind, mfloat, mneg, f_ws, f_sq, f_escun, f_ctrl,
    f_anyesc, f_float, f_negz, fb), each (rows,) on the chunk's
    device; spans are row-relative."""
    P, kinds, idxv, names = path_key
    D = MAX_NEST_TRACK
    chars_t = pc.chars_t
    L1, rows = chars_t.shape
    dev = chars_t.device
    cls_t, num_t, accept_t, start_t = _tables(dev, allow_leading_zeros)
    lens = pc.lens.to(torch.int32)

    # distinct named instructions -> lane in the hoisted KEYEQ block
    name_lanes: List[bytes] = []
    lane_of = []
    for k, nm in zip(kinds, names):
        if k == _INS_NAMED:
            if nm not in name_lanes:
                name_lanes.append(nm)
            lane_of.append(name_lanes.index(nm))
        else:
            lane_of.append(-1)

    # ---- hoisted recognition lanes (shifted-window equalities) ----
    # KEYEQ[lane]: at j, chars[j] is a quote opening a string whose raw
    # bytes equal the lane's name, closed by the same quote
    is_quote0 = (chars_t == 34) | (chars_t == 39)
    keyeqs = []
    for nm in name_lanes:
        m = is_quote0.clone()
        for k, b in enumerate(nm):
            m &= pc.window(1 + k) == b
        m &= pc.window(1 + len(nm)) == chars_t
        keyeqs.append(m)
    # LITOK: at j, bytes spell true/false/null exactly
    lit_ok = torch.zeros_like(is_quote0)
    lit_len = torch.zeros(chars_t.shape, dtype=torch.int32, device=dev)
    for word in (b"true", b"false", b"null"):
        m = torch.ones_like(is_quote0)
        for k, b in enumerate(word):
            m &= pc.window(k) == b
        lit_ok |= m
        lit_len = torch.where(m, len(word), lit_len)
    cls_all = cls_t[chars_t.to(torch.int64)]
    chars_i = chars_t.to(torch.int64)

    # per-path-position lookups, indexed by pv + 1 (pv in [-1, P-1])
    def lut(vals, default, dtype):
        return torch.tensor([default] + list(vals), dtype=dtype,
                            device=dev)
    named_l = lut([k == _INS_NAMED for k in kinds], False, torch.bool)
    wild_l = lut([k == _INS_WILD for k in kinds], False, torch.bool)
    idx_l = lut(idxv, -1, torch.int32)
    lane_l = lut(lane_of, -1, torch.int32)

    i32 = dict(dtype=torch.int32, device=dev)
    zb = torch.zeros(rows, dtype=torch.bool, device=dev)
    d_iota = torch.arange(D, **i32)[None, :]
    st = dict(zip(_CARRY, (
        torch.zeros(rows, **i32),                        # qs
        zb.clone(),                                      # esc
        torch.zeros(rows, **i32),                        # u_rem
        torch.full((rows,), _PS_VALUE, **i32),           # ps
        torch.ones(rows, dtype=torch.bool, device=dev),  # valid
        torch.zeros(rows, **i32),                        # depth
        torch.full((rows,), -1, **i32),                  # pend
        zb.clone(), zb.clone(), zb.clone(),  # is_key, key_match, key_live
        torch.zeros(rows, dtype=torch.int64, device=dev),  # pstate
        zb.clone(), zb.clone(),                          # pneg, pfloat
        torch.zeros(rows, **i32),                        # lrem
        zb.clone(),                                      # sact
        torch.zeros(rows, **i32),                        # mcount
        torch.zeros(rows, **i32),                        # mstart
        torch.zeros(rows, **i32),                        # mend
        torch.zeros(rows, **i32),                        # mkind
        torch.full((rows,), -1, **i32),                  # mdepth
        zb.clone(), zb.clone(),                          # mfloat, mneg
        *(zb.clone() for _ in range(8)),                 # f_ws .. fb
        torch.zeros((rows, D), dtype=torch.bool, device=dev),  # s_isobj
        torch.full((rows, D), -1, **i32),                # s_cvpos
        torch.zeros((rows, D), **i32))))                 # s_elem

    def step(j, in_place):
        """One char column: j is its index (an int, or a (1,) device
        tensor under a CUDA graph); the carry in `st` is updated."""
        (qs, esc, u_rem, ps, valid, depth, pend, is_key, key_match,
         key_live, pstate, pneg, pfloat, lrem, sact, mcount, mstart, mend,
         mkind, mdepth, mfloat, mneg, f_ws, f_sq, f_escun, f_ctrl,
         f_anyesc, f_float, f_negz, fb, s_isobj, s_cvpos, s_elem) = (
            st[k] for k in _CARRY)

        c = at(chars_i, j)
        cl = at(cls_all, j)
        active = lens > j
        at_end = lens == j
        act_end = active | at_end
        in_str = qs > 0

        # one-hot stack lanes: the parent slot
        ohd1 = d_iota == (depth - 1)[:, None]
        pv = torch.where(ohd1, s_cvpos, 0).sum(1, dtype=torch.int32)
        p_isobj = (ohd1 & s_isobj).any(1)
        pelem = torch.where(ohd1, s_elem, 0).sum(1, dtype=torch.int32)

        # ---------------------------------------- inside a string
        is_hex = (cl & _C_HEX) != 0
        esc_safe = (cl & _C_ESC_SAFE) != 0
        esc_ok = (cl & _C_ESC_OK) != 0
        quote_ch = torch.where(qs == 1, 34, 39)
        live_str = in_str & active
        s_esc = live_str & esc
        plain = live_str & ~esc
        s_hex = plain & (u_rem > 0)
        base = plain & (u_rem == 0)
        s_close = base & (c == quote_ch)
        s_open_esc = base & (c == 92)
        s_content = base & ~s_close & ~s_open_esc
        span = sact | (mdepth >= 0)

        valid &= ~(s_esc & ~esc_ok)
        valid &= ~(s_hex & ~is_hex)
        n_urem = torch.where(s_esc & (c == 117), 4,
                             torch.where(s_hex, u_rem - 1, u_rem))
        n_esc = s_open_esc | (esc & ~(s_esc | s_hex | s_close | s_content))
        f_anyesc |= s_open_esc & span
        f_escun |= s_esc & ~esc_safe & span
        fb |= s_open_esc & is_key & key_live
        f_ctrl |= s_content & (c < 0x20) & span

        # string end: key -> expect colon; value -> after-value
        end_key = s_close & is_key
        end_val = s_close & ~is_key
        n_pend = torch.where(
            end_key, torch.where(key_live & key_match, pv + 1, -1), pend)
        ps = torch.where(end_key, _PS_COLON,
                         torch.where(end_val, _PS_AFTER, ps))
        mend = torch.where(end_val & sact, j + 1, mend)
        n_sact = sact & ~end_val
        n_qs = torch.where(s_close, 0, qs)
        n_is_key = is_key & ~s_close

        # ------------------------------------ number continuation
        num_here = ~in_str & (ps == _PS_PRIM) & act_end
        p_cont = num_here & ((cl & _C_NUMCONT) != 0)
        ns = num_t[pstate * 256 + c]
        n_pstate = torch.where(p_cont, ns, pstate)
        n_pfloat = pfloat | (p_cont & ((cl & _C_FLOATCH) != 0))

        # number termination (the terminator char falls through to the
        # structural logic below with ps already AFTER_VALUE)
        p_term = num_here & ~p_cont
        valid &= ~(p_term & ~accept_t[pstate])
        negzero = pneg & (pstate == _N_ZERO)
        f_float |= p_term & pfloat & span
        f_negz |= p_term & negzero & span
        cap = p_term & n_sact
        mend = torch.where(cap, j, mend)
        mfloat = torch.where(cap, pfloat, mfloat)
        mneg = torch.where(cap, negzero, mneg)
        n_sact &= ~p_term
        ps = torch.where(p_term, _PS_AFTER, ps)
        n_pstate = torch.where(p_term, 0, n_pstate)

        # literal tail: count down remaining pre-validated chars
        lit_here = ~in_str & (ps == _PS_LIT) & active
        n_lrem = torch.where(lit_here, lrem - 1, lrem)
        ps = torch.where(lit_here & (n_lrem == 0), _PS_AFTER, ps)

        # ------------------------------------------ structural chars
        # (includes the virtual terminator at j == lens)
        struct_here = ~in_str & ~p_cont & ~lit_here & (ps != _PS_LIT) \
            & act_end
        sa = struct_here & active
        is_ws = sa & ((cl & _C_WS) != 0)
        f_ws |= is_ws & (mdepth >= 0)

        open_obj = sa & (c == 123)
        open_arr = sa & (c == 91)
        close_obj = sa & (c == 125)
        close_arr = sa & (c == 93)
        comma = sa & (c == 44)
        colon = sa & (c == 58)
        quote = sa & ((cl & _C_QUOTE) != 0)
        num_start = sa & ((cl & _C_NUMSTART) != 0)
        lit_start = sa & ((cl & _C_LITSTART) != 0)
        valid &= ~(sa & ((cl & _C_STRUCT) == 0))

        can_value = (ps == _PS_VALUE) | (ps == _PS_VAL_OR_CLOSE)
        can_key = (ps == _PS_KEY_OR_CLOSE) | (ps == _PS_KEY)
        push = open_obj | open_arr
        prim_start = num_start | lit_start
        val_start = (push | quote | prim_start) & can_value
        key_start = quote & can_key
        valid &= ~(((push | prim_start) & ~can_value)
                   | (quote & ~can_value & ~can_key))

        # value path position
        pvi = (pv + 1).clamp(0, P).to(torch.int64)
        p_named = named_l[pvi]
        arr_v = torch.where(
            p_named, pv,
            torch.where(wild_l[pvi] | (pelem == idx_l[pvi]), pv + 1, -1))
        arr_v = torch.where(pv >= 0, arr_v, -1)
        v = torch.where(depth == 0, 0, torch.where(p_isobj, pend, arr_v))
        v = torch.where(val_start, v, -1)

        is_match = val_start & (v == P)
        mcount += is_match.to(torch.int32)
        mstart = torch.where(is_match, j, mstart)
        new_kind = torch.where(
            open_obj, _K_OBJ,
            torch.where(open_arr, _K_ARR,
                        torch.where(quote, _K_STR,
                                    torch.where(num_start, _K_NUM,
                                                _K_LIT))))
        mkind = torch.where(is_match, new_kind, mkind)
        scalar_match = is_match & (quote | prim_start)
        n_sact |= scalar_match
        mdepth = torch.where(is_match & push, depth, mdepth)
        f_sq |= quote & (c == 39) & (mdepth >= 0)

        # element ordinal bump for array parents
        in_arr_parent = val_start & (depth > 0) & ~p_isobj
        s_elem = s_elem + (ohd1 & in_arr_parent[:, None]).to(torch.int32)

        # container push (one-hot write at the current depth slot)
        fb |= push & (depth >= D)
        push_cv = torch.where(v < P, v, -1)
        pm_ = (push & (depth < D))[:, None] & (d_iota == depth[:, None])
        s_isobj = torch.where(pm_, open_obj[:, None], s_isobj)
        s_cvpos = torch.where(pm_, push_cv[:, None], s_cvpos)
        s_elem = torch.where(pm_, 0, s_elem)
        depth = depth + push.to(torch.int32)
        ps = torch.where(push, torch.where(open_obj, _PS_KEY_OR_CLOSE,
                                           _PS_VAL_OR_CLOSE), ps)

        # container close
        after = ps == _PS_AFTER
        ok_close_obj = close_obj & (depth > 0) & p_isobj & (
            after | (ps == _PS_KEY_OR_CLOSE))
        ok_close_arr = close_arr & (depth > 0) & ~p_isobj & (
            after | (ps == _PS_VAL_OR_CLOSE))
        do_close = ok_close_obj | ok_close_arr
        valid &= ~((close_obj | close_arr) & ~do_close)
        depth = depth - do_close.to(torch.int32)
        ps = torch.where(do_close, _PS_AFTER, ps)
        close_match = do_close & (mdepth == depth)
        mend = torch.where(close_match, j + 1, mend)
        mdepth = torch.where(close_match, -1, mdepth)

        # comma / colon (parent lanes AFTER any pop)
        in_obj_now = (depth > 0) & (
            (d_iota == (depth - 1)[:, None]) & s_isobj).any(1)
        ok_comma = comma & (ps == _PS_AFTER) & (depth > 0)
        valid &= ~(comma & ~ok_comma)
        ps = torch.where(ok_comma,
                         torch.where(in_obj_now, _PS_KEY, _PS_VALUE), ps)
        ok_colon = colon & (ps == _PS_COLON)
        valid &= ~(colon & ~ok_colon)
        ps = torch.where(ok_colon, _PS_VALUE, ps)

        # scalar token starts
        n_qs = torch.where((val_start | key_start) & quote,
                           torch.where(c == 34, 1, 2), n_qs)
        n_is_key |= key_start
        n_key_live = torch.where(key_start, (pv >= 0) & p_named, key_live)
        # key recognition was hoisted: keq lanes say whether the string
        # starting HERE equals each distinct path name
        if keyeqs:
            lane_sel = lane_l[pvi]
            keq_any = zb
            for ln, keq in enumerate(keyeqs):
                keq_any = keq_any | ((lane_sel == ln) & at(keq, j))
            n_key_match = torch.where(key_start, keq_any, key_match)
        else:
            n_key_match = key_match & ~key_start

        num_go = num_start & can_value
        n_pstate = torch.where(num_go, start_t[c], n_pstate)
        n_pneg = torch.where(num_go, c == 45, pneg)
        n_pfloat &= ~num_go
        ps = torch.where(num_go, _PS_PRIM, ps)

        # literal start: pre-validated token, just skip its tail
        lit_go = lit_start & can_value
        llen = at(lit_len, j)
        valid &= ~(lit_go & ~at(lit_ok, j))
        n_lrem = torch.where(lit_go, llen - 1, n_lrem)
        ps = torch.where(lit_go & (llen > 1), _PS_LIT, ps)
        lit_cap = lit_go & scalar_match
        mend = torch.where(lit_cap, j + llen, mend)
        n_sact &= ~lit_cap

        # end-of-document check (exactly once, at j == lens)
        valid &= ~at_end | ((ps == _PS_AFTER) & (depth == 0) & (n_qs == 0))

        store(st, (n_qs, n_esc, n_urem, ps, valid, depth, n_pend, n_is_key,
                   n_key_match, n_key_live, n_pstate, n_pneg, n_pfloat,
                   n_lrem, n_sact, mcount, mstart, mend, mkind, mdepth,
                   mfloat, mneg, f_ws, f_sq, f_escun, f_ctrl, f_anyesc,
                   f_float, f_negz, fb, s_isobj, s_cvpos, s_elem), in_place)

    run_steps(step, L1, dev)
    return tuple(st[k] for k in ("valid", "mcount", "mstart", "mend",
                                 "mkind", "mfloat", "mneg", "f_ws", "f_sq",
                                 "f_escun", "f_ctrl", "f_anyesc", "f_float",
                                 "f_negz", "fb"))


# statistics from the most recent device evaluation (tests/bench probes);
# chunk_steps lists the scan steps (padded width + 1) of each chunk
last_stats = {"rows": 0, "fallback_rows": 0, "device_rows": 0,
              "chunk_steps": []}


def _scan_column(col: Column, instructions, padded=None,
                 allow_leading_zeros=False) -> List[torch.Tensor]:
    """Run the path-matching scan over every padded chunk; results on
    the column's device."""
    key = _compile_path(instructions)
    chunks = padded if padded is not None else padded_chunks(col)
    outs = [_scan_chunk(pc, key, allow_leading_zeros) for pc in chunks]
    last_stats["chunk_steps"] = [pc.L1 for pc in chunks]
    return [torch.cat([o[i] for o in outs]) for i in range(len(outs[0]))]


def get_json_object_device(col: Column, path: str,
                           _padded=None) -> Column:
    """Device-first get_json_object with per-row host fallback.

    Matches ops/json_path.get_json_object_host exactly for valid UTF-8
    input (the host evaluator is the oracle for flagged rows).  For
    documents containing invalid UTF-8 -- out of contract for Spark
    strings -- verbatim device rows pass the raw bytes through while
    host-rendered rows substitute U+FFFD, as the JAX package does."""
    from spark_rapids_tpu_torch.ops import json_path as JP

    assert col.dtype.is_string
    rows = col.length
    instructions = JP.parse_path(path)
    if instructions is None or rows == 0:
        return Column.from_strings([None] * rows, col.device)

    (valid, mcount, mstart, mend, mkind, mfloat, mneg, f_ws, f_sq,
     f_escun, f_ctrl, f_anyesc, f_float, f_negz, fb) = \
        _scan_column(col, instructions, padded=_padded)
    in_valid = col.valid_mask()

    # per-row verbatim-safety decision
    is_str = mkind == _K_STR
    is_num = mkind == _K_NUM
    is_nested = (mkind == _K_OBJ) | (mkind == _K_ARR)
    nested_unsafe = f_ws | f_sq | f_escun | f_ctrl | f_float | f_negz
    fast_ok = torch.where(
        is_str, ~f_anyesc,
        torch.where(is_num, ~(mfloat | mneg), ~is_nested | ~nested_unsafe))
    need_host = in_valid & (fb | (valid & (
        (mcount > 1) | ((mcount == 1) & ~fast_ok))))
    dev_copy = in_valid & ~need_host & valid & (mcount == 1)

    # spans into the flat char buffer
    offs = col.offsets[:-1].to(torch.int64)
    span_start = offs + torch.where(is_str, mstart + 1, mstart)
    span_len = torch.where(is_str, mend - mstart - 2, mend - mstart)
    span_len = torch.where(dev_copy, span_len.clamp(min=0), 0)

    # host fallback rows: only their bytes cross to the host
    fb_idx = torch.nonzero(need_host).squeeze(1)
    patch = {}
    if fb_idx.shape[0]:
        for i, raw in zip(fb_idx.tolist(), host_row_bytes(col, fb_idx)):
            patch[i] = JP._run_one(raw.decode("utf-8", errors="replace"),
                                   instructions)
    steps = last_stats["chunk_steps"]
    last_stats.clear()
    last_stats.update(rows=int(rows), fallback_rows=len(patch),
                      device_rows=int(dev_copy.sum()), chunk_steps=steps)
    return build_string_column(col.data, span_start, span_len, dev_copy,
                               patch or None)


def get_json_object_multiple_paths_device(
        col: Column, paths: Sequence[str],
        memory_budget_bytes: int = -1,
        parallel_override: int = -1) -> List[Column]:
    """Multi-path batch over the device scan (get_json_object.hpp:9).

    Each path runs its own scan; the padded chunks are built ONCE here
    and shared by every path's scan.  The budget knobs shape row
    chunking the way the reference's scratch budget shapes path
    chunking (get_json_object.cu:965-988): parallel_override pins the
    rows per slice directly, else memory_budget_bytes bounds the
    per-slice footprint (padded chars + per-row outputs)."""
    row_chunk = 0
    if parallel_override > 0:
        row_chunk = parallel_override
    elif memory_budget_bytes > 0 and col.length:
        per_row = 2 * (int(col.max_string_length()) + 1) + 64
        row_chunk = max(1, memory_budget_bytes // per_row)
    if row_chunk > 0 and col.length > row_chunk:
        # budget smaller than the column: evaluate on row slices so each
        # pads only its own rows (to the slice's own max width)
        from spark_rapids_tpu_torch.ops.copying import (concat_columns,
                                                        slice_column)
        chunks = []
        for c0 in range(0, col.length, row_chunk):
            sub = slice_column(col, c0, min(col.length, c0 + row_chunk))
            pad = padded_chunks(sub) if sub.length else None
            chunks.append([get_json_object_device(sub, p, _padded=pad)
                           for p in paths])
        return [concat_columns([ch[i] for ch in chunks])
                for i in range(len(paths))]
    padded = padded_chunks(col) if col.length else None
    return [get_json_object_device(col, p, _padded=padded)
            for p in paths]
