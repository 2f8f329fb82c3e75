"""Batch-parallel JSON structural-index tokenizer on the column's device.

The per-row scan in ops/json_device.py marches every document one
character per step.  This module is the simdjson-shaped alternative: a
handful of *whole-buffer* passes over the flat Arrow chars buffer build a
structural index for every row of a chunk at once --

  stage 1  escape parity (backslash run length before each byte, row
           bounded) and in-string parity (cumsum of unescaped quotes);
  stage 2  structural token extraction in one pass ({ } [ ] : , and
           string-open quotes; a string is ONE token carrying its
           close position, paired per row by quote ordinal);
  stage 3  per-token container links: depth from a signed cumsum, and
           for each nesting level a segmented running max of open
           positions -- parent/match links in O(depth) passes, not
           O(tokens);
  stage 4  grammar validation as PURE LOCAL RULES over (previous
           token, gap class, current token, container kind) -- once
           brackets are matched by level, JSON's grammar is regular in
           the token stream;
  stage 5  primitive gaps (the byte runs between tokens) classified
           and validated by a fixed-window number/literal DFA, plus
           prefix sums for O(1) span-safety range queries (whitespace
           outside strings, escapes, control chars, float tokens) used
           by the verbatim renderers.

Every pass is a torch op on the column's device (prefix sums, running
maxima, sorts, gathers), so on the card the chars never leave it.
Consumers (get_json_object, from_json struct fields, raw map) share
one tokenize pass and emit byte spans into the ORIGINAL buffer;
anything outside the proven-fast shape -- single-quoted strings,
documents deeper than MAX_DEPTH, overlong primitives, escape-bearing
keys, >MAX_PAIRS raw-map objects, multi-match paths -- flags its row to
the host oracle (ops/json_path), never the whole column, and only those
rows' bytes cross to the host.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.strbuild import (build_string_column,
                                                     host_row_bytes)

MAX_DEPTH = 16          # container nesting tracked; deeper rows -> host
MAX_PAIRS = 64          # raw-map pairs handled natively per row
_PRIM_W = 26            # primitive window; longer tokens -> host
ROW_CHUNK = 1 << 15     # rows per tokenize pass: bounds temporaries

# token type codes
T_OBJ, T_CLOSE_OBJ, T_ARR, T_CLOSE_ARR, T_COLON, T_COMMA, T_STR = \
    range(7)

_I64 = torch.int64


def _type_lut() -> List[int]:
    lut = [-1] * 256
    for ch, t in (("{", T_OBJ), ("}", T_CLOSE_OBJ), ("[", T_ARR),
                  ("]", T_CLOSE_ARR), (":", T_COLON), (",", T_COMMA),
                  ('"', T_STR)):
        lut[ord(ch)] = t
    return lut


def _grammar_lut() -> List[bool]:
    """Token-local grammar as ONE boolean lookup table over the packed
    (token type, previous token, token before that, gap class, context)
    code.  gap class: 0 = empty gap before token, 1 = exactly one valid
    primitive, 2 = anything else.  context: 0 = object, 1 = array,
    2 = root."""
    lut = [False] * (7 * 8 * 8 * 3 * 3)
    for tt in range(7):
        for prev in range(-1, 7):
            for pprev in range(-1, 7):
                for gapc in range(3):
                    for ctxc in range(3):
                        ctx_obj, ctx_arr, ctx_root = (
                            ctxc == 0, ctxc == 1, ctxc == 2)
                        gb_e, gb_p = gapc == 0, gapc == 1
                        is_value_prev = (
                            (prev == T_STR
                             and (pprev == T_COLON if ctx_obj else True)
                             and (pprev == -1 if ctx_root else True))
                            or prev in (T_CLOSE_OBJ, T_CLOSE_ARR))
                        prim_pos_prev = (
                            (prev == T_COLON and ctx_obj)
                            or prev == T_ARR
                            or (prev == T_COMMA and ctx_arr))
                        if tt == T_COLON:
                            ok = (gb_e and ctx_obj and prev == T_STR
                                  and pprev in (T_OBJ, T_COMMA))
                        elif tt == T_COMMA:
                            ok = (ctx_obj or ctx_arr) and (
                                (gb_e and is_value_prev)
                                or (gb_p and prim_pos_prev))
                        elif tt in (T_CLOSE_OBJ, T_CLOSE_ARR):
                            match = prev == (T_OBJ if tt == T_CLOSE_OBJ
                                             else T_ARR)
                            ok = ((gb_e and match)
                                  or (gb_e and is_value_prev)
                                  or (gb_p and prim_pos_prev))
                        elif tt == T_STR:
                            ok = gb_e and (
                                (ctx_obj and prev in (T_OBJ, T_COMMA,
                                                      T_COLON))
                                or (ctx_arr and prev in (T_ARR,
                                                         T_COMMA))
                                or (ctx_root and prev == -1))
                        else:          # T_OBJ / T_ARR open
                            ok = gb_e and (
                                (ctx_obj and prev == T_COLON)
                                or (ctx_arr and prev in (T_ARR,
                                                         T_COMMA))
                                or (ctx_root and prev == -1))
                        lut[tt + 7 * (prev + 1) + 56 * (pprev + 1)
                            + 448 * gapc + 1344 * ctxc] = ok
    return lut


def _prim_table(allow_leading_zeros: bool) -> List[List[int]]:
    """(states, 256) DFA transition table for JSON primitives.  Number
    states: 0 start, 1 '-', 2 zero, 3 int digits, 4 '.', 5 frac
    digits, 6 e, 7 e-sign, 8 exp digits; literal spines 10..22
    (t-rue / f-alse / n-ull); 9 rejects.  The tolerant host grammar
    allows an empty fraction ("12.", "12.e5"): state 4 is accepting
    and may take the exponent."""
    R = 9
    tbl = [[R] * 256 for _ in range(23)]
    dig = [ord(c) for c in "0123456789"]
    tbl[0][ord("-")] = 1
    for d in dig:
        tbl[0][d] = tbl[1][d] = 3
        tbl[3][d] = 3
        tbl[4][d] = tbl[5][d] = 5
        tbl[6][d] = tbl[7][d] = tbl[8][d] = 8
    tbl[0][ord("0")] = tbl[1][ord("0")] = 2
    if allow_leading_zeros:
        for d in dig:
            tbl[2][d] = 3
    for s in (2, 3):
        tbl[s][ord(".")] = 4
    for s in (2, 3, 4, 5):
        tbl[s][ord("e")] = tbl[s][ord("E")] = 6
    tbl[6][ord("+")] = tbl[6][ord("-")] = 7
    # literal spines: true -> 10..13(acc), false -> 14..18(acc),
    # null -> 19..22(acc); final states have no outgoing edges
    for word, base in ((b"true", 10), (b"false", 14), (b"null", 19)):
        prev = 0
        for i, b in enumerate(word):
            tbl[prev][b] = base + i
            prev = base + i
    return tbl


class _Luts:
    """The lookup tables as tensors on one device."""

    def __init__(self, device):
        def t(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=device)
        self.type = t(_type_lut(), _I64)
        ws = [False] * 256
        for c in (32, 9, 10, 13):
            ws[c] = True
        self.ws = t(ws, torch.bool)
        self.struct_nonq = t([x >= 0 and i != ord('"')
                              for i, x in enumerate(_type_lut())],
                             torch.bool)
        esc_ok = [False] * 256
        for c in b"\"'\\/bfnrtu":
            esc_ok[c] = True
        self.esc_ok = t(esc_ok, torch.bool)
        hexd = [False] * 256
        for c in b"0123456789abcdefABCDEF":
            hexd[c] = True
        self.hex = t(hexd, torch.bool)
        self.grammar = t(_grammar_lut(), torch.bool)
        self.prim = {lz: t(_prim_table(lz), _I64) for lz in (False, True)}
        acc = [False] * 23
        for s in (2, 3, 4, 5, 8, 13, 18, 22):
            acc[s] = True
        self.prim_accept = t(acc, torch.bool)
        self.prim_is_lit = t([s in (13, 18, 22) for s in range(23)],
                             torch.bool)


@functools.lru_cache(maxsize=8)
def _luts(device) -> _Luts:
    return _Luts(device)


class Tokens:
    """Structural index for one row chunk (attribute bag); every array
    is a tensor on the chunk's device."""
    __slots__ = (
        "chars", "offs", "lens", "R", "N", "lut",
        "host", "valid",
        "tpos", "ttype", "tok_offs", "row_of", "str_end",
        "depth_at", "parent", "close_of",
        "gap_end", "gap_next",
        "gap_runs", "gap_first", "gap_last",
        "lead_runs", "lead_first", "lead_last",
        "prim_ok", "prim_float", "prim_negz", "prim_lit",
        "lead_ok", "lead_float", "lead_negz",
        "wsout_cum", "esc_cum", "ctrlstr_cum",
        "gapbad_cum", "_wsout_mask",
    )


def _zeros(n, dtype, dev):
    return torch.zeros(n, dtype=dtype, device=dev)


def _full(n, v, dev):
    return torch.full((n,), v, dtype=_I64, device=dev)


def _prim_check(lut: _Luts, chars: torch.Tensor, first: torch.Tensor,
                last: torch.Tensor, sel: torch.Tensor,
                allow_leading_zeros: bool):
    """Primitive validation over [first, last] byte spans (sel = which
    entries to check).  Returns (ok, is_float, is_negzero, is_literal,
    overlong) -- ``ok`` is True for true/false/null or a strict JSON
    number (modulo the leading-zero knob).  Work is COMPRESSED to the
    selected entries and the table-driven DFA runs only to the longest
    selected span."""
    dev = first.device
    n = first.shape[0]
    idxs = torch.nonzero(sel).squeeze(1)
    outs = [_zeros(n, torch.bool, dev) for _ in range(5)]
    m = idxs.shape[0]
    if m == 0:
        return tuple(outs)
    N = chars.shape[0]
    f = first[idxs]
    length = last[idxs] - f + 1
    over_c = length > _PRIM_W
    w = int(min(_PRIM_W, int(length.max())))
    win_idx = (f[:, None] + torch.arange(w, dtype=_I64, device=dev)[None, :]
               ).clamp_(0, max(N - 1, 0))
    win = chars[win_idx].to(_I64) if N else torch.zeros(
        (m, w), dtype=_I64, device=dev)
    inlen = torch.arange(w, device=dev)[None, :] < \
        length.clamp(max=w)[:, None]
    win = win * inlen
    # fast path: plain digit runs (the overwhelmingly common case) --
    # one all-digits test instead of w DFA steps
    isdig = ((win >= 48) & (win <= 57)) | ~inlen
    plain = isdig.all(1) & ~over_c & (length >= 1)
    if not allow_leading_zeros:
        plain &= (length == 1) | (win[:, 0] != 48)
    slow = torch.nonzero(~plain).squeeze(1)
    st = _zeros(m, _I64, dev)
    if slow.shape[0]:
        tbl = lut.prim[allow_leading_zeros]
        ss = _zeros(slow.shape[0], _I64, dev)
        sw = win[slow]
        sl = inlen[slow]
        for i in range(w):
            act = sl[:, i]
            if not bool(act.any()):
                break
            ss = torch.where(act, tbl[ss, sw[:, i]], ss)
        st[slow] = ss
    acc = (plain | lut.prim_accept[st]) & ~over_c
    is_lit = lut.prim_is_lit[st] & ~plain
    lit_c = acc & is_lit
    num_ok = acc & ~is_lit
    isf_c = num_ok & ((win == 46) | (win == 101) | (win == 69)).any(1)
    if w >= 2:
        negz_c = num_ok & (length == 2) & (win[:, 0] == 45) & \
            (win[:, 1] == 48)
    else:
        negz_c = torch.zeros_like(num_ok)
    for o, vals in zip(outs, (acc, isf_c, negz_c, lit_c, over_c)):
        o[idxs] = vals
    return tuple(outs)


def _cum(mask: torch.Tensor) -> torch.Tensor:
    """Prefix-exclusive cumsum, length N+1: sum over [a, b) is
    cum[b] - cum[a]."""
    out = _zeros(mask.shape[0] + 1, _I64, mask.device)
    torch.cumsum(mask.to(_I64), 0, out=out[1:])
    return out


def _cum_opt(mask: torch.Tensor) -> Optional[torch.Tensor]:
    """_cum, or None when the mask is empty -- the all-zero prefix sums
    (escapes, control chars) are the common case and the consumers'
    range queries short-circuit on None."""
    return _cum(mask) if bool(mask.any()) else None


def _last_index(mask: torch.Tensor) -> torch.Tensor:
    """At each position the index of the last True at or before it, -1
    before the first: the running max of where(mask, index, -1), as a
    prefix count and a gather (torch's cummax of one long row is a
    single sequential scan on the card)."""
    pos = torch.nonzero(mask).squeeze(1)
    if pos.shape[0] == 0:
        return torch.full(mask.shape, -1, dtype=_I64, device=mask.device)
    count = torch.cumsum(mask, 0)
    return torch.where(count > 0, pos[(count - 1).clamp(min=0)], -1)


def _rsum_pos(cum: Optional[torch.Tensor], a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """cum[b] - cum[a] > 0 with the None (all-zero) short-circuit."""
    if cum is None:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    return cum[b] - cum[a] > 0


def any_per_row_tok(mask: torch.Tensor, row_of: torch.Tensor, R: int
                    ) -> torch.Tensor:
    out = _zeros(R, torch.bool, row_of.device)
    if mask.shape[0] and bool(mask.any()):
        out[row_of[mask]] = True
    return out


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x moved k places on (x[i - k]), the first k places `fill`."""
    out = torch.full_like(x, fill)
    if x.shape[0] > k:
        out[k:] = x[:-k]
    return out


def tokenize(chars: torch.Tensor, offs: torch.Tensor,
             allow_leading_zeros: bool = False) -> Tokens:
    """Build the structural index for rows offs[0]..offs[-1] of a flat
    char buffer.  ``chars`` (uint8) and ``offs`` (int64) are chunk-local
    (offs[0] == 0) and on one device."""
    dev = chars.device
    lut = _luts(dev)
    t = Tokens()
    R = offs.shape[0] - 1
    N = int(offs[-1])
    lens = offs[1:] - offs[:-1]
    t.chars, t.offs, t.R, t.N, t.lens, t.lut = chars, offs, R, N, lens, \
        lut
    host = _zeros(R, torch.bool, dev)
    valid = torch.ones(R, dtype=torch.bool, device=dev)

    idx = torch.arange(N, dtype=_I64, device=dev)
    chars_l = chars.to(_I64)
    rows_r = torch.arange(R, dtype=_I64, device=dev)

    _rob = [None]

    def row_of_b():
        if _rob[0] is None:
            _rob[0] = torch.repeat_interleave(rows_r, lens, output_size=N)
        return _rob[0]

    def any_per_row(mask):
        out = _zeros(R, torch.bool, dev)
        if bool(mask.any()):
            out[row_of_b()[mask]] = True
        return out

    # ---- stage 1: escape parity + in-string parity -------------------
    bs = chars == 92
    has_bs = N > 0 and bool(bs.any())
    escaped = None
    if has_bs:
        rstart = torch.repeat_interleave(offs[:-1], lens, output_size=N)
        non_bs_last = _last_index(~bs)
        prev_non_bs = _shift(non_bs_last, 1, -1)
        run_before = idx - 1 - torch.maximum(prev_non_bs, rstart - 1)
        escaped = (run_before & 1) == 1
        sq = (chars == 34) & ~escaped
    else:
        sq = chars == 34

    # qpar[i] = parity of unescaped quotes before byte i
    qpar = (_cum(sq) & 1) == 1

    ws = lut.ws[chars_l]

    # row gates: odd quote count, single quote outside a string, or a
    # backslash outside a string (tolerant grammar the parity pass
    # cannot track) -> host oracle
    odd_q = qpar[offs[1:]] ^ qpar[offs[:-1]]
    host |= odd_q
    if bool(odd_q.any()):
        in_str = qpar[:N] ^ torch.repeat_interleave(
            qpar[offs[:-1]], lens, output_size=N)
    else:
        in_str = qpar[:N]
    nis = ~in_str
    host |= any_per_row((chars == 39) & nis)
    # control chars outside strings that are not whitespace are invalid
    ctrl = chars < 0x20
    valid &= ~any_per_row(ctrl & ~ws & nis)

    # escape validity (tolerant set + \uXXXX needs 4 in-row hex)
    intro = (bs & ~escaped & in_str) if has_bs else bs
    if has_bs:
        rend = torch.repeat_interleave(offs[1:], lens, output_size=N)
        host |= any_per_row(bs & ~in_str & ~escaped)
        nxt = _zeros(N, _I64, dev)
        nxt[:-1] = chars_l[1:]
        bad = intro & (~lut.esc_ok[nxt] | (idx + 1 >= rend))
        isu = intro & (nxt == 117)
        if bool(isu.any()):
            for k in range(2, 6):
                pos = (idx + k).clamp(max=N - 1)
                bad |= isu & ((idx + k >= rend) | ~lut.hex[chars_l[pos]])
        valid &= ~any_per_row(bad)

    # ---- stage 2: token extraction ----------------------------------
    open_q = sq & nis
    tok_mask = (nis & lut.struct_nonq[chars_l]) | open_q
    # per-row token counts as a prefix-sum difference (an empty row
    # counts 0)
    tcum = _cum(tok_mask)
    ntok = tcum[offs[1:]] - tcum[offs[:-1]]
    tok_offs = _cum(ntok)
    T = int(tok_offs[-1])
    tpos = torch.nonzero(tok_mask).squeeze(1)
    ttype = lut.type[chars_l[tpos]]
    row_of = torch.repeat_interleave(rows_r, ntok, output_size=T)
    t.tpos, t.ttype, t.tok_offs, t.row_of = tpos, ttype, tok_offs, row_of

    # string close pairing: within a row unescaped quotes strictly
    # alternate open/close, so an open's close is simply the NEXT quote
    # of the same row.  Odd (host-gated) rows leave their last open
    # unpaired (-1).
    str_end = _full(T, -1, dev)
    is_str_tok = ttype == T_STR
    qpos = torch.nonzero(sq).squeeze(1)
    if qpos.shape[0]:
        qrow = torch.searchsorted(offs, qpos, right=True) - 1
        ends = _full(qpos.shape[0], -1, dev)
        ends[:-1] = torch.where(qrow[1:] == qrow[:-1], qpos[1:], -1)
        # in-row quote ordinal parity == global ordinal parity XOR the
        # parity of quotes before the row start
        is_open_q = ((torch.arange(qpos.shape[0], device=dev) & 1) == 1) \
            == qpar[offs[:-1]][qrow]
        str_end[is_str_tok] = ends[is_open_q]
    t.str_end = str_end

    # ---- stage 3: depth + container links ---------------------------
    is_open = (ttype == T_OBJ) | (ttype == T_ARR)
    is_close = (ttype == T_CLOSE_OBJ) | (ttype == T_CLOSE_ARR)
    delta = is_open.to(_I64) - is_close.to(_I64)
    dcum = torch.cumsum(delta, 0)
    first_ti = tok_offs[:-1]
    has_tok = ntok > 0
    if T:
        d_base_row = torch.where(first_ti > 0,
                                 dcum[(first_ti - 1).clamp(0, T - 1)], 0)
        depth_after = dcum - torch.repeat_interleave(d_base_row, ntok,
                                                     output_size=T)
    else:
        depth_after = dcum
    depth_at = depth_after - delta
    t.depth_at = depth_at

    valid &= ~any_per_row_tok(depth_at < 0, row_of, R)
    if T:
        last_idx = (tok_offs[1:] - 1).clamp(min=0)
        valid &= ~(has_tok & (depth_after[last_idx] != 0))
    maxd = int(depth_at.max()) + 1 if T else 0
    if maxd > MAX_DEPTH:
        host |= any_per_row_tok(depth_at >= MAX_DEPTH, row_of, R)
        maxd = MAX_DEPTH

    # each token's container: the last open of level depth_at - 1 before
    # it in its row (levels under maxd only).  One sort of the opens by
    # (level, position) and one search stand for a running max per level
    tok_idx = torch.arange(T, dtype=_I64, device=dev)
    first_tok = torch.repeat_interleave(first_ti, ntok, output_size=T)
    span = T + 1
    opos = torch.nonzero(is_open).squeeze(1)
    okey = torch.sort(depth_at[opos] * span + opos).values
    lvl = depth_at - 1
    base = lvl * span
    k = torch.searchsorted(okey, base + tok_idx, right=True) - 1
    cand = okey[k.clamp(min=0)] if okey.shape[0] else k
    link = torch.where((k >= 0) & (lvl >= 0) & (lvl < maxd)
                       & (cand >= base), cand - base, -1)
    parent = torch.where(link >= first_tok, link, -1)
    open_of_close = torch.where(is_close, parent, -1)
    t.parent = parent
    close_of = _full(T, -1, dev)
    cpos = torch.nonzero(is_close).squeeze(1)
    if cpos.shape[0]:
        oc = open_of_close[cpos]
        want = torch.where(ttype[cpos] == T_CLOSE_OBJ, T_OBJ, T_ARR)
        bad_close = (oc < 0) | (ttype[oc.clamp(min=0)] != want)
        valid &= ~any_per_row_tok(bad_close, row_of[cpos], R)
        okc = oc >= 0
        close_of[oc[okc]] = cpos[okc]
    t.close_of = close_of

    # ---- stage 4/5: gaps, primitives, grammar -----------------------
    # token span end (bytes): structural = pos+1, string = close+1
    span_end = torch.where(is_str_tok & (str_end >= 0), str_end, tpos) + 1
    next_start = _zeros(T, _I64, dev)
    if T:
        next_start[:-1] = tpos[1:]
        next_start[-1] = N
        last_of_row = tok_offs[1:] - 1
        next_start[last_of_row[has_tok]] = offs[1:][has_tok]
    t.gap_end = span_end
    t.gap_next = next_start

    nws = ~ws
    nws_prev = _shift(nws, 1, False)
    at_rstart = _zeros(N, torch.bool, dev)
    at_rstart[offs[:-1][lens > 0]] = True
    # a non-ws RUN starts where non-ws follows ws or a row boundary;
    # run starts right after a token byte are handled by gap_info's
    # explicit nws[gs] term (the byte before a gap is always non-ws)
    edge = nws & ~(nws_prev & ~at_rstart)
    ecum = _cum(edge)
    # prev non-ws byte position; a gap's first content byte resolves
    # through the run-start positions (epos) with O(1) gathers
    ln = _last_index(nws)
    epos = torch.nonzero(edge).squeeze(1)

    def gap_info(gs, ge):
        """(runs, first, last) of non-ws content in [gs, ge) --
        compressed to byte-nonempty, then content-bearing, gaps.
        ``first`` is the start of the run containing ``last`` --
        identical to the gap's first content byte in the only case
        consumers read it (runs == 1)."""
        n_ = gs.shape[0]
        runs = _zeros(n_, _I64, dev)
        first = _zeros(n_, _I64, dev)
        last = _full(n_, -1, dev)
        nz = torch.nonzero(ge > gs).squeeze(1)
        if nz.shape[0]:
            # content exists iff the last non-ws byte before the gap
            # end falls inside the gap
            nz = nz[ln[ge[nz] - 1] >= gs[nz]]
        if nz.shape[0]:
            g0 = gs[nz]
            g1 = ge[nz]
            runs[nz] = ecum[g1] - ecum[torch.minimum(g0 + 1, g1)] \
                + nws[g0].to(_I64)
            lst = ln[g1 - 1]
            nxt = epos[(ecum[lst + 1] - 1).clamp(min=0)] \
                if epos.shape[0] else g0
            first[nz] = torch.where(nws[g0], g0, nxt)
            last[nz] = lst
        return runs, first, last

    if T:
        gap_runs, gap_first, gap_last = gap_info(span_end, next_start)
        first_pos = tpos[first_ti.clamp(max=T - 1)]
        lead_end = torch.where(has_tok, first_pos, offs[1:])
    else:
        gap_runs = gap_first = gap_last = _zeros(0, _I64, dev)
        lead_end = offs[1:]
    t.gap_runs, t.gap_first, t.gap_last = gap_runs, gap_first, gap_last
    lead_runs, lead_first, lead_last = gap_info(offs[:-1], lead_end)
    t.lead_runs, t.lead_first, t.lead_last = lead_runs, lead_first, \
        lead_last

    # primitive validation
    psel = gap_runs == 1
    p_ok, p_f, p_nz, p_lit, p_over = _prim_check(
        lut, chars, gap_first, gap_last, psel, allow_leading_zeros)
    lsel = lead_runs == 1
    l_ok, l_f, l_nz, _l_lit, l_over = _prim_check(
        lut, chars, lead_first, lead_last, lsel, allow_leading_zeros)
    t.prim_ok, t.prim_float, t.prim_negz, t.prim_lit = p_ok, p_f, \
        p_nz, p_lit
    t.lead_ok, t.lead_float, t.lead_negz = l_ok, l_f, l_nz
    host |= any_per_row_tok(p_over, row_of, R)
    host |= l_over

    # multiple runs in any gap, or an invalid single-run primitive,
    # invalidate the row (the host parser would reject mid-document)
    valid &= ~any_per_row_tok((gap_runs > 1) | (psel & ~p_ok), row_of, R)
    valid &= ~((lead_runs > 1) | (lsel & ~l_ok & has_tok))
    # zero-token rows: exactly one valid primitive run = root scalar
    valid &= ~(~has_tok & ~(l_ok & (lead_runs == 1)))

    # ---- grammar local rules (packed-code LUT) ----------------------
    if T:
        same_row = _shift(row_of, 1, -1) == row_of
        prev_t = torch.where(same_row, _shift(ttype, 1, -1), -1)
        same2 = _shift(row_of, 2, -1) == row_of
        pprev_t = torch.where(same2, _shift(ttype, 2, -1), -1)

        # gap BEFORE each token: row-leading for first token, else the
        # gap after the previous token (scatter fixes first tokens)
        gap_b = _shift(gap_runs, 1, 0)
        gb_prim = _shift(p_ok, 1, False)
        ft = first_ti[has_tok]
        gap_b[ft] = lead_runs[has_tok]
        gb_prim[ft] = l_ok[has_tok]

        pp = parent >= 0
        ptype = torch.where(pp, ttype[parent.clamp(min=0)], -1)
        gapc = torch.where(gap_b == 0, 0,
                           torch.where((gap_b == 1) & gb_prim, 1, 2))
        ctxc = torch.where(parent < 0, 2,
                           torch.where(ptype == T_OBJ, 0, 1))
        code = (ttype + 7 * (prev_t + 1) + 56 * (pprev_t + 1)
                + 448 * gapc + 1344 * ctxc)
        ok_tok = lut.grammar[code]
        # unterminated string (no close in row)
        ok_tok &= ~(is_str_tok & (str_end < 0))
        valid &= ~any_per_row_tok(~ok_tok, row_of, R)

        # trailing gap after the last token must be pure whitespace
        last_idx = tok_offs[1:] - 1
        trail_bad = _zeros(R, torch.bool, dev)
        trail_bad[has_tok] = gap_runs[last_idx[has_tok]] > 0
        valid &= ~trail_bad

    # ---- span-safety prefix sums ------------------------------------
    # wsout is the expensive common one: defer until a consumer
    # actually range-queries a container span
    t._wsout_mask = ws & nis
    t.wsout_cum = False
    t.esc_cum = _cum_opt(intro) if has_bs else None
    t.ctrlstr_cum = _cum_opt(ctrl & in_str)
    t.gapbad_cum = _cum_opt(p_f | p_nz)

    t.host = host
    t.valid = valid & ~host
    return t


def _wsout(t: Tokens) -> Optional[torch.Tensor]:
    """Lazily-built whitespace-outside-strings prefix sum (None when
    the chunk has none)."""
    if t.wsout_cum is False:
        t.wsout_cum = _cum_opt(t._wsout_mask)
        t._wsout_mask = None
    return t.wsout_cum


# ======================================================================
# Consumers: get_json_object / raw map / from_json structs over one
# shared structural index.  Each returns per-row verbatim byte spans
# into the ORIGINAL buffer; rows the index cannot render byte-exactly
# (escapes to rewrite, floats to normalize, multi-match paths, the
# tokenizer's own host gates) are flagged to the host oracle in
# ops/json_path -- per row, never whole-column.
# ======================================================================

# statistics from the most recent tokenizer-path evaluation
last_stats = {"rows": 0, "fallback_rows": 0, "token_rows": 0}


def _chunks(col: Column):
    """Yield (b0, b1, chars, offs) chunk-local views of a string column
    on its device: offs[0] == 0 (int64), chars is the chunk's slice of
    the flat buffer."""
    offs_all = col.offsets.to(_I64)
    bounds = list(range(0, col.length, ROW_CHUNK)) + [col.length]
    at = offs_all[bounds].tolist()
    for i in range(len(bounds) - 1):
        b0, b1 = bounds[i], bounds[i + 1]
        lo, hi = at[i], at[i + 1]
        yield b0, b1, col.data[lo:hi], offs_all[b0:b1 + 1] - lo


def _in_valid(col: Column, b0: int, b1: int) -> torch.Tensor:
    return col.valid_mask()[b0:b1]


def _host_docs(chars, offs, rows: torch.Tensor) -> List[str]:
    """The chunk rows' documents, decoded on the host (U+FFFD for
    invalid UTF-8): only these rows' bytes leave the device."""
    sub = Column(dtypes.STRING, offs.shape[0] - 1, data=chars,
                 offsets=offs)
    return [b.decode("utf-8", errors="replace")
            for b in host_row_bytes(sub, rows)]


def _tok_index(t: Tokens):
    """Shared per-chunk derived arrays: key tokens, escaped-key tokens,
    a row-indexed root token (-1 for token-less rows) and the rows with
    an escaped key."""
    T = t.ttype.shape[0]
    dev = t.ttype.device
    is_key = _zeros(T, torch.bool, dev)
    if T:
        is_key[:-1] = ((t.ttype[:-1] == T_STR)
                       & (t.row_of[1:] == t.row_of[:-1])
                       & (t.ttype[1:] == T_COLON))
    key_esc = _zeros(T, torch.bool, dev)
    if T and t.esc_cum is not None:
        s0 = (t.tpos + 1).clamp(max=t.N)
        s1 = t.str_end.clamp(0, t.N)
        key_esc = (t.ttype == T_STR) & (t.str_end >= 0) & \
            _rsum_pos(t.esc_cum, s0, torch.maximum(s1, s0))
    has_tok = t.tok_offs[1:] > t.tok_offs[:-1]
    root = torch.where(has_tok, t.tok_offs[:-1], -1)
    esc_key_row = any_per_row_tok(is_key & key_esc, t.row_of, t.R)
    return is_key, key_esc, root, esc_key_row


def _key_name_eq(t: Tokens, is_key: torch.Tensor, key_esc: torch.Tensor,
                 name: bytes) -> torch.Tensor:
    """Per-token: an escape-free key whose raw bytes equal ``name``."""
    L = len(name)
    eq = _zeros(t.ttype.shape[0], torch.bool, t.ttype.device)
    cand = torch.nonzero(is_key).squeeze(1)
    if cand.shape[0]:
        ok = ~key_esc[cand] & (t.str_end[cand] - t.tpos[cand] - 1 == L)
        cand = cand[ok]
    if cand.shape[0] and t.N:
        base = t.tpos[cand] + 1
        keep = torch.ones(cand.shape[0], dtype=torch.bool,
                          device=cand.device)
        for k, b in enumerate(name):
            keep &= t.chars[(base + k).clamp(max=t.N - 1)] == b
        cand = cand[keep]
    eq[cand] = True
    return eq


def _value_after(t: Tokens, x: torch.Tensor, have: torch.Tensor):
    """The JSON value following token ``x`` (a colon, '[' or comma):
    (vtok, vgap) -- vtok >= 0 when the value is the next token (string
    or container open), vgap >= 0 when it is the primitive occupying
    x's trailing gap (vgap == x).  Grammar-valid rows guarantee
    exactly one of the two."""
    T = t.ttype.shape[0]
    if T == 0:
        none = torch.full_like(x, -1)
        return none, none.clone()
    xs = x.clamp(0, T - 1)
    g = torch.where(have, t.gap_runs[xs], 0)
    vgap = torch.where(have & (g == 1), x, -1)
    nxt = (x + 1).clamp(0, T - 1)
    tok_ok = have & (g == 0) & (x + 1 < T)
    # '[' directly followed by ']' is an empty array, not an element
    close_next = tok_ok & ((t.ttype[nxt] == T_CLOSE_OBJ)
                           | (t.ttype[nxt] == T_CLOSE_ARR))
    vtok = torch.where(tok_ok & ~close_next, x + 1, -1)
    return vtok, vgap


def _span_unsafe(t: Tokens, a, b, sel, *, check_float: bool,
                 tok_a=None, tok_b=None):
    """Rows whose [a, b) byte span cannot be copied verbatim: any
    whitespace outside strings, escape intro, or control char inside a
    string -- plus (get_json_object only) any float / negative-zero
    primitive gap among tokens [tok_a, tok_b)."""
    if not bool(sel.any()):
        # nothing selected: skip the range queries AND the lazy wsout
        # prefix-sum build (the common all-scalar-result chunk)
        return torch.zeros_like(sel)
    a = a.clamp(0, t.N)
    b = b.clamp(0, t.N)
    bad = sel & (_rsum_pos(_wsout(t), a, b)
                 | _rsum_pos(t.esc_cum, a, b)
                 | _rsum_pos(t.ctrlstr_cum, a, b))
    if check_float and tok_a is not None:
        T = t.ttype.shape[0]
        bad |= sel & _rsum_pos(t.gapbad_cum, tok_a.clamp(0, T),
                               tok_b.clamp(0, T))
    return bad


def _container_span(t: Tokens, vtok: torch.Tensor, sel: torch.Tensor):
    """(start, end, close_tok) byte span of container tokens."""
    T = t.ttype.shape[0]
    v = vtok.clamp(0, max(T - 1, 0))
    close = torch.where(sel, t.close_of[v], -1)
    cc = close.clamp(0, max(T - 1, 0))
    start = torch.where(sel, t.tpos[v], 0)
    end = torch.where(sel & (close >= 0), t.tpos[cc] + 1, 0)
    return start, end, close


def _last_hit(R: int, rows_s: torch.Tensor, sel_idx: torch.Tensor
              ) -> torch.Tensor:
    """(R,) the largest of each row's `sel_idx` (the last matching key
    token of the row), -1 where the row has none."""
    hit = _full(R, -1, sel_idx.device)
    if sel_idx.shape[0]:
        hit.scatter_reduce_(0, rows_s, sel_idx, reduce="amax")
    return hit


def _eval_path_chunk(t: Tokens, instructions, in_valid: torch.Tensor):
    """Evaluate a wildcard-free JSON path over one chunk's structural
    index.  Returns (to_host, starts, lens, validity): verbatim spans
    (chunk-local) for rows the index fully resolves, to_host for the
    rest."""
    from spark_rapids_tpu_torch.ops.json_path import Index, Named

    R = t.R
    T = t.ttype.shape[0]
    dev = t.ttype.device
    is_key, key_esc, root, esc_key_row = _tok_index(t)

    to_host = t.host.clone()
    alive = in_valid & t.valid & ~to_host
    # current value: a token (cur >= 0) or a primitive in a token's gap
    cur = torch.where(alive, root, -1)
    prim_gap = _full(R, -1, dev)
    # token-less root scalars need no tracking: every instruction on a
    # scalar evaluates to no-match (the empty path is engine-gated)

    def ctype_of(c):
        if not T:
            return _full(R, -1, dev)
        return t.ttype[c.clamp(0, T - 1)]

    for step in instructions:
        if isinstance(step, Named):
            ctype = ctype_of(cur)
            on_obj = (cur >= 0) & (ctype == T_OBJ)
            # Named on an array implicitly flattens (multi-match) and
            # escaped keys may unescape to the target -- host decides
            to_host |= (cur >= 0) & (ctype == T_ARR)
            to_host |= on_obj & esc_key_row
            eq = _key_name_eq(t, is_key, key_esc,
                              step.name.encode("utf-8"))
            sel_idx = torch.nonzero(eq).squeeze(1)
            rows_s = t.row_of[sel_idx]
            keep = t.parent[sel_idx] == cur[rows_s]
            sel_idx = sel_idx[keep]
            rows_s = rows_s[keep]
            cnt = torch.bincount(rows_s, minlength=R)
            to_host |= on_obj & (cnt > 1)     # duplicate-key multi-match
            hit = _last_hit(R, rows_s, sel_idx)
            have = on_obj & ~to_host & (cnt == 1)
            cur, prim_gap = _value_after(t, hit + 1, have)
        elif isinstance(step, Index):
            ctype = ctype_of(cur)
            on_arr = (cur >= 0) & (ctype == T_ARR)
            if step.index == 0:
                x = torch.where(on_arr, cur, -1)
            else:
                x = _full(R, -1, dev)
                cidx = torch.nonzero(t.ttype == T_COMMA).squeeze(1)
                if cidx.shape[0]:
                    rows_c = t.row_of[cidx]
                    keep = t.parent[cidx] == cur[rows_c]
                    cidx = cidx[keep]
                    rows_c = rows_c[keep]
                    # in-row rank of each kept comma (rows_c is sorted;
                    # exclusive per-row counts rebase)
                    cstart = _cum(torch.bincount(rows_c, minlength=R))
                    rank = torch.arange(cidx.shape[0], device=dev) \
                        - cstart[rows_c]
                    pick = rank == step.index - 1
                    x[rows_c[pick]] = cidx[pick]
            have = on_arr & (x >= 0) & ~to_host
            cur, prim_gap = _value_after(t, x, have)
        else:                                 # Wildcard: caller gates
            raise AssertionError("wildcard paths never reach the "
                                 "tokenizer engine")

    # ---- render the final value -------------------------------------
    starts = _zeros(R, _I64, dev)
    lens = _zeros(R, _I64, dev)
    validity = _zeros(R, torch.bool, dev)

    if T:
        vv = cur.clamp(0, T - 1)
        vt = t.ttype[vv]
        is_str = (cur >= 0) & (vt == T_STR)
        is_cont = (cur >= 0) & ((vt == T_OBJ) | (vt == T_ARR))
        s0 = t.tpos[vv] + 1
        s1 = t.str_end[vv].clamp(0, t.N)
        to_host |= is_str & _rsum_pos(t.esc_cum, s0.clamp(max=t.N), s1)
        ok_str = is_str & ~to_host
        starts = torch.where(ok_str, s0, starts)
        lens = torch.where(ok_str, s1 - s0, lens)
        validity |= ok_str

        ca, cb, _cl = _container_span(t, cur, is_cont)
        to_host |= _span_unsafe(
            t, ca, cb, is_cont, check_float=True,
            tok_a=cur, tok_b=torch.where(is_cont, t.close_of[vv], 0))
        ok_cont = is_cont & ~to_host
        starts = torch.where(ok_cont, ca, starts)
        lens = torch.where(ok_cont, cb - ca, lens)
        validity |= ok_cont

    # primitive result: verbatim only for exact ints / literals
    # (floats take Java Double formatting, "-0" renders "0" -- host)
    sel = prim_gap >= 0
    if bool(sel.any()):
        g = prim_gap.clamp(0, max(T - 1, 0))
        to_host |= sel & (t.prim_float[g] | t.prim_negz[g])
        okp = sel & t.prim_ok[g] & ~to_host
        starts = torch.where(okp, t.gap_first[g], starts)
        lens = torch.where(okp, t.gap_last[g] - t.gap_first[g] + 1, lens)
        validity |= okp

    to_host &= in_valid
    validity &= in_valid & ~to_host
    return to_host, starts, lens, validity


def get_json_object_tokenized(col: Column, path: str):
    """Structural-index get_json_object; None when the path shape is
    out of the tokenizer's scope (wildcards, empty)."""
    from spark_rapids_tpu_torch.ops import json_path as JP

    instructions = JP.parse_path(path)
    if instructions is None:
        return Column.from_strings([None] * col.length, col.device)
    if not instructions or any(
            isinstance(i, JP.Wildcard) for i in instructions):
        return None
    return _run_tokenized_paths(col, [instructions])[0]


def get_json_object_multiple_paths_tokenized(col: Column, paths):
    """One output column per path over ONE shared tokenize pass; None
    when any path needs a different engine (caller falls back whole)."""
    from spark_rapids_tpu_torch.ops import json_path as JP

    parsed = [JP.parse_path(p) for p in paths]
    todo = [p for p in parsed if p is not None]
    if any(not p or any(isinstance(i, JP.Wildcard) for i in p)
           for p in todo):
        return None
    outs = iter(_run_tokenized_paths(col, todo))
    return [Column.from_strings([None] * col.length, col.device)
            if p is None else next(outs) for p in parsed]


def _run_tokenized_paths(col: Column, instruction_lists):
    """Shared driver: tokenize each chunk once, evaluate every path,
    patch host rows through the oracle, assemble string columns."""
    from spark_rapids_tpu_torch.ops import json_path as JP

    P = len(instruction_lists)
    parts: List[List[Column]] = [[] for _ in range(P)]
    n_host = n_tok = 0
    for b0, b1, chars, offs in _chunks(col):
        t = tokenize(chars, offs)
        iv = _in_valid(col, b0, b1)
        results = [_eval_path_chunk(t, ins, iv) for ins in instruction_lists]
        host_rows = torch.zeros(t.R, dtype=torch.bool, device=chars.device)
        for to_host, _s, _l, _v in results:
            host_rows |= to_host
        rows = torch.nonzero(host_rows).squeeze(1)
        docs = dict(zip(rows.tolist(), _host_docs(chars, offs, rows)))
        n_host += len(docs)
        for pi, (to_host, starts, lens, validity) in enumerate(results):
            patch = {i: JP._run_one(docs[i], instruction_lists[pi])
                     for i in torch.nonzero(to_host).squeeze(1).tolist()}
            n_tok += int(validity.sum())
            parts[pi].append(build_string_column(
                chars, starts, lens, validity, patch or None))
    last_stats.update(rows=int(col.length), fallback_rows=n_host,
                      token_rows=n_tok)
    return [_concat_parts(p, col.length, col.device) for p in parts]


def _concat_parts(parts, rows: int, device):
    from spark_rapids_tpu_torch.ops.copying import concat_columns
    if not parts:
        return Column.from_strings([None] * rows, device)
    if len(parts) == 1:
        return parts[0]
    return concat_columns(parts)


# ======================================================================
# from_json consumers: raw map + flat structs over the same index
# ======================================================================

def _top_level_keys(t: Tokens, tok_index=None):
    """(kidx, rows_k) of escape-free top-level object keys, plus the
    per-row root-object mask and the escaped-top-key host gate."""
    is_key, key_esc, root, _esc_row = tok_index or _tok_index(t)
    T = t.ttype.shape[0]
    dev = t.ttype.device
    has_tok = t.tok_offs[1:] > t.tok_offs[:-1]
    is_obj = has_tok & (t.ttype[root.clamp(0, T - 1)] == T_OBJ) if T \
        else _zeros(t.R, torch.bool, dev)
    kidx = torch.nonzero(is_key).squeeze(1)
    rows_k = t.row_of[kidx]
    keep = t.parent[kidx] == t.tok_offs[:-1][rows_k]
    kidx = kidx[keep]
    rows_k = rows_k[keep]
    esc_top = any_per_row_tok(key_esc[kidx], rows_k, t.R)
    return kidx, rows_k, is_obj, esc_top


def _dup_key_rows(t: Tokens, kidx: torch.Tensor, rows_k: torch.Tensor
                  ) -> torch.Tensor:
    """Rows whose top-level keys are not provably distinct.  A sampled
    byte hash (length + first/middle/last chars) keeps this to a few
    compressed gathers: identical keys always collide (detected), and
    a false collision merely routes the row to the host oracle."""
    bad = _zeros(t.R, torch.bool, kidx.device)
    if kidx.shape[0] < 2:
        return bad
    s0 = t.tpos[kidx] + 1
    klen = t.str_end[kidx] - s0
    cap = max(t.N - 1, 0)
    ch = t.chars
    h = (klen
         + 131 * ch[s0.clamp(max=cap)].to(_I64)
         + 257 * ch[(s0 + klen // 2).clamp(max=cap)].to(_I64)
         + 65537 * ch[(s0 + (klen - 1).clamp(min=0)).clamp(max=cap)]
         .to(_I64))
    # order by (row, hash): two stable sorts, the minor key first
    o1 = torch.sort(h, stable=True).indices
    o2 = torch.sort(rows_k[o1], stable=True).indices
    order = o1[o2]
    ro = rows_k[order]
    ho = h[order]
    dup = (ro[1:] == ro[:-1]) & (ho[1:] == ho[:-1])
    bad[ro[1:][dup]] = True
    return bad


def _value_spans(t: Tokens, x: torch.Tensor, have: torch.Tensor,
                 *, null_is_none: bool):
    """Verbatim (starts, lens, got, is_null, unsafe) for the value
    following token ``x`` (a colon or comma): strings render their
    unescaped content, containers their exact byte span, primitives
    their gap bytes (numbers VERBATIM -- the from_json family never
    normalizes).  ``unsafe`` rows need the host oracle."""
    T = t.ttype.shape[0]
    K = x.shape[0]
    dev = x.device
    vtok, vgap = _value_after(t, x, have)
    starts = _zeros(K, _I64, dev)
    lens = _zeros(K, _I64, dev)
    got = _zeros(K, torch.bool, dev)
    is_null = _zeros(K, torch.bool, dev)
    unsafe = _zeros(K, torch.bool, dev)
    if T:
        vv = vtok.clamp(0, T - 1)
        vt = t.ttype[vv]
        is_str = (vtok >= 0) & (vt == T_STR)
        is_cont = (vtok >= 0) & ((vt == T_OBJ) | (vt == T_ARR))
        s0 = t.tpos[vv] + 1
        s1 = t.str_end[vv].clamp(0, t.N)
        s0c = s0.clamp(max=t.N)
        unsafe |= is_str & _rsum_pos(t.esc_cum, s0c,
                                     torch.maximum(s1, s0c))
        ok_str = is_str & ~unsafe
        starts = torch.where(ok_str, s0, starts)
        lens = torch.where(ok_str, s1 - s0, lens)
        got |= ok_str

        ca, cb, _cl = _container_span(t, vtok, is_cont)
        unsafe |= _span_unsafe(t, ca, cb, is_cont, check_float=False)
        ok_cont = is_cont & ~unsafe
        starts = torch.where(ok_cont, ca, starts)
        lens = torch.where(ok_cont, cb - ca, lens)
        got |= ok_cont

    sel = vgap >= 0
    if bool(sel.any()):
        g = vgap.clamp(0, max(T - 1, 0))
        gf = t.gap_first[g]
        gl = t.gap_last[g]
        okp = sel & t.prim_ok[g]
        if null_is_none:
            cap = max(t.N - 1, 0)
            isn = okp & t.prim_lit[g] & (gl - gf == 3) & \
                (t.chars[gf.clamp(max=cap)] == ord("n"))
            is_null |= isn
            okp = okp & ~isn
        starts = torch.where(okp, gf, starts)
        lens = torch.where(okp, gl - gf + 1, lens)
        got |= okp
    return starts, lens, got, is_null, unsafe


def _host_trees(chars, offs, rows: torch.Tensor, allow_leading_zeros):
    """{row: parse tree or None} for the chunk rows sent to the host."""
    from spark_rapids_tpu_torch.ops.json_path import _Invalid, _Parser
    out = {}
    for i, doc in zip(rows.tolist(), _host_docs(chars, offs, rows)):
        try:
            out[i] = _Parser(doc, allow_leading_zeros).parse()
        except _Invalid:
            out[i] = None
    return out


def from_json_to_raw_map_tokenized(col: Column, allow_leading_zeros=False):
    """Structural-index from_json raw map: MAP<STRING,STRING> rows with
    keys in first-seen order and values rendered exactly as the host
    tree-builder would (string content unescaped, numbers and nested
    containers verbatim).  Rows out of the proven shape (escaped or
    duplicate top-level keys, >MAX_PAIRS, render-unsafe spans, the
    tokenizer's own host gates) fall back to the host oracle per row."""
    from spark_rapids_tpu_torch.ops.json_utils import _raw_pairs

    dev = col.device
    counts_p, valid_p, kparts, vparts = [], [], [], []
    n_host = n_tok = 0
    for b0, b1, chars, offs in _chunks(col):
        t = tokenize(chars, offs, allow_leading_zeros)
        iv = _in_valid(col, b0, b1)
        R = t.R
        kidx, rows_k, is_obj, esc_top = _top_level_keys(t)
        to_host = t.host | esc_top | _dup_key_rows(t, kidx, rows_k)
        pair_cnt = torch.bincount(rows_k, minlength=R)
        to_host |= pair_cnt > MAX_PAIRS

        # values after each key's colon
        have = torch.ones(kidx.shape[0], dtype=torch.bool, device=dev)
        vs, vl, got, _nul, unsafe = _value_spans(
            t, kidx + 1, have, null_is_none=False)
        to_host |= any_per_row_tok(unsafe | ~got, rows_k, R)
        to_host &= iv

        row_ok = iv & t.valid & is_obj & ~to_host
        host_pairs = {
            i: (None if tree is None or tree[0] != "obj"
                else _raw_pairs(tree))
            for i, tree in _host_trees(
                chars, offs, torch.nonzero(to_host).squeeze(1),
                allow_leading_zeros).items()}

        counts = torch.where(row_ok, pair_cnt, 0)
        valid_row = row_ok.clone()
        hp = [(i, p) for i, p in host_pairs.items() if p is not None]
        if hp:
            hi = torch.tensor([i for i, _ in hp], dtype=_I64, device=dev)
            counts[hi] = torch.tensor([len(p) for _, p in hp], dtype=_I64,
                                      device=dev)
            valid_row[hi] = True
        roffs = _cum(counts)

        # flat positions for tokenizer pairs (rows_kk sorted): in-row
        # ordinal via exclusive per-row counts
        keep_k = row_ok[rows_k]
        rows_kk = rows_k[keep_k]
        kk = kidx[keep_k]
        kstart = _cum(torch.bincount(rows_kk, minlength=R))
        flat = roffs[rows_kk] + (torch.arange(rows_kk.shape[0], device=dev)
                                 - kstart[rows_kk])
        total = int(roffs[-1])
        kst, kln, vst, vln = (_zeros(total, _I64, dev) for _ in range(4))
        kst[flat] = t.tpos[kk] + 1
        kln[flat] = t.str_end[kk] - t.tpos[kk] - 1
        vst[flat] = vs[keep_k]
        vln[flat] = vl[keep_k]
        patch_k, patch_v = {}, {}
        base = roffs[[i for i, _ in hp]].tolist() if hp else []
        for (i, pairs), b in zip(hp, base):
            for j, (k, v) in enumerate(pairs):
                patch_k[b + j] = k
                patch_v[b + j] = v
        kparts.append(build_string_column(chars, kst, kln, None,
                                          patch_k or None))
        vparts.append(build_string_column(chars, vst, vln, None,
                                          patch_v or None))
        counts_p.append(counts)
        valid_p.append(valid_row)
        n_host += int(to_host.sum())
        n_tok += int(row_ok.sum())

    rows = col.length
    counts = torch.cat(counts_p) if counts_p else _zeros(0, _I64, dev)
    valid_row = torch.cat(valid_p) if valid_p else \
        _zeros(0, torch.bool, dev)
    kcol = _concat_parts(kparts, 0, dev)
    vcol = _concat_parts(vparts, 0, dev)
    last_stats.update(rows=rows, fallback_rows=n_host, token_rows=n_tok)
    offs = _cum(counts).to(torch.int32)
    st = Column.make_struct(int(offs[-1]), [kcol, vcol])
    return Column(dtypes.LIST, rows,
                  validity=None if bool(valid_row.all())
                  else valid_row.to(torch.uint8),
                  offsets=offs, children=(st,))


def from_json_to_structs_tokenized(col: Column, fields,
                                   allow_leading_zeros=False):
    """Structural-index from_json to a flat STRUCT: one shared tokenize
    pass, per-field top-level key lookup (duplicate keys: LAST wins,
    natively -- dict semantics), values rendered verbatim and converted
    through the same convert_from_strings the host path uses.  None
    when the schema has non-leaf fields (caller falls back)."""
    from spark_rapids_tpu_torch.columns.dtypes import DType
    from spark_rapids_tpu_torch.ops.json_utils import (_value_as_raw_string,
                                                       convert_from_strings)

    if not all(isinstance(spec, DType) for _n, spec in fields):
        return None
    dev = col.device
    F = len(fields)
    parts: List[List[Column]] = [[] for _ in range(F)]
    valid_p = []
    n_host = n_tok = 0
    for b0, b1, chars, offs in _chunks(col):
        t = tokenize(chars, offs, allow_leading_zeros)
        iv = _in_valid(col, b0, b1)
        R = t.R
        tix = _tok_index(t)
        is_key, key_esc = tix[0], tix[1]
        _kidx, _rows_k, is_obj, esc_top = _top_level_keys(t, tix)
        to_host = t.host | esc_top

        field_spans = []
        for name, _spec in fields:
            eq = _key_name_eq(t, is_key, key_esc, name.encode("utf-8"))
            sel_idx = torch.nonzero(eq).squeeze(1)
            rows_s = t.row_of[sel_idx]
            keep = t.parent[sel_idx] == t.tok_offs[:-1][rows_s]
            hit = _last_hit(R, rows_s[keep], sel_idx[keep])
            have = hit >= 0
            vs, vl, got, isn, unsafe = _value_spans(
                t, hit + 1, have, null_is_none=True)
            to_host |= have & unsafe
            field_spans.append((vs, vl, got, isn))
        to_host &= iv

        row_ok = iv & t.valid & is_obj & ~to_host
        trees = _host_trees(chars, offs, torch.nonzero(to_host).squeeze(1),
                            allow_leading_zeros)
        valid_row = row_ok.clone()
        objs = {i: dict(tr[1]) for i, tr in trees.items()
                if tr is not None and tr[0] == "obj"}
        if objs:
            valid_row[torch.tensor(list(objs), dtype=_I64,
                                   device=dev)] = True
        for fi, (vs, vl, got, isn) in enumerate(field_spans):
            name = fields[fi][0]
            patch = {}
            for i, d in objs.items():
                v = d.get(name)
                patch[i] = (None if v is None or v == ("lit", "null")
                            else _value_as_raw_string(v))
            parts[fi].append(build_string_column(
                chars, vs, vl, row_ok & got & ~isn, patch or None))
        valid_p.append(valid_row)
        n_host += int(to_host.sum())
        n_tok += int(row_ok.sum())

    rows = col.length
    valid_row = torch.cat(valid_p) if valid_p else \
        _zeros(0, torch.bool, dev)
    last_stats.update(rows=rows, fallback_rows=n_host, token_rows=n_tok)
    children = [convert_from_strings(_concat_parts(parts[fi], rows, dev),
                                     spec)
                for fi, (_name, spec) in enumerate(fields)]
    return Column.make_struct(
        rows, children,
        validity=None if bool(valid_row.all())
        else valid_row.to(torch.uint8))
