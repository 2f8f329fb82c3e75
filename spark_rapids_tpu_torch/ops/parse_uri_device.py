"""Device parse_url: java.net.URI split + validation on the column's
device.

Reference: src/main/cpp/src/parse_uri.cu:1-1075 (thread-per-row
validation/extraction kernels behind ParseURI.java).  As in the JAX
package, each chunk of rows is one pass of positional tensor ops -- no
per-row loops, no scan:

  * component boundaries (fragment '#', scheme ':', query '?',
    authority '//', path '/') are first/last-position reductions over
    the padded char matrix;
  * per-component character validation is an ASCII class test plus
    masked range counts (bad chars in [lo,hi) == 0), with
    '%'-escape legality as a shifted-window hex check;
  * the authority classifier (userinfo, port, IPv4 exact-octet,
    RFC-1034 hostname label rules, registry fallback) is positional
    arithmetic on dot/colon/at positions.

Rows the engine cannot fully decide on the device are FLAGGED and routed
per row to the host oracle (ops/parse_uri.py _URI -- the java.net.URI
mini-parser): any byte >= 0x80 (codepoint-level rules) and IPv6
literals ('[' authorities).  Only those rows' bytes cross to the host,
and only their values come back, written into the output by the shared
span gather (columns/strbuild.py).  parse_url(..., QUERY, key) matches
keys per row on the host, as the reference does, over the query spans'
bytes.
"""

from __future__ import annotations

import functools
import os
from collections import OrderedDict
from typing import List, Optional

import torch

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.strbuild import build_string_column

DEVICE_ROW_CHUNK = 1 << 17

# chunks analysed and found in the memo, and rows sent to the host
# parser, since the last reset_stats()
STATS = {"memo_hits": 0, "memo_misses": 0, "fallback_rows": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


# ------------------------------------------------------- char classes
# Sets are 4x32-bit ASCII bitmask quads tested with shift+mask; the
# 32-bit words ride in int64 lanes (torch has no uint32 shifts).
def _quad(chars_ok: str):
    m = [0, 0, 0, 0]
    for ch in chars_ok:
        o = ord(ch)
        assert o < 128
        m[o >> 5] |= 1 << (o & 31)
    return tuple(m)


@functools.lru_cache(maxsize=1)
def _quads():
    from spark_rapids_tpu_torch.ops import parse_uri as PU
    alpha = ("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ")
    digit = "0123456789"
    return {
        "path": _quad("".join(PU._PATH_OK)),
        "query": _quad("".join(PU._QUERY_OK)),
        "user": _quad("".join(PU._USER_OK)),
        "reg": _quad("".join(PU._USER_OK | {"[", "]"})),
        "scheme": _quad(alpha + digit + "+.-"),
        "alpha": _quad(alpha),
        "digit": _quad(digit),
        "alnum": _quad(alpha + digit),
        "hex": _quad(PU._HEX),
    }


def _cls(chars: torch.Tensor, quad) -> torch.Tensor:
    """Membership test against an ASCII bitmask quad (any shape)."""
    w = (chars >> 5).to(torch.int64)
    bit = (chars & 31).to(torch.int64)
    sel = torch.where(w == 0, quad[0],
                      torch.where(w == 1, quad[1],
                                  torch.where(w == 2, quad[2],
                                              torch.where(w == 3, quad[3],
                                                          0))))
    return ((sel >> bit) & 1).to(torch.bool)


# ------------------------------------------------------------- helpers
def _first(mask, lo, hi, L):
    """First index in [lo,hi) where mask; (pos, found).  argmax over
    uint8 (it keeps the first of ties; bool has no CUDA argmax)."""
    idx = torch.arange(L, dtype=torch.int32, device=mask.device)[None, :]
    m = mask & (idx >= lo[:, None]) & (idx < hi[:, None])
    p = torch.argmax(m.to(torch.uint8), dim=1).to(torch.int32)
    found = m.any(dim=1)
    return torch.where(found, p, L), found


def _last(mask, lo, hi, L):
    idx = torch.arange(L, dtype=torch.int32, device=mask.device)[None, :]
    inr = (idx >= lo[:, None]) & (idx < hi[:, None])
    cand = torch.where(mask & inr, idx, -1)
    p = cand.max(dim=1).values
    return p, p >= 0


def _count_in(mask, lo, hi, idx):
    """Count of True in columns [lo,hi) per row (a masked reduction)."""
    inr = (idx >= lo[:, None]) & (idx < hi[:, None])
    return (mask & inr).sum(dim=1, dtype=torch.int32)


def _char_at(chars, pos, L, fill=0):
    p = pos.clamp(0, L - 1).to(torch.int64)
    c = chars.gather(1, p[:, None])[:, 0]
    return torch.where((pos >= 0) & (pos < L), c, fill).to(torch.uint8)


def _shift_left(m, k):
    """Columns k.. of a bool matrix, then k columns of False (the
    reference's concatenate, so a matrix narrower than k widens)."""
    return torch.cat([m[:, k:], torch.zeros((m.shape[0], k),
                                            dtype=torch.bool,
                                            device=m.device)], dim=1)


def _analyze(chars: torch.Tensor, lens: torch.Tensor):
    """All component spans + validity for every row, one pass.

    Returns dict of (R,) tensors; spans are [start, end) char positions,
    has_* False means the component is null (java returns null)."""
    Q = _quads()
    R, L = chars.shape
    dev = chars.device
    idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_row = idx < lens[:, None]
    zeros = torch.zeros(R, dtype=torch.int32, device=dev)

    def is_(b):
        return chars == ord(b)

    fallback = ((chars >= 0x80) & in_row).any(dim=1)

    # escape legality: every '%' needs two hex chars after it, inside
    # the row (component boundary tightening handled per-range below)
    hx = _cls(chars, Q["hex"])
    pct = is_("%")
    esc_bad = pct & ~(_shift_left(hx, 1) & _shift_left(hx, 2))

    # per-component bad-char masks, computed once per class; bad class
    # char OR broken escape, one reduction per call
    badesc_m = {k: (~(_cls(chars, Q[k]) | pct) & in_row) | esc_bad
                for k in ("path", "query", "user", "reg")}

    def comp_ok(clsname, lo, hi):
        """Chars in [lo,hi) all legal for the component: class mask
        (plus '%' heads), escapes valid and fully inside [lo,hi)."""
        cnt_bad = _count_in(badesc_m[clsname], lo, hi, idx)
        # '%' within 2 chars of the component end cannot complete
        tail_pct = _count_in(pct, torch.maximum(hi - 2, lo), hi, idx)
        return (cnt_bad == 0) & (tail_pct == 0)

    invalid = torch.zeros(R, dtype=torch.bool, device=dev)

    # ---- fragment ---------------------------------------------------
    hpos, has_frag = _first(is_("#"), zeros, lens, L)
    len0 = torch.where(has_frag, hpos, lens)
    invalid |= has_frag & ~comp_ok("query", hpos + 1, lens)

    # ---- scheme -----------------------------------------------------
    c0, has_c = _first(is_(":"), zeros, len0, L)
    sch_chars_ok = _count_in(~_cls(chars, Q["scheme"]) & in_row,
                             zeros + 1, c0, idx) == 0
    first_alpha = _cls(_char_at(chars, zeros, L), Q["alpha"])
    has_scheme = has_c & (c0 >= 1) & first_alpha & sch_chars_ok
    invalid |= has_c & (c0 == 0)            # rest startswith ':'
    pos_s = torch.where(has_scheme, c0 + 1, 0)

    # ---- opaque vs hierarchical ------------------------------------
    first_rest = _char_at(chars, pos_s, L)
    rest_empty = pos_s >= len0
    opaque = has_scheme & ~(~rest_empty & (first_rest == ord("/")))
    invalid |= opaque & rest_empty                       # empty ssp
    invalid |= opaque & ~comp_ok("query", pos_s, len0)

    hier = ~opaque

    # ---- query ------------------------------------------------------
    q0, has_q0 = _first(is_("?"), pos_s, len0, L)
    has_q = hier & has_q0
    invalid |= has_q & ~comp_ok("query", q0 + 1, len0)
    e0 = torch.where(has_q, q0, len0)

    # ---- authority / path ------------------------------------------
    second = _char_at(chars, pos_s + 1, L)
    has_auth = (hier & (first_rest == ord("/")) & (second == ord("/"))
                & (pos_s + 1 < e0))
    a0 = pos_s + 2
    p0, p_found = _first(is_("/"), a0, e0, L)
    auth_end = torch.where(has_auth, torch.where(p_found, p0, e0), a0)
    path_lo = torch.where(has_auth,
                          torch.where(p_found, p0, e0),   # "" when no '/'
                          pos_s)
    path_hi = e0
    has_path = hier
    invalid |= hier & ~comp_ok("path", path_lo, path_hi)

    # ---- authority classification ----------------------------------
    auth_present = has_auth & (a0 < auth_end)
    atp, has_at = _last(is_("@"), a0, auth_end, L)
    has_at &= auth_present
    invalid |= has_at & ~comp_ok("user", a0, atp)
    hp0 = torch.where(has_at, atp + 1, a0)
    hp1 = auth_end

    fallback |= auth_present & (_char_at(chars, hp0, L) == ord("["))

    cpos, has_col = _last(is_(":"), hp0, hp1, L)
    has_col &= auth_present
    dig_m = _cls(chars, Q["digit"]) & in_row
    port_len = (hp1 - (cpos + 1)).clamp(min=0)
    port_digits = _count_in(dig_m, cpos + 1, hp1, idx) == port_len
    server_port_ok = ~has_col | port_digits
    h_end = torch.where(has_col & port_digits, cpos, hp1)

    # IPv4: exactly 3 dots, 4 all-digit octets of 1-3 chars, each <=255
    dot = is_(".")
    d1, f1 = _first(dot, hp0, h_end, L)
    d2, f2 = _first(dot, d1 + 1, h_end, L)
    d3, f3 = _first(dot, d2 + 1, h_end, L)
    _d4, f4 = _first(dot, d3 + 1, h_end, L)
    three_dots = f1 & f2 & f3 & ~f4

    def octet(a, b):
        n = b - a
        dcount = _count_in(dig_m, a, b, idx)
        all_dig = dcount == n
        # uint8 subtraction wraps, as in the JAX package
        v0, v1, v2 = ((_char_at(chars, a + k, L) - ord("0")).to(torch.int32)
                      for k in range(3))
        val = torch.where(n == 1, v0,
                          torch.where(n == 2, v0 * 10 + v1,
                                      v0 * 100 + v1 * 10 + v2))
        return (n >= 1) & (n <= 3) & all_dig & (val <= 255)

    ipv4_ok = (three_dots & server_port_ok
               & octet(hp0, d1) & octet(d1 + 1, d2)
               & octet(d2 + 1, d3) & octet(d3 + 1, h_end))

    # hostname (RFC-1034 labels): chars alnum/-/., first char alnum,
    # every '.' preceded by alnum and followed by alnum-or-end, last
    # char alnum or '.'
    alnum_m = _cls(chars, Q["alnum"])
    hn_class = alnum_m | dot | is_("-")
    hn_all = _count_in(~hn_class & in_row, hp0, h_end, idx) == 0
    first_an = _cls(_char_at(chars, hp0, L), Q["alnum"])
    prev_alnum = torch.cat(
        [torch.zeros((R, 1), dtype=torch.bool, device=dev),
         alnum_m[:, :-1]], dim=1)
    next_alnum = _shift_left(alnum_m, 1)
    at_end = idx == (h_end[:, None] - 1)
    dot_bad = dot & ~(prev_alnum & (next_alnum | at_end))
    inr_h = (idx >= hp0[:, None]) & (idx < h_end[:, None])
    dots_ok = ~(dot_bad & inr_h).any(dim=1)
    last_c = _char_at(chars, h_end - 1, L)
    last_ok = _cls(last_c, Q["alnum"]) | (last_c == ord("."))
    hostname_ok = ((h_end > hp0) & hn_all & first_an & dots_ok
                   & last_ok & server_port_ok)

    is_server = auth_present & server_port_ok & (ipv4_ok | hostname_ok)

    # registry authority: valid chars required, host stays null.
    # server-parse failure with non-digit port validates the WHOLE
    # hostport (host + ':' + port); plain hostname/ipv4 failure
    # validates only the host part (port was stripped) -- ops/parse_uri
    # _parse_authority.
    reg_hi = torch.where(server_port_ok, h_end, hp1)
    registry = auth_present & ~is_server
    invalid |= registry & ~comp_ok("reg", hp0, reg_hi)

    return {
        "invalid": invalid, "fallback": fallback,
        "has_scheme": has_scheme,
        "scheme_lo": zeros, "scheme_hi": c0,
        "opaque": opaque,
        "has_q": has_q, "q_lo": q0 + 1, "q_hi": len0,
        "has_path": has_path, "path_lo": path_lo, "path_hi": path_hi,
        "has_host": is_server, "host_lo": hp0, "host_hi": h_end,
    }


# chunk-analysis memo: parse_url workloads typically extract several
# components of the same column (protocol+host+query+path); the engine
# computes all spans in one pass, so later extractors reuse it.  Keys
# hold a STRONG reference to the column, which both bounds staleness
# (identity can't be recycled while cached) and caps memory via FIFO.
# Entries hold device tensors; their bytes count against the budget.
_ANALYSIS_CACHE: "OrderedDict" = OrderedDict()
_ANALYSIS_CACHE_MAX = 8
# byte budget as well as entry count: one 8KB-row chunk's char matrix
# alone can be ~1GB, so entry count alone cannot bound memory
_ANALYSIS_CACHE_BYTES = int(os.environ.get(
    "SPARK_RAPIDS_TPU_PARSE_URI_CACHE_BYTES", str(256 << 20)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fallback_uris(col: Column, b0: int, fb_rows: List[int], chars,
                   lens):
    """{local_row: parsed URI or None} for the chunk's fallback rows,
    parsed once per chunk: the dict lives INSIDE the chunk's memo entry,
    so one cache, one guard and one eviction budget govern both the span
    analysis and the fallback parses.  Only these rows' bytes are copied
    to the host."""
    from spark_rapids_tpu_torch.ops import parse_uri as PU
    ent = _ANALYSIS_CACHE.get((id(col), b0))
    uris = ent[5] if ent is not None and ent[0] is col else {}
    todo = [i for i in fb_rows if i not in uris]
    if todo:
        at = torch.tensor(todo, dtype=torch.int64, device=chars.device)
        rows = chars[at].cpu().numpy()
        n = lens[at].cpu().numpy()
        for i, r, k in zip(todo, rows, n):
            uris[i] = PU._parse(bytes(r[:k]).decode("utf-8",
                                                    errors="replace"))
    return uris


def _analyzed_chunk(col: Column, b0: int, b1: int):
    key = (id(col), b0)
    ent = _ANALYSIS_CACHE.get(key)
    if ent is not None and ent[0] is col:
        STATS["memo_hits"] += 1
        return ent[1], ent[2], ent[3]
    STATS["memo_misses"] += 1
    sub = Column(col.dtype, b1 - b0, data=col.data, validity=None,
                 offsets=col.offsets[b0:b1 + 1])
    chars, lens = sub.to_padded_chars()
    res = _analyze(chars, lens)
    nbytes = (_nbytes(chars) + _nbytes(lens)
              + sum(_nbytes(v) for v in res.values()))
    _ANALYSIS_CACHE[key] = (col, res, chars, lens, nbytes,
                            {})   # lazily-filled fallback URI parses
    total = sum(e[4] for e in _ANALYSIS_CACHE.values())
    while _ANALYSIS_CACHE and (
            len(_ANALYSIS_CACHE) > _ANALYSIS_CACHE_MAX
            or total > _ANALYSIS_CACHE_BYTES):
        _k, evicted = _ANALYSIS_CACHE.popitem(last=False)
        total -= evicted[4]
    return res, chars, lens


# ------------------------------------------------ span materialization
def spans_to_strings(chars: torch.Tensor, starts: torch.Tensor,
                     ends: torch.Tensor, valid: torch.Tensor,
                     host_patch=None) -> Column:
    """Gather [start,end) per row from the padded matrix into a STRING
    column; invalid rows are null (columns/strbuild.py)."""
    L = chars.shape[1]
    rows_idx = torch.arange(starts.shape[0], device=chars.device)
    return build_string_column(
        chars.reshape(-1), rows_idx * L + starts,
        (ends - starts).clamp(min=0), valid, host_patch)


_SPANS = {"protocol": ("has_scheme", "scheme_lo", "scheme_hi"),
          "host": ("has_host", "host_lo", "host_hi"),
          "query": ("has_q", "q_lo", "q_hi"),
          "path": ("has_path", "path_lo", "path_hi")}


def _component(res, what):
    """(valid, lo, hi) of an extractor's span."""
    if what not in _SPANS:
        raise ValueError(what)
    has, lo, hi = (res[k] for k in _SPANS[what])
    return has & ~res["invalid"], lo, hi


def extract_device(col: Column, what: str, ansi_mode: bool,
                   key: Optional[str] = None) -> Column:
    """Device-first extraction with per-row host fallback."""
    from spark_rapids_tpu_torch.ops.exceptions import ExceptionWithRowIndex
    from spark_rapids_tpu_torch.ops.parse_uri import match_query_key

    rows = col.length
    parts: List[Column] = []
    for b0 in range(0, rows, DEVICE_ROW_CHUNK):
        b1 = min(rows, b0 + DEVICE_ROW_CHUNK)
        res, chars, lens = _analyzed_chunk(col, b0, b1)
        fb = res["fallback"]
        inv = res["invalid"]

        if col.validity is None:
            in_null = torch.zeros(b1 - b0, dtype=torch.bool,
                                  device=chars.device)
        else:
            in_null = ~col.validity[b0:b1].to(torch.bool)

        if what == "query_key":
            valid, lo, hi = _component(res, "query")
            qvals = _materialize_query_key(
                chars, lo, hi, valid & ~in_null & ~fb, key)
        else:
            valid, lo, hi = _component(res, what)

        # per-row host fallback (non-ASCII / IPv6):
        # host_vals[i] = (uri_parses, component_value)
        fb_rows = torch.nonzero(fb & ~in_null).squeeze(1).tolist()
        STATS["fallback_rows"] += len(fb_rows)
        host_vals = {}
        if fb_rows:
            uris = _fallback_uris(col, b0, fb_rows, chars, lens)
            for i in fb_rows:
                uri = uris[i]
                if uri is None:
                    host_vals[i] = (False, None)
                    continue
                if what == "protocol":
                    v = uri.scheme
                elif what == "host":
                    v = uri.host
                elif what == "query":
                    v = uri.raw_query
                elif what == "path":
                    v = uri.raw_path
                else:
                    v = match_query_key(uri.raw_query, key)
                host_vals[i] = (True, v)

        row_invalid = inv & ~fb
        unparsed = [i for i, (parses, _v) in host_vals.items()
                    if not parses]
        if unparsed:
            row_invalid[torch.tensor(unparsed, device=inv.device)] = True
        if ansi_mode:
            bad = torch.nonzero(row_invalid & ~in_null).squeeze(1)
            if bad.shape[0]:
                i = int(bad[0]) + b0
                raise ExceptionWithRowIndex(
                    i, "invalid URI at row %d" % i)

        if what == "query_key":
            vals = qvals
            for i, (_parses, v) in host_vals.items():
                vals[i] = v
            parts.append(Column.from_strings(vals, chars.device))
        else:
            # device spans, host rows spliced in by build_string_column
            patch = {i: v for i, (_p, v) in host_vals.items()} \
                if host_vals else None
            parts.append(spans_to_strings(
                chars, lo, hi, valid & ~in_null & ~fb, patch))

    if len(parts) == 1:
        return parts[0]
    from spark_rapids_tpu_torch.columns.table import Table
    from spark_rapids_tpu_torch.ops.copying import concat_tables
    return concat_tables([Table([p]) for p in parts]).columns[0]


def _materialize_query_key(chars: torch.Tensor, lo: torch.Tensor,
                           hi: torch.Tensor, valid: torch.Tensor,
                           key: str) -> List[Optional[str]]:
    """parse_url(..., QUERY, key) over the device-extracted query spans:
    the valid rows' query bytes are copied to the host in one piece, and
    the pair matching is the single matcher in ops/parse_uri."""
    from spark_rapids_tpu_torch.ops.parse_uri import match_query_key

    spans = spans_to_strings(chars, lo, hi, valid)
    flat = spans.data.cpu().numpy().tobytes()
    offs = spans.offsets.cpu().numpy().tolist()
    ok = valid.cpu().numpy().tolist()
    out: List[Optional[str]] = [None] * len(ok)
    for i, good in enumerate(ok):
        if not good:
            continue
        v = match_query_key(flat[offs[i]:offs[i + 1]], key)
        if v is not None:
            out[i] = v.decode("utf-8", errors="replace")
    return out


def use_device(col: Column) -> bool:
    """Not accelerator-gated: parse_uri's host path is a per-row Python
    parse (ops/parse_uri.py), so the positional pass wins on any
    device."""
    if os.environ.get("SPARK_RAPIDS_TPU_FORCE_DEVICE_PARSE_URI") == "1":
        return True
    min_rows = int(os.environ.get(
        "SPARK_RAPIDS_TPU_PARSE_URI_DEVICE_MIN", "512"))
    return col.length >= min_rows
