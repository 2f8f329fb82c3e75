"""Device protobuf decoder: the wire-format parse as a field-step scan
on the column's device.

Reference: src/main/cpp/src/protobuf/protobuf_kernels.cu:1-1062 (+
protobuf.cu 1,361, protobuf_builders.cu 623): thread-per-row varint /
wire-type parsing kernels feeding struct builders.  As in the JAX
package, one field-step loop runs over all rows of a chunk at once:

  * every row carries a cursor into its own bytes of the flat chars
    buffer (no padded matrix: a step gathers a 10-byte window at the
    cursor, masked past the row's end);
  * each step consumes exactly one tag+payload record per active row:
    two bounded varint reads, a wire-type dispatch for the next cursor,
    and the captures of every schema field at once ((fields, rows)
    compares; proto3 last-value-wins);
  * steps run until every row is done or malformed: the trip count is
    the most records a row of the chunk holds, not its byte length.

A step is a few dozen elementwise kernels over the chunk.  On the card
the first step runs eagerly, then one step is captured as a CUDA graph
and replayed, `CHECK_EVERY` replays between reads of the "any row still
active" flag (a step leaves finished and malformed rows as they are, so
the replays past the end change nothing).  `max_steps` stays the bound.

Scope (router: ops/protobuf.py): scalar bool/int32/int64/float32/
float64/string fields, DEFAULT/FIXED/ZIGZAG encodings, optional/
required, defaults (string included), NESTED messages (a nested message
is a LEN capture whose payload spans become a child binary column the
decode recurses on) and REPEATED scalars and strings: every occurrence
lands in a per-row register bank (unpacked records one per step, PACKED
payloads through a cursor state machine consuming one element per
step).  A row past the bank's capacity makes the whole column fall back
to the host oracle (SPARK_RAPIDS_TPU_PROTOBUF_REPEAT_CAP, 32).  Repeated
MESSAGES recurse too: occurrence spans flatten into one child binary
column, decode once, and wrap back as LIST<STRUCT>.

Captures, counts, banks and the chars stay on the column's device and
the string children are gathered there (columns/strbuild.py); only
sizes and flags reach the host (LAST_CALL counts them).

u64 values ride in int64 lanes (utils/u64math.py): the length clamps
are unsigned compares, zigzag is a logical shift, byte 9 of a varint
lands on bit 63 by a wrapping shift, and FLOAT32/FLOAT64 captures are
reinterpreted with `.view`, not converted.

Divergence note (shared with json_device): STRING payloads pass raw
bytes through on device while the host oracle substitutes U+FFFD for
invalid UTF-8 — Spark strings are UTF-8, so this is out of contract.

Spark semantics parity with the host decoder:
  * unknown fields / wire-type mismatches are skipped by wire type;
  * truncated varints (no terminator in-row or within 10 bytes),
    truncated payloads, and group/invalid wire types null the row;
  * missing required fields null the row (proto2);
  * missing optional fields take the schema default, else null.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import Kind
from spark_rapids_tpu_torch.columns.strbuild import build_string_column
from spark_rapids_tpu_torch.utils.u64math import M32, shr, ult

# rows per scan: bounds the step's temporaries (about 1 KB a row with
# two repeated fields); the port's own choice, 8x the JAX package's
# 2^17, since a card step at 2^20 rows still runs under its launches
DEVICE_ROW_CHUNK = 1 << 20
CHECK_EVERY = 8     # graph replays between host reads of the done flag

# wire types (protobuf encoding spec)
_VARINT, _I64BIT, _LEN, _I32BIT = 0, 1, 2, 5
_CODE = {_VARINT: 0, _I64BIT: 1, _I32BIT: 2, _LEN: 3}   # capture source

# lane shift table for varint assembly: lane i contributes bits
# (b & 0x7f) << 7i, masked to 64 bits (lane 9 only bit 63 survives —
# same wrap the host decoder applies)
_V_SHIFTS = tuple(min(7 * i, 63) for i in range(10))
_V_MASKS = tuple(0x7F if 7 * i <= 56 else (1 << (64 - 7 * i)) - 1
                 for i in range(9)) + (0x01,)

# route accounting: the router and the engine fill these
LAST_CALL: dict = {}
STATS = {"device": 0, "host": 0, "fallback": 0}
_TLS = threading.local()


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0
    LAST_CALL.clear()


def note_route(route: str, fallback: bool = False, rows=None) -> None:
    """Record the route a router call took ('device' or 'host');
    `fallback` marks the engine handing a column back (repeat cap)."""
    STATS[route] += 1
    if fallback:
        STATS["fallback"] += 1
    elif route == "host":
        LAST_CALL.clear()
    LAST_CALL.update(route=route, fallback=fallback)
    if route == "host":
        LAST_CALL["host_rows"] = int(rows)


def supported_schema(fields) -> bool:
    """True when the device engine can decode this schema: scalar
    leaves (repeated included — packed or unpacked), strings, and
    arbitrarily nested messages INCLUDING repeated ones (protobuf.hpp:
    26-67 nested_field_descriptor re-designed for the field-step
    engine)."""
    from spark_rapids_tpu_torch.ops.protobuf import DEFAULT, FIXED, ZIGZAG
    for f in fields:
        if f.field_number <= 0 or f.field_number >= (1 << 29):
            return False
        if f.is_message:
            if not supported_schema(f.children):
                return False
            continue
        if f.dtype.kind not in (Kind.BOOL8, Kind.INT32, Kind.INT64,
                                Kind.FLOAT32, Kind.FLOAT64,
                                Kind.STRING):
            return False
        if f.encoding not in (DEFAULT, FIXED, ZIGZAG):
            return False
    return True


# repeated-scalar occurrence capacity per row: rows exceeding it make
# the whole decode fall back to the host oracle (rare; configurable)
def _repeat_cap() -> int:
    return int(os.environ.get(
        "SPARK_RAPIDS_TPU_PROTOBUF_REPEAT_CAP", "32"))


def _expected_wire(f) -> int:
    from spark_rapids_tpu_torch.ops.protobuf import FIXED
    if f.is_message:
        return _LEN
    kind = f.dtype.kind
    if kind == Kind.STRING:
        return _LEN
    if f.encoding == FIXED:
        return _I64BIT if kind in (Kind.INT64, Kind.FLOAT64) else _I32BIT
    if kind == Kind.FLOAT64:
        return _I64BIT
    if kind == Kind.FLOAT32:
        return _I32BIT
    return _VARINT


def _host_int(t: torch.Tensor) -> int:
    """One scalar to the host, counted in LAST_CALL."""
    call = getattr(_TLS, "call", None)
    if call is not None:
        call["host_syncs"] += 1
    return int(t)


# ------------------------------------------------------------- the scan


class _Consts:
    """Per-device lane tables, made once per chunk."""

    def __init__(self, device):
        self.lane10 = torch.arange(10, dtype=torch.int64, device=device)
        self.masks = torch.tensor(_V_MASKS, dtype=torch.int64,
                                  device=device)
        self.shifts = torch.tensor(_V_SHIFTS, dtype=torch.int64,
                                   device=device)
        self.byte_shifts = torch.arange(0, 64, 8, dtype=torch.int64,
                                        device=device)


def _window(src, base, pos, lens, k: _Consts):
    """(R, 10) int64 bytes at row-relative `pos` (0 past the row end,
    read as a varint terminator)."""
    rel = pos[:, None] + k.lane10[None, :]
    idx = (base[:, None] + rel).clamp_(0, src.shape[0] - 1)
    return torch.where(rel < lens[:, None], src[idx].to(torch.int64), 0)


def _varint(win, pos, lens, k: _Consts):
    """(value, nbytes, ok) of the varint in each row's window: ok is
    False without a terminator in 10 bytes or past the row end."""
    is_term = (win & 0x80) == 0
    has_term = is_term.any(1)
    nbytes = torch.argmax(is_term.to(torch.uint8), 1) + 1
    used = k.lane10[None, :] < nbytes[:, None]
    # lanes hold disjoint bits, so their sum is their OR (bit 63 wraps)
    value = torch.where(used, (win & k.masks) << k.shifts, 0).sum(1)
    ok = has_term & (pos + nbytes <= lens)
    return value, nbytes, ok


def _fixed8(win, k: _Consts):
    """Little-endian u64 of a window's first 8 bytes."""
    return (win[:, :8] << k.byte_shifts).sum(1)


class _Specs:
    """The schema as lane tables: non-repeated fields, strict (message)
    field numbers, repeated fields."""

    def __init__(self, specs, device):
        self.specs = specs
        nr = [k for k, sp in enumerate(specs) if not sp[3]]
        rep = [k for k, sp in enumerate(specs) if sp[3]]
        self.nr, self.rep = nr, rep
        self.cap = max([specs[k][4] for k in rep], default=1)

        def col(vals):
            return torch.tensor(vals, dtype=torch.int64,
                                device=device)[:, None]

        self.nr_num = col([specs[k][0] for k in nr])
        self.nr_wire = col([specs[k][1] for k in nr])
        self.nr_code = torch.tensor([_CODE[specs[k][1]] for k in nr],
                                    dtype=torch.int64, device=device)
        strict = [sp[0] for sp in specs if sp[2]]
        self.strict_num = col(strict) if strict else None
        self.rep_num = col([specs[k][0] for k in rep])
        self.rep_wire = col([specs[k][1] for k in rep])
        self.rep_code = torch.tensor([_CODE[specs[k][1]] for k in rep],
                                     dtype=torch.int64, device=device)
        self.rep_packable = self.rep_wire != _LEN
        self.rep_wire_flat = self.rep_wire[:, 0].contiguous() if rep \
            else torch.zeros(1, dtype=torch.int64, device=device)
        self.rep_ids = torch.arange(len(rep), dtype=torch.int64,
                                    device=device)[:, None]


class _State:
    """The scan's registers for all rows, in place; a chunk's step
    works on row slices of them."""

    def __init__(self, rows: int, sp: _Specs, device):
        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.c = z(rows)
        self.malformed = z(rows, dtype=torch.bool)
        self.packed_end = z(rows)
        self.packed_k = z(rows)
        self.vals = z(len(sp.nr), rows)
        self.seen = z(len(sp.nr), rows, dtype=torch.bool)
        self.rcnt = z(len(sp.rep), rows)
        self.rseen = z(len(sp.rep), rows, dtype=torch.bool)
        self.rvals = z(len(sp.rep), rows, sp.cap)

    def rows(self, r0: int, r1: int) -> "_State":
        out = _State.__new__(_State)
        for name in ("c", "malformed", "packed_end", "packed_k"):
            setattr(out, name, getattr(self, name)[r0:r1])
        for name in ("vals", "seen", "rcnt", "rseen", "rvals"):
            setattr(out, name, getattr(self, name)[:, r0:r1])
        return out


def _step(src, base, lens, st: _State, sp: _Specs, k: _Consts) -> None:
    """One field step for every row of the chunk, in place (the JAX
    package's `_decode_chunk` body)."""
    c = st.c
    active = ~st.malformed & (c < lens)
    packed_now = active & (st.packed_end > 0)
    norm = active & ~packed_now

    # ---- the record at c: its tag, or a packed element ----
    win_c = _window(src, base, c, lens, k)
    tag, tlen, tag_ok = _varint(win_c, c, lens, k)
    f64_e = _fixed8(win_c, k)
    pw = sp.rep_wire_flat[st.packed_k]
    is_v = pw == _VARINT
    is_8 = pw == _I64BIT
    elem_val = torch.where(is_v, tag, torch.where(is_8, f64_e, f64_e & M32))
    elem_bytes = torch.where(
        packed_now, torch.where(is_v, tlen, torch.where(is_8, 8, 4)), 0)
    elem_ok = packed_now & torch.where(
        is_v, tag_ok, torch.where(is_8, c + 8 <= lens, c + 4 <= lens))
    packed_c_new = c + elem_bytes
    packed_exit = packed_now & (packed_c_new >= st.packed_end)
    malformed = st.malformed | (packed_now & ~elem_ok)

    # ---- normal tag parse (non-packed rows) ----
    wire = tag & 7
    num = shr(tag, 3) & M32
    s = c + tlen
    win_s = _window(src, base, s, lens, k)
    pval, plen, p_ok = _varint(win_s, s, lens, k)
    plen_bytes = torch.where(ult(pval, 1 << 30), pval, 1 << 30)
    nxt = torch.where(
        wire == _VARINT, s + plen,
        torch.where(wire == _I64BIT, s + 8,
                    torch.where(wire == _I32BIT, s + 4,
                                s + plen + plen_bytes)))
    wire_ok = ((wire == _VARINT) | (wire == _I64BIT)
               | (wire == _I32BIT) | (wire == _LEN))
    need_pv = (wire == _VARINT) | (wire == _LEN)
    step_ok = tag_ok & wire_ok & (~need_pv | p_ok) & (nxt <= lens)
    malformed = malformed | (norm & ~step_ok)
    capture = norm & step_ok

    f64 = _fixed8(win_s, k)
    # a capture needs nxt <= lens, so a captured length is below 2^30
    str_pack = ((s + plen) << 32) | (pval & M32)
    vsel = torch.stack((pval, f64, f64 & M32, str_pack))

    if sp.strict_num is not None:
        # message fields: a wire mismatch malforms the row
        malformed = malformed | (capture & (wire != _LEN) & (
            num[None, :] == sp.strict_num).any(0))
    if sp.nr:
        match = (capture[None, :] & (num[None, :] == sp.nr_num)
                 & (wire[None, :] == sp.nr_wire))
        st.vals.copy_(torch.where(match, vsel[sp.nr_code], st.vals))
        st.seen.copy_(st.seen | match)

    packed_end = torch.where(packed_exit, 0, st.packed_end)
    c_norm = torch.where(capture, torch.maximum(nxt, c + 1), c)
    if sp.rep:
        # occurrence capture: unpacked record OR packed element
        rec = (capture[None, :] & (num[None, :] == sp.rep_num)
               & (wire[None, :] == sp.rep_wire))
        pel = elem_ok[None, :] & (st.packed_k[None, :] == sp.rep_ids)
        occ = rec | pel
        val = torch.where(pel, elem_val[None, :], vsel[sp.rep_code])
        cnt = st.rcnt
        slot = cnt.clamp(max=sp.cap - 1)[:, :, None]
        old = st.rvals.gather(2, slot)
        write = (occ & (cnt < sp.cap))[:, :, None]
        st.rvals.scatter_(2, slot, torch.where(write, val[:, :, None], old))
        # packed-record entry: step into the payload.  An EMPTY packed
        # payload still marks the field seen (host: out.setdefault(num,
        # []) runs for n=0), it just never enters the state machine.
        packed_rec = (capture[None, :] & (num[None, :] == sp.rep_num)
                      & (wire[None, :] == _LEN) & sp.rep_packable)
        enter = packed_rec & (plen_bytes > 0)[None, :]
        cnt.add_(occ.to(torch.int64))
        st.rseen.copy_(st.rseen | occ | packed_rec)
        enter_any = enter.any(0)
        packed_end = torch.where(enter_any, s + plen + plen_bytes,
                                 packed_end)
        st.packed_k.copy_(torch.where(
            enter_any, (enter.to(torch.int64) * sp.rep_ids).sum(0),
            st.packed_k))
        c_norm = torch.where(enter_any, s + plen, c_norm)

    st.packed_end.copy_(packed_end)
    st.malformed.copy_(malformed)
    c.copy_(torch.where(packed_now, packed_c_new, c_norm))


def _scan_chunk(src, base, lens, st: _State, sp: _Specs,
                max_steps: int) -> int:
    """Steps until no row of the chunk is active (at most max_steps);
    returns the steps run."""
    k = _Consts(src.device)

    def any_active() -> bool:
        return bool(_host_int(((~st.malformed) & (st.c < lens)).any()))

    def step():
        _step(src, base, lens, st, sp, k)

    if max_steps <= 0 or not any_active():
        return 0
    dev = src.device
    if dev.type != "cuda":
        steps = 0
        while steps < max_steps:
            step()
            steps += 1
            if not any_active():
                break
        return steps
    # one eager step on a side stream warms the kernels up, then one
    # step is captured and replayed CHECK_EVERY times between reads
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    steps = 1
    if steps >= max_steps or not any_active():
        return steps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    while steps < max_steps:
        n = min(CHECK_EVERY, max_steps - steps)
        for _ in range(n):
            graph.replay()
        steps += n
        if not any_active():
            break
    return steps


def _scan(col: Column, specs):
    """The scan over a STRING view of the binary column, chunk by
    chunk.  Returns (malformed, state, specs tables)."""
    rows = col.length
    dev = col.device
    sp = _Specs(specs, dev)
    st = _State(rows, sp, dev)
    src = col.data
    if src is None or src.shape[0] == 0:
        src = torch.zeros(1, dtype=torch.uint8, device=dev)
    offs = col.offsets.to(torch.int64)
    any_rep = bool(sp.rep)
    call = _TLS.call
    for r0 in range(0, rows, DEVICE_ROW_CHUNK):
        r1 = min(rows, r0 + DEVICE_ROW_CHUNK)
        base = offs[r0:r1]
        lens = offs[r0 + 1:r1 + 1] - base
        L = _host_int(lens.max())
        # packed varint elements can be 1 byte each: bound steps by L
        max_steps = (L + 2) if any_rep else (L // 2 + 2)
        steps = _scan_chunk(src, base, lens, st.rows(r0, r1), sp,
                            max_steps)
        call["chunk_steps"].append(steps)
        call["rows"] += r1 - r0
    # a row that stopped before its end without being flagged is
    # impossible (cursor advances or malforms), but guard anyway
    malformed = st.malformed | (st.c < offs[1:] - offs[:-1])
    return malformed, st, sp


# ------------------------------------------------------------ finalizers


def _convert_scalar_values(f, raw: torch.Tensor) -> torch.Tensor:
    """Raw u64 captures (int64 lanes) -> typed values (zigzag / width /
    sign rules shared by the last-value and repeated finalizers)."""
    from spark_rapids_tpu_torch.ops.protobuf import ZIGZAG
    kind = f.dtype.kind
    v = raw
    if f.encoding == ZIGZAG:
        v = shr(v, 1) ^ -(v & 1)
    if kind == Kind.BOOL8:
        return (v != 0).to(torch.uint8)
    if kind in (Kind.INT32, Kind.FLOAT32):
        low = (((v & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)
        return low if kind == Kind.INT32 else low.view(torch.float32)
    if kind == Kind.INT64:
        return v.clone()
    if kind == Kind.FLOAT64:
        return v.clone().view(torch.float64)
    raise AssertionError(kind)


def _validity(valid: torch.Tensor) -> Optional[torch.Tensor]:
    return None if bool(_host_int(valid.all())) else valid.to(torch.uint8)


def _finalize_numeric(f, raw, seen, rownull) -> Column:
    """Raw capture -> typed column with defaults / validity."""
    kind = f.dtype.kind
    out = _convert_scalar_values(f, raw)
    has_default = f.default is not None
    if has_default:
        fill = f.default
        if kind == Kind.BOOL8:
            fill = int(bool(fill))
        out = torch.where(seen, out, torch.tensor(fill, dtype=out.dtype,
                                                  device=out.device))
    valid = (seen | has_default) & ~rownull
    return Column(f.dtype, out.shape[0], data=out,
                  validity=_validity(valid))


def _spans(raw: torch.Tensor):
    """(row-relative start, length) of packed LEN captures."""
    return shr(raw, 32), raw & M32


def decode_protobuf_to_struct_device(col: Column,
                                     fields) -> Optional[Column]:
    """Device decode; None when the schema needs the host path or a row
    overflows the occurrence capacity (router: ops/protobuf.py
    decode_protobuf_to_struct)."""
    top = getattr(_TLS, "call", None) is None
    if top:
        _TLS.call = {"rows": 0, "chunk_steps": [], "host_syncs": 0,
                     "decodes": 0}
    try:
        out = _decode(col, fields)
        if top:
            call = _TLS.call
            LAST_CALL.clear()
            LAST_CALL.update(
                call, chunk_rows=DEVICE_ROW_CHUNK,
                scan_steps=sum(call["chunk_steps"]),
                host_bytes=8 * call["host_syncs"], host_rows=0,
                handed_back=out is None)
        return out
    finally:
        if top:
            _TLS.call = None


def _decode(col: Column, fields) -> Optional[Column]:
    if not supported_schema(fields):
        return None
    rows = col.length
    if rows == 0:
        return None
    if col.dtype.kind == Kind.LIST:     # binary LIST<UINT8>: same
        col = Column(dtypes.STRING, rows,  # layout as a string column
                     data=col.children[0].data,
                     validity=col.validity, offsets=col.offsets)
    elif not col.dtype.is_string:
        return None
    _TLS.call["decodes"] += 1
    dev = col.device

    cap = _repeat_cap()
    specs = tuple((f.field_number, _expected_wire(f), f.is_message,
                   f.repeated, cap)
                  for f in fields)
    rep_idx = [k for k, f in enumerate(fields) if f.repeated]
    in_null = ~col.valid_mask()

    malformed, st, sp = _scan(col, specs)
    # occurrence-capacity overflow: the whole column falls back to the
    # host oracle (the router treats None as "host path")
    if rep_idx and _host_int((st.rcnt > cap).any()):
        return None

    def seen_of(k):
        if fields[k].repeated:
            return st.rseen[sp.rep.index(k)]
        return st.seen[sp.nr.index(k)]

    def raw_of(k):
        return st.vals[sp.nr.index(k)]

    required_missing = torch.zeros(rows, dtype=torch.bool, device=dev)
    for k, f in enumerate(fields):
        if f.required:
            required_missing |= ~seen_of(k)

    offs = col.offsets.to(torch.int64)
    src = col.data if col.data is not None else torch.zeros(
        0, dtype=torch.uint8, device=dev)

    def span_column(k, keep, default=None, default_rows=None):
        """LEN capture k -> string/binary column of payload spans;
        default splices into `default_rows` (unseen, non-null)."""
        starts, lens = _spans(raw_of(k))
        return build_string_column(
            src, offs[:-1] + starts, lens, keep,
            fill_rows=default_rows if default is not None else None,
            fill_text=default)

    def occurrence_layout(r):
        """Flat occurrence layout for repeated field r: counts keep
        their raw values even for rows that later turn null — the
        parent struct validity hides those lists, and a stable layout
        lets spans/values resolve before rownull exists."""
        cnts = st.rcnt[r]
        offsets = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
        torch.cumsum(cnts, 0, out=offsets[1:])
        total = _host_int(offsets[-1])
        row_ids = torch.repeat_interleave(
            torch.arange(rows, device=dev), cnts, output_size=total)
        k_of = torch.arange(total, device=dev) - offsets[:-1][row_ids]
        return offsets.to(torch.int32), total, row_ids, k_of

    def occurrence_strings(r, row_ids, k_of):
        """LEN occurrence spans -> flat string/binary column."""
        starts, lens = _spans(st.rvals[r][row_ids, k_of])
        return build_string_column(src, offs[:-1][row_ids] + starts, lens)

    # nested messages first: a malformed/required-missing submessage
    # (single or any repeated occurrence) nulls the WHOLE parent row
    # (host _decode_message raises through)
    sub_cols: dict = {}
    rep_msg: dict = {}
    sub_bad = torch.zeros(rows, dtype=torch.bool, device=dev)
    for k, f in enumerate(fields):
        if not f.is_message:
            continue
        if f.repeated:
            r = sp.rep.index(k)
            offsets, total, row_ids, k_of = occurrence_layout(r)
            sub = None
            if total:
                texts = occurrence_strings(r, row_ids, k_of)
                sub = _decode(texts, f.children)
                if sub is None:
                    return None    # nested occurrence-capacity overflow
                sub_bad[row_ids[~sub.valid_mask()]] = True
            rep_msg[k] = (sub, offsets)
            continue
        child_bytes = span_column(k, seen_of(k))
        sub = _decode(child_bytes, f.children)
        if sub is None:
            # a nested repeated field overflowed its occurrence
            # capacity: the whole column takes the host path
            return None
        sub_bad |= seen_of(k) & ~sub.valid_mask()
        sub_cols[k] = sub

    rownull = in_null | malformed | required_missing | sub_bad

    def repeated_column(k, f):
        """Occurrence bank -> LIST column (host _build_column repeated
        shape: the parent struct's validity hides null rows' lists)."""
        r = sp.rep.index(k)
        offsets, total, row_ids, k_of = occurrence_layout(r)
        if f.dtype.is_string:
            child = occurrence_strings(r, row_ids, k_of)
        else:
            vals = _convert_scalar_values(f, st.rvals[r][row_ids, k_of])
            child = Column(f.dtype, total, data=vals)
        return Column.make_list(offsets, child)

    def repeated_message_column(k, f):
        """LIST<STRUCT> from the recursed occurrence decode."""
        sub, offsets = rep_msg[k]
        if sub is None:    # zero occurrences anywhere
            # the host builder on the repeated field itself yields the
            # correctly-typed 0-row STRUCT list child
            from spark_rapids_tpu_torch.ops.protobuf import _build_column
            sub = _build_column(f, [None], 1, dev).children[0]
        return Column.make_list(offsets, sub)

    children = []
    for k, f in enumerate(fields):
        if f.repeated and f.is_message:
            children.append(repeated_message_column(k, f))
        elif f.repeated:
            children.append(repeated_column(k, f))
        elif f.is_message:
            sub = sub_cols[k]
            keep = seen_of(k) & ~rownull
            children.append(Column(sub.dtype, rows,
                                   validity=_validity(keep),
                                   children=sub.children))
        elif f.dtype.is_string:
            children.append(span_column(
                k, seen_of(k) & ~rownull, default=f.default,
                default_rows=~seen_of(k) & ~rownull))
        else:
            children.append(_finalize_numeric(f, raw_of(k), seen_of(k),
                                              rownull))

    return Column.make_struct(rows, children, validity=_validity(~rownull))


def use_device(col: Column, fields) -> bool:
    """The engine for a card column, the host oracle for a CPU column;
    SPARK_RAPIDS_TPU_FORCE_DEVICE_PROTOBUF=1 drives the engine on CPU
    tensors too.  Both need a supported schema."""
    if os.environ.get("SPARK_RAPIDS_TPU_FORCE_DEVICE_PROTOBUF") == "1":
        return supported_schema(fields)
    return col.device.type != "cpu" and supported_schema(fields)
