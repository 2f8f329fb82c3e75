"""Spark get_json_object (reference get_json_object.cu + json_parser.cuh,
JSONUtils.getJsonObject:64-106).

Path instructions: $ root, .name / ['name'], [index], [*] wildcard; arrays
flatten implicitly under named access (Spark evaluatePath).  The tolerant
parser accepts single-quoted strings and unescaped control characters
(json_parser.cuh Spark options).  Output: unescaped text for a single
string scalar, raw literal for other scalars, compact normalized JSON for
objects/arrays, a JSON array of results for multiple wildcard matches,
null for no match / invalid JSON / invalid path.

Three engines give the same bytes: this module's host evaluator (the
oracle every other engine sends its flagged rows to), the per-row device
scan (ops/json_device.py) and the structural-index tokenizer
(ops/json_tokenizer.py).  route_json_engine picks among them by
measurement.  Every entry returns its column on the input column's
device.

The multi-path API mirrors the reference's memory-budgeted batch entry
(get_json_object.hpp:9-14): paths are processed in chunks whose estimated
scratch fits the budget -- the same chunking contract, applied host-side.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops.cast_string import _java_double_repr

MAX_PATH_DEPTH = 16  # get_json_object.hpp:2


# ----------------------------------------------------------- path parsing

class Named:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name


class Index:
    __slots__ = ("index",)

    def __init__(self, index):
        self.index = index


class Wildcard:
    pass


def parse_path(path: str) -> Optional[List]:
    """JSON path -> instruction list; None if malformed."""
    if not path or path[0] != "$":
        return None
    out: List = []
    i = 1
    n = len(path)
    while i < n:
        c = path[i]
        if c == ".":
            i += 1
            if i < n and path[i] == "*":
                out.append(Wildcard())
                i += 1
                continue
            j = i
            while j < n and path[j] not in ".[":
                j += 1
            if j == i:
                return None
            out.append(Named(path[i:j]))
            i = j
        elif c == "[":
            j = path.find("]", i)
            if j < 0:
                return None
            body = path[i + 1: j].strip()
            if body == "*":
                out.append(Wildcard())
            elif len(body) >= 2 and body[0] == "'" and body[-1] == "'":
                out.append(Named(body[1:-1]))
            elif body.isdigit():
                out.append(Index(int(body)))
            else:
                return None
            i = j + 1
        else:
            return None
    if len(out) > MAX_PATH_DEPTH:
        return None
    return out


# ------------------------------------------------------- tolerant parser

class _Invalid(Exception):
    pass


_WS = " \t\n\r"
_ESCAPES = {'"': '"', "'": "'", "\\": "\\", "/": "/", "b": "\b",
            "f": "\f", "n": "\n", "r": "\r", "t": "\t"}


class _Parser:
    def __init__(self, s: str, allow_leading_zeros: bool = False):
        self.s = s
        self.i = 0
        self.n = len(s)
        self.allow_leading_zeros = allow_leading_zeros

    def ws(self):
        while self.i < self.n and self.s[self.i] in _WS:
            self.i += 1

    def parse(self):
        self.ws()
        v = self.value()
        self.ws()
        if self.i != self.n:
            raise _Invalid()
        return v

    def value(self):
        if self.i >= self.n:
            raise _Invalid()
        c = self.s[self.i]
        if c == "{":
            return self.obj()
        if c == "[":
            return self.arr()
        if c in "\"'":
            return ("str", self.string(c))
        if c == "t" and self.s[self.i:self.i + 4] == "true":
            self.i += 4
            return ("lit", "true")
        if c == "f" and self.s[self.i:self.i + 5] == "false":
            self.i += 5
            return ("lit", "false")
        if c == "n" and self.s[self.i:self.i + 4] == "null":
            self.i += 4
            return ("lit", "null")
        return ("num", self.number())

    def obj(self):
        self.i += 1
        items = []
        self.ws()
        if self.i < self.n and self.s[self.i] == "}":
            self.i += 1
            return ("obj", items)
        while True:
            self.ws()
            if self.i >= self.n or self.s[self.i] not in "\"'":
                raise _Invalid()
            k = self.string(self.s[self.i])
            self.ws()
            if self.i >= self.n or self.s[self.i] != ":":
                raise _Invalid()
            self.i += 1
            self.ws()
            items.append((k, self.value()))
            self.ws()
            if self.i < self.n and self.s[self.i] == ",":
                self.i += 1
                continue
            if self.i < self.n and self.s[self.i] == "}":
                self.i += 1
                return ("obj", items)
            raise _Invalid()

    def arr(self):
        self.i += 1
        items = []
        self.ws()
        if self.i < self.n and self.s[self.i] == "]":
            self.i += 1
            return ("arr", items)
        while True:
            self.ws()
            items.append(self.value())
            self.ws()
            if self.i < self.n and self.s[self.i] == ",":
                self.i += 1
                continue
            if self.i < self.n and self.s[self.i] == "]":
                self.i += 1
                return ("arr", items)
            raise _Invalid()

    def string(self, quote):
        self.i += 1
        out = []
        while True:
            if self.i >= self.n:
                raise _Invalid()
            c = self.s[self.i]
            if c == quote:
                self.i += 1
                return "".join(out)
            if c == "\\":
                self.i += 1
                if self.i >= self.n:
                    raise _Invalid()
                e = self.s[self.i]
                if e == "u":
                    hexs = self.s[self.i + 1: self.i + 5]
                    # strict 4 hex digits (int() would tolerate ' 041',
                    # '0x..', '1_2' — Java and the device DFA reject)
                    if len(hexs) < 4 or not all(
                            c in "0123456789abcdefABCDEF" for c in hexs):
                        raise _Invalid()
                    cp = int(hexs, 16)
                    self.i += 5
                    # combine surrogate pairs (json.dumps ensure_ascii
                    # writes emoji as 😀); lone surrogates are
                    # unencodable in UTF-8 -> U+FFFD like Java's replace
                    if 0xD800 <= cp <= 0xDBFF and \
                            self.s[self.i: self.i + 2] == "\\u":
                        hex2 = self.s[self.i + 2: self.i + 6]
                        if len(hex2) == 4 and all(
                                c in "0123456789abcdefABCDEF"
                                for c in hex2):
                            lo = int(hex2, 16)
                        else:
                            lo = -1
                        if 0xDC00 <= lo <= 0xDFFF:
                            cp = 0x10000 + ((cp - 0xD800) << 10) \
                                + (lo - 0xDC00)
                            self.i += 6
                        else:
                            cp = 0xFFFD
                    elif 0xD800 <= cp <= 0xDFFF:
                        cp = 0xFFFD
                    out.append(chr(cp))
                    continue
                if e not in _ESCAPES:
                    raise _Invalid()
                out.append(_ESCAPES[e])
                self.i += 1
                continue
            # unescaped control chars allowed (Spark option)
            out.append(c)
            self.i += 1

    def number(self):
        start = self.i
        if self.i < self.n and self.s[self.i] == "-":
            self.i += 1
        digits = 0
        first_digit_i = self.i
        while self.i < self.n and self.s[self.i].isdigit():
            self.i += 1
            digits += 1
        if digits == 0:
            raise _Invalid()
        if digits > 1 and self.s[first_digit_i] == "0" \
                and not self.allow_leading_zeros:
            # invalid JSON numbers for get_json_object; from_json can
            # opt in via Spark's allowNumericLeadingZeros
            raise _Invalid()
        if self.i < self.n and self.s[self.i] == ".":
            self.i += 1
            while self.i < self.n and self.s[self.i].isdigit():
                self.i += 1
        if self.i < self.n and self.s[self.i] in "eE":
            self.i += 1
            if self.i < self.n and self.s[self.i] in "+-":
                self.i += 1
            ed = 0
            while self.i < self.n and self.s[self.i].isdigit():
                self.i += 1
                ed += 1
            if ed == 0:
                raise _Invalid()
        return self.s[start: self.i]


# ------------------------------------------------------------ evaluation

def _escape(s: str) -> str:
    out = ['"']
    for c in s:
        if c == '"':
            out.append('\\"')
        elif c == "\\":
            out.append("\\\\")
        elif c == "\n":
            out.append("\\n")
        elif c == "\r":
            out.append("\\r")
        elif c == "\t":
            out.append("\\t")
        elif ord(c) < 0x20:
            out.append(f"\\u{ord(c):04x}")
        else:
            out.append(c)
    out.append('"')
    return "".join(out)


def _normalize_number(text: str) -> str:
    """Spark-normalized number rendering (get_json_object writes
    numbers through Java double formatting when fractional/exponential;
    GetJsonObjectTest getJsonObjectTest_Number_Normalization):
    integer tokens stay verbatim (arbitrary precision, -0 -> 0);
    float tokens render as Java Double.toString, overflowing to the
    JSON STRING "Infinity"/"-Infinity"."""
    if not any(c in text for c in ".eE"):
        return "0" if text in ("-0", "0") else text
    v = float(text)
    if v in (float("inf"), float("-inf")):
        return _escape("Infinity" if v > 0 else "-Infinity")
    return _java_double_repr(v, False)


def _render_json(v, normalize_numbers: bool = True) -> str:
    """normalize_numbers=True is get_json_object's Java-normalized
    rendering; the from_json family passes False to keep number tokens
    verbatim (from_json_to_raw_map.cu copies raw token substrings)."""
    kind = v[0]
    if kind == "str":
        return _escape(v[1])
    if kind == "num":
        return _normalize_number(v[1]) if normalize_numbers else v[1]
    if kind == "lit":
        return v[1]
    if kind == "obj":
        return "{" + ",".join(
            f"{_escape(k)}:{_render_json(x, normalize_numbers)}"
            for k, x in v[1]) + "}"
    return "[" + ",".join(_render_json(x, normalize_numbers)
                          for x in v[1]) + "]"


def _eval(v, path: List) -> List:
    if not path:
        return [v]
    ins = path[0]
    kind = v[0]
    if isinstance(ins, Named):
        if kind == "obj":
            out = []
            for k, child in v[1]:
                if k == ins.name:
                    out.extend(_eval(child, path[1:]))
            return out
        if kind == "arr":  # implicit array flattening under named access
            out = []
            for el in v[1]:
                out.extend(_eval(el, path))
            return out
        return []
    if isinstance(ins, Index):
        if kind == "arr" and 0 <= ins.index < len(v[1]):
            return _eval(v[1][ins.index], path[1:])
        return []
    if isinstance(ins, Wildcard):
        if kind == "arr":
            out = []
            for el in v[1]:
                out.extend(_eval(el, path[1:]))
            return out
        return []
    return []


def _run_one(doc: Optional[str], path: Optional[List]) -> Optional[str]:
    if doc is None or path is None:
        return None
    try:
        v = _Parser(doc).parse()
    except _Invalid:
        return None
    matches = _eval(v, path)
    if not matches:
        return None
    if len(matches) == 1:
        m = matches[0]
        if m[0] == "str":
            return m[1]
        return _render_json(m)
    return "[" + ",".join(_render_json(m) for m in matches) + "]"


def get_json_object_host(col: Column, path: str) -> Column:
    """Host evaluator (the oracle for the device engines' fallback
    rows), returning its column on the input's device."""
    assert col.dtype.is_string
    instructions = parse_path(path)
    vals = col.to_pylist()
    return Column.from_strings([_run_one(v, instructions) for v in vals],
                               col.device)


# rows at or above this count route through the device engines; tiny
# columns stay host-side (override via env)
DEVICE_MIN_ROWS = int(os.environ.get("SPARK_RAPIDS_TPU_JSON_MIN_ROWS", 32))

# rows at or above this count earn a measured engine pick; below it the
# static default is cheaper than timing anything
JSON_CALIBRATE_MIN_ROWS = 1 << 14

# sampled rows each calibration candidate runs over
JSON_SAMPLE_ROWS = 1 << 14


class _EngineDeclined(RuntimeError):
    """A decline-capable engine refused the calibration sample."""


def route_json_engine(op: str, col: Column, engines, default: str,
                      extra: str = "") -> str:
    """Measured engine pick for a JSON string-column op.

    ``engines`` maps path name -> fn(col); candidates time a sampled
    slice of ``col`` under the shared calibrator
    (perf/calibrate.pick_path), keyed by (op, doc-shape digest, the
    column's device).  Every engine is byte-identical by contract
    (per-row host fallback), so the pick is SPEED only.  Small columns
    return ``default`` untimed; SPARK_RAPIDS_TPU_PATH_<OP> pins a
    path."""
    from spark_rapids_tpu_torch.ops.copying import slice_column
    from spark_rapids_tpu_torch.perf import calibrate

    pin = calibrate.pinned_path(op)
    if pin is not None and pin in engines:
        return pin
    rows = col.length
    if rows < JSON_CALIBRATE_MIN_ROWS or len(engines) <= 1:
        return default
    nbytes = int(col.offsets[-1]) if col.offsets is not None else 0
    mean_len = max(nbytes // max(rows, 1), 1)
    digest = (f"{extra}|rb{rows.bit_length()}"
              f"|lb{mean_len.bit_length()}")
    sub = slice_column(col, 0, JSON_SAMPLE_ROWS) \
        if rows > JSON_SAMPLE_ROWS else col

    def _ran(fn):
        # decline-capable device engines answer None for shapes they
        # refuse; timing that as a near-instant success would crown a
        # verdict whose production calls all fall back -- surface the
        # decline as a calibration error so the engine is excluded
        out = fn(sub)
        if out is None:
            raise _EngineDeclined(f"engine declined {rows}-row sample")
        if sub.device.type == "cuda":
            # the result is a Column, which the calibrator's own fence
            # does not look into
            torch.cuda.synchronize(sub.device)
        return out

    candidates = {name: (lambda fn=fn: _ran(fn))
                  for name, fn in engines.items()}
    path = calibrate.pick_path(op, digest, candidates, default=default,
                               device=col.device)
    return path if path in engines else default


def _tokenizer_path_ok(instructions) -> bool:
    return bool(instructions) and not any(
        isinstance(i, Wildcard) for i in instructions)


def get_json_object(col: Column, path: str) -> Column:
    """One strings column of extraction results (JSONUtils.getJsonObject).

    Engine choice is a measurement, not a device gate: the
    batch-parallel structural-index tokenizer (ops/json_tokenizer), the
    per-row device scan (ops/json_device) and this host evaluator are
    byte-identical candidates; the calibrator picks per (path shape,
    doc shape, device).  Wildcard paths stay on the scan/host pair
    (multi-match rendering is out of the tokenizer's scope)."""
    mode = os.environ.get("SPARK_RAPIDS_TPU_JSON", "auto")

    def _device_scan(c):
        from spark_rapids_tpu_torch.ops.json_device import \
            get_json_object_device
        return get_json_object_device(c, path)

    engines = {
        "host": lambda c: get_json_object_host(c, path),
        "device_scan": _device_scan,
    }
    if mode == "host" or (mode != "device"
                          and col.length < DEVICE_MIN_ROWS):
        engine = "host"
    elif mode == "device":
        engine = "device_scan"
    else:
        from spark_rapids_tpu_torch.ops import json_tokenizer as JT
        instructions = parse_path(path)
        tok_ok = _tokenizer_path_ok(instructions)
        if tok_ok:
            engines["tokenizer"] = \
                lambda c: JT.get_json_object_tokenized(c, path)
        # static default below the calibration floor: the device scan;
        # above it the measurement decides.  tok_ok is part of the
        # digest: wildcard and non-wildcard paths offer different
        # candidate sets and must not share a verdict
        engine = route_json_engine(
            "json.get_object", col, engines, "device_scan",
            extra=f"steps{len(instructions or ())}t{int(tok_ok)}")
    _obs.record_kernel_path("get_json_object", engine, col.length)
    return engines[engine](col)


def get_json_object_multiple_paths(col: Column, paths: Sequence[str],
                                   memory_budget_bytes: int = -1,
                                   parallel_override: int = -1
                                   ) -> List[Column]:
    """One output column per path (get_json_object.hpp:9 multi-path batch).
    The budget/parallel knobs shape chunking in the reference kernel; the
    host evaluator parses each document once per chunk of paths.  Large
    columns route through the device engines (the device scan's padded
    chunks built once and shared across paths, or one tokenize pass for
    every path), same rule as get_json_object."""
    assert col.dtype.is_string
    mode = os.environ.get("SPARK_RAPIDS_TPU_JSON", "auto")
    if mode != "host" and (mode == "device"
                           or col.length >= DEVICE_MIN_ROWS):
        from spark_rapids_tpu_torch.ops.json_device import \
            get_json_object_multiple_paths_device

        engines = {
            "device_scan": lambda c:
                get_json_object_multiple_paths_device(
                    c, paths, memory_budget_bytes, parallel_override),
        }
        parsed = [parse_path(p) for p in paths]
        tok_ok = mode != "device" and all(
            p is None or _tokenizer_path_ok(p) for p in parsed) \
            and any(p is not None for p in parsed)
        if tok_ok:
            from spark_rapids_tpu_torch.ops import json_tokenizer as JT
            engines["tokenizer"] = lambda c: \
                JT.get_json_object_multiple_paths_tokenized(c, paths)
        # the path SET is part of the digest, not just its size: two
        # 2-path batches with very different step depths must not share
        # a cached verdict for the file-cache TTL
        ph = hashlib.md5("|".join(paths).encode()).hexdigest()[:8]
        engine = route_json_engine(
            "json.get_object", col, engines, "device_scan",
            extra=f"multi{len(paths)}p{ph}t{int(tok_ok)}") \
            if mode != "device" else "device_scan"
        if engine not in engines:
            engine = "device_scan"
        _obs.record_kernel_path("get_json_object", engine, col.length)
        return engines[engine](col)
    parsed_paths = [parse_path(p) for p in paths]
    vals = col.to_pylist()
    if parallel_override > 0:
        chunk = max(1, parallel_override)
    elif memory_budget_bytes > 0:
        # reference heuristic: scratch ~ max row size per path
        max_row = max((len(v) for v in vals if v is not None), default=1)
        chunk = max(1, memory_budget_bytes // max(max_row, 1))
    else:
        chunk = len(paths) or 1
    # parse every document once per chunk of paths (the budget bounds how
    # long the parsed trees stay alive, as the reference's scratch does)
    outs: List[Column] = []
    for c0 in range(0, len(parsed_paths), chunk):
        trees = []
        for v in vals:
            if v is None:
                trees.append(None)
            else:
                try:
                    trees.append(_Parser(v).parse())
                except _Invalid:
                    trees.append(None)
        for path in parsed_paths[c0:c0 + chunk]:
            if path is None:
                outs.append(Column.from_strings([None] * len(vals),
                                                col.device))
                continue
            row_out = []
            for t in trees:
                if t is None:
                    row_out.append(None)
                    continue
                matches = _eval(t, path)
                if not matches:
                    row_out.append(None)
                elif len(matches) == 1:
                    m = matches[0]
                    row_out.append(m[1] if m[0] == "str"
                                   else _render_json(m))
                else:
                    row_out.append(
                        "[" + ",".join(_render_json(m)
                                       for m in matches) + "]")
            outs.append(Column.from_strings(row_out, col.device))
    return outs
