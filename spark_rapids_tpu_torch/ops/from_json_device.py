"""Device from_json (flat and nested schemas): typed extraction over the
JSON pushdown scan.

Reference: src/main/cpp/src/from_json_to_structs.cu:1-959 (typed
extraction kernels behind JSONUtils.fromJSONToStructs).  As in the JAX
package this reuses get_json_object's scan (json_device.py) once per
schema node with path $.<name>..., then diverges from get_json_object
only in rendering rules:

  * number tokens are copied VERBATIM (from_json does no Java double
    normalization -- from_json_to_raw_map.cu copies raw substrings), so
    fractional/negative numbers stay on device;
  * a matched literal `null` nulls the field (get_json_object renders
    the text "null");
  * leaf typing goes through convert_from_strings, whose int/float
    paths are the port's device cast engines.

Per-row host fallback (json_device discipline): rows the scan flags
(deep nesting, invalid UTF-8 ...), rows with duplicate keys (from_json
is last-wins; the scan captures one match), string values with escapes,
and nested values whose verbatim span may not equal the re-rendered
text (whitespace / single quotes / control chars).  The host parser
stays the oracle; each fallback row's bytes cross to the host once and
its parse tree is shared across all schema nodes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType
from spark_rapids_tpu_torch.columns.strbuild import (build_string_column,
                                                     host_row_bytes)


def _ws(chars: torch.Tensor) -> torch.Tensor:
    return (chars == 0x20) | (chars == 0x09) | (chars == 0x0A) | \
        (chars == 0x0D)


def _root_is_object(padded) -> torch.Tensor:
    """First non-whitespace char is '{' (from_json nulls non-object
    rows regardless of field matches), over every padded chunk."""
    outs = []
    for pc in padded:
        chars = pc.chars_t.T
        R, L = chars.shape
        idx = torch.arange(L, device=chars.device)[None, :]
        nonws = ~_ws(chars) & (idx < pc.lens[:, None])
        first = torch.argmax(nonws.to(torch.uint8), dim=1)
        outs.append(nonws.any(1) & (
            chars[torch.arange(R, device=chars.device), first] == 123))
    return torch.cat(outs)


def _host_trees(col: Column, rows: torch.Tensor, host_trees: Dict,
                allow_lz: bool = False) -> None:
    """Parse the rows not yet in `host_trees` (tolerant JSON; None for
    invalid documents): only their bytes cross to the host, once, and
    every schema node shares the trees."""
    from spark_rapids_tpu_torch.ops import json_path as JP
    todo = [i for i in rows.tolist() if i not in host_trees]
    if not todo:
        return
    idx = torch.tensor(todo, dtype=torch.int64, device=col.device)
    for i, raw in zip(todo, host_row_bytes(col, idx)):
        try:
            host_trees[i] = JP._Parser(
                raw.decode("utf-8", errors="replace"), allow_lz).parse()
        except JP._Invalid:
            host_trees[i] = None


def _tree_nav(tree, steps):
    """Navigate a host parse tree along struct field names (duplicate
    keys last-wins via dict()); None when missing or off-path."""
    cur = tree
    for name in steps:
        if cur is None or cur[0] != "obj":
            return None
        cur = dict(cur[1]).get(name)
    return cur


def _scan(col: Column, steps, padded, allow_lz):
    from spark_rapids_tpu_torch.ops import json_device as JD
    from spark_rapids_tpu_torch.ops import json_path as JP
    return JD._scan_column(col, [JP.Named(n) for n in steps],
                           padded=padded, allow_leading_zeros=allow_lz)


def _field_strings(col: Column, steps, padded, host_trees,
                   allow_lz: bool = False):
    """One leaf at struct path `steps` -> (raw string column
    (pre-typing), doc-valid mask): device spans with per-row host
    fallback.  `steps` is a list of struct field names; [] matches the
    root value (used when recursing into list elements)."""
    from spark_rapids_tpu_torch.ops import json_device as JD
    from spark_rapids_tpu_torch.ops.json_utils import _value_as_raw_string

    (valid, mcount, mstart, mend, mkind, _mf, _mn, f_ws, f_sq, f_escun,
     f_ctrl, f_anyesc, _ff, _fz, fb) = _scan(col, steps, padded, allow_lz)
    in_valid = col.valid_mask()

    is_str = mkind == JD._K_STR
    is_lit = mkind == JD._K_LIT
    is_nested = (mkind == JD._K_OBJ) | (mkind == JD._K_ARR)
    # from_json renders numbers verbatim: f_float / f_negz are safe
    nested_unsafe = f_ws | f_sq | f_escun | f_ctrl
    fast_ok = torch.where(is_str, ~f_anyesc, ~is_nested | ~nested_unsafe)
    need_host = in_valid & (fb | (valid & (
        (mcount > 1) | ((mcount == 1) & ~fast_ok))))
    dev_copy = in_valid & ~need_host & valid & (mcount == 1)

    span_start = col.offsets[:-1].to(torch.int64) + torch.where(
        is_str, mstart + 1, mstart)
    span_len = torch.where(is_str, mend - mstart - 2, mend - mstart)

    # matched literal `null` -> field null (first span char is 'n')
    n = col.data.shape[0]
    if n:
        lit_first = col.data[span_start.clamp(0, n - 1)]
        dev_copy = dev_copy & ~(is_lit & (lit_first == 110))
    span_len = torch.where(dev_copy, span_len.clamp(min=0), 0)

    # host fallback rows: parse once, share the tree across fields
    fb_idx = torch.nonzero(need_host).squeeze(1)
    _host_trees(col, fb_idx, host_trees, allow_lz)
    fb_vals = {}
    for i in fb_idx.tolist():
        got = _tree_nav(host_trees[i], steps)
        fb_vals[i] = (None if got is None or got == ("lit", "null")
                      else _value_as_raw_string(got))
    out = build_string_column(col.data, span_start, span_len, dev_copy,
                              fb_vals or None)
    return out, valid


def _presence(col: Column, steps, want_kind, padded, host_trees,
              host_tag: str, allow_lz: bool = False):
    """Bool mask: the value at struct path `steps` exists and has the
    scan kind `want_kind` (K_OBJ for struct nodes, K_ARR for lists);
    rows the scan can't judge resolve via the host tree."""
    (valid, mcount, _ms, _me, mkind, _mf, _mn, _fw, _fsq, _fe, _fc, _fa,
     _ff, _fz, fb) = _scan(col, steps, padded, allow_lz)
    in_valid = col.valid_mask()
    need_host = in_valid & (fb | (valid & (mcount > 1)))
    present = (in_valid & ~need_host & valid & (mcount == 1)
               & (mkind == want_kind))
    host_idx = torch.nonzero(need_host).squeeze(1)
    _host_trees(col, host_idx, host_trees, allow_lz)
    for i in host_idx.tolist():
        got = _tree_nav(host_trees[i], steps)
        present[i] = got is not None and got[0] == host_tag
    return present, valid


def _split_elements(pc, dev_rows, mstart, mend):
    """Top-level element spans of the arrays at [mstart, mend) of one
    padded chunk's `dev_rows`: (element rows (chunk-local), element
    start, element end, rows holding an empty element).  One pass of
    row-wise prefix ops: backslash-parity string masking, then a
    bracket-depth cumsum (the reference walks each row's nesting per
    thread, from_json_to_structs.cu)."""
    chars = pc.chars_t.T
    R, L = chars.shape
    dev = chars.device
    idx = torch.arange(L, device=dev)[None, :]
    # a quote is real unless preceded by an odd run of backslashes
    is_bs = chars == 92
    last_nonbs = torch.cummax(torch.where(~is_bs, idx, -1), dim=1).values
    runlen = idx - last_nonbs
    prev_run = torch.zeros_like(runlen)
    prev_run[:, 1:] = runlen[:, :-1]
    quote = (chars == 34) & ((prev_run % 2) == 0)
    inside = (torch.cumsum(quote.to(torch.int32), 1) % 2) == 1
    open_b = ((chars == 123) | (chars == 91)) & ~inside
    close_b = ((chars == 125) | (chars == 93)) & ~inside
    depth = torch.cumsum(open_b.to(torch.int32) - close_b.to(torch.int32),
                         1)
    s = torch.where(dev_rows, mstart, 0).to(torch.int64)
    e = torch.where(dev_rows, mend, 1).to(torch.int64)
    depth_at_s = depth.gather(1, s[:, None])
    in_span = (idx > s[:, None]) & (idx < (e - 1)[:, None])
    comma_top = in_span & ~inside & (depth == depth_at_s) & (chars == 44)
    nws = ~_ws(chars) & (idx < pc.lens[:, None])
    has_content = (in_span & nws).any(1) & dev_rows
    ncommas = comma_top.sum(1)
    cnt = torch.where(has_content, ncommas + 1, 0)
    _cr, cp = torch.nonzero(comma_top, as_tuple=True)

    total = int(cnt.sum())
    rows = torch.repeat_interleave(torch.arange(R, device=dev), cnt,
                                   output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(total, device=dev) - first[rows]
    cbase = torch.cumsum(ncommas, 0) - ncommas
    start = s[rows] + 1
    end = e[rows] - 1
    if cp.shape[0]:
        ci = cbase[rows] + k
        nc = cp.shape[0] - 1
        start = torch.where(k == 0, start, cp[(ci - 1).clamp(0, nc)] + 1)
        end = torch.where(k == cnt[rows] - 1, end, cp[ci.clamp(0, nc)])
    # whitespace-only elements ("[1,,2]", trailing commas): not
    # verbatim-splittable -> host verdict for the whole row
    nws_cum = torch.cumsum(nws.to(torch.int32), 1)

    def cum_at(pos):
        v = nws_cum[rows, (pos - 1).clamp(0, L - 1)]
        return torch.where(pos > 0, v, 0)

    empty = torch.zeros(R, dtype=torch.bool, device=dev)
    if total:
        empty[rows[cum_at(end) - cum_at(start) <= 0]] = True
    keep = ~empty[rows]
    return rows[keep], start[keep], end[keep], empty & has_content


def _list_column(col: Column, steps, elem_spec, padded, host_trees,
                 allow_lz: bool = False):
    """LIST node at struct path `steps`: the array's verbatim span is
    located by the scan, top-level elements are split with tensor ops
    over each padded chunk, and the element texts become a CHILD string
    column the schema recursion re-enters with an empty path.  Rows the
    split cannot judge (single-quote strings, empty elements,
    multi-match) fall back per row to the host parser."""
    from spark_rapids_tpu_torch.ops import json_device as JD
    from spark_rapids_tpu_torch.ops.json_utils import (_build_json_column,
                                                       _render_json)

    rows = col.length
    device = col.device
    (valid, mcount, mstart, mend, mkind, _mf, _mn, _fw, f_sq, _fe, _fc,
     _fa, _ff, _fz, fb) = _scan(col, steps, padded, allow_lz)
    in_valid = col.valid_mask()
    # single-quote (tolerant) strings break the double-quote parity
    # masking: host those rows
    need_host = in_valid & (fb | (valid & ((mcount > 1) | f_sq)))
    dev = in_valid & ~need_host & valid & (mcount == 1) & \
        (mkind == JD._K_ARR)

    cnt = torch.zeros(rows, dtype=torch.int64, device=device)
    e_rows, e_start, e_len = [], [], []
    offs = col.offsets[:-1].to(torch.int64)
    for pc in padded:
        r0, r1 = pc.r0, pc.r1
        er, es, ee, empty = _split_elements(
            pc, dev[r0:r1], mstart[r0:r1], mend[r0:r1])
        need_host[r0:r1] |= empty
        dev[r0:r1] &= ~empty
        cnt[r0:r1] = torch.bincount(er, minlength=r1 - r0)
        e_rows.append(er + r0)
        e_start.append(offs[er + r0] + es)
        e_len.append(ee - es)

    # host rows: element texts re-rendered from the parse tree
    host_idx = torch.nonzero(need_host).squeeze(1)
    _host_trees(col, host_idx, host_trees, allow_lz)
    host_elems = {}
    for i in host_idx.tolist():
        got = _tree_nav(host_trees[i], steps)
        host_elems[i] = (None if got is None or got[0] != "arr" else
                         [_render_json(it, normalize_numbers=False)
                          for it in got[1]])
    present = dev.clone()
    hp = [(i, el) for i, el in host_elems.items() if el is not None]
    if hp:
        hi = torch.tensor([i for i, _ in hp], dtype=torch.int64,
                          device=device)
        present[hi] = True
        cnt[hi] = torch.tensor([len(el) for _, el in hp],
                               dtype=torch.int64, device=device)

    offsets = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(cnt, 0, out=offsets[1:])
    total = int(offsets[-1])
    if total:
        er = torch.cat(e_rows)
        first = torch.cumsum(torch.bincount(er, minlength=rows), 0)
        # device elements are row-major: element k of row r lands at
        # offsets[r] + k
        k = torch.arange(er.shape[0], device=device) - (
            first - torch.bincount(er, minlength=rows))[er]
        at = offsets[er] + k
        child_start = torch.zeros(total, dtype=torch.int64, device=device)
        child_len = torch.zeros(total, dtype=torch.int64, device=device)
        dev_child = torch.zeros(total, dtype=torch.bool, device=device)
        child_start[at] = torch.cat(e_start)
        child_len[at] = torch.cat(e_len)
        dev_child[at] = True
        bases = offsets[[i for i, _ in hp]].tolist() if hp else []
        host_patch = {b + j: text for (_i, el), b in zip(hp, bases)
                      for j, text in enumerate(el)}
        child_texts = build_string_column(col.data, child_start,
                                          child_len, dev_child,
                                          host_patch or None)
        elem_col, _ = _node_column(child_texts, [], elem_spec, None, {},
                                   allow_lz)
    else:
        # all arrays empty/null: a typed empty child from the host
        # builder (the scan cannot run on zero rows)
        elem_col = _build_json_column([], elem_spec, device)
    out = Column.make_list(
        offsets.to(torch.int32), elem_col,
        validity=None if bool(present.all()) else present.to(torch.uint8),
        device=device)
    return out, valid


def _node_column(col: Column, steps, spec, padded, host_trees,
                 allow_lz: bool = False):
    """Schema recursion: leaf DType | ("struct", fields) |
    ("list", spec) at struct path `steps` (json_utils.hpp:10-23
    parallel-schema-vector analog: one scan per node, all rows at
    once)."""
    from spark_rapids_tpu_torch.ops import json_device as JD
    from spark_rapids_tpu_torch.ops.json_utils import convert_from_strings

    if padded is None:
        padded = JD.padded_chunks(col)
    if isinstance(spec, DType):
        raw, valid = _field_strings(col, steps, padded, host_trees,
                                    allow_lz)
        return convert_from_strings(raw, spec), valid
    tag, arg = spec
    if tag == "struct":
        present, valid = _presence(col, steps, JD._K_OBJ, padded,
                                   host_trees, "obj", allow_lz)
        children = [_node_column(col, list(steps) + [name], child_spec,
                                 padded, host_trees, allow_lz)[0]
                    for name, child_spec in arg]
        out = Column(dtypes.STRUCT, col.length,
                     validity=None if bool(present.all())
                     else present.to(torch.uint8),
                     children=tuple(children))
        return out, valid
    if tag == "list":
        return _list_column(col, steps, arg, padded, host_trees, allow_lz)
    raise ValueError(f"unknown schema node {tag!r}")


def from_json_to_structs_device(
        col: Column, fields: Sequence[Tuple[str, DType]],
        allow_leading_zeros: bool = False) -> Optional[Column]:
    """Device from_json for flat AND nested schemas; None only for
    empty input or an empty schema (the host builder owns those
    shapes).  Nested struct fields compose scan paths; list nodes split
    elements with tensor ops and recurse on the derived child column.
    allow_leading_zeros runs the tolerant-number scan (Spark
    allowNumericLeadingZeros)."""
    if col.length == 0 or not fields:
        return None

    from spark_rapids_tpu_torch.ops import json_device as JD

    padded = JD.padded_chunks(col)
    host_trees: Dict = {}
    raw_cols = []
    row_valid = None
    for name, spec in fields:
        child, valid = _node_column(col, [name], spec, padded,
                                    host_trees, allow_leading_zeros)
        row_valid = valid if row_valid is None else row_valid
        raw_cols.append(child)

    # struct-level validity: tolerant-JSON valid AND root is an object;
    # rows the scan couldn't judge (fb) take the host parse's verdict
    in_valid = col.valid_mask()
    struct_valid = in_valid & row_valid & _root_is_object(padded)
    if host_trees:
        idx = torch.tensor(list(host_trees), dtype=torch.int64,
                           device=col.device)
        struct_valid[idx] = in_valid[idx] & torch.tensor(
            [t is not None and t[0] == "obj" for t in host_trees.values()],
            dtype=torch.bool, device=col.device)
    return Column(dtypes.STRUCT, col.length,
                  validity=None if bool(struct_valid.all())
                  else struct_valid.to(torch.uint8),
                  children=tuple(raw_cols))
