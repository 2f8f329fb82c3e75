"""Parquet footer parsing + column pruning (reference
NativeParquetJni.cpp 917 LoC: host-side thrift TCompactProtocol parse,
column_pruner :126 / column_pruning_maps :88, case-insensitive schema
matching; ParquetFooter.java:225 readAndFilter).

The footer is decoded into a GENERIC thrift value tree (field ids
preserved, unknown fields kept verbatim), pruned, and re-encoded — so
everything the writer put in the footer survives except the pruned
columns, exactly the trimmed-footer contract."""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

# thrift compact type ids
_T_BOOL_TRUE = 1
_T_BOOL_FALSE = 2
_T_BYTE = 3
_T_I16 = 4
_T_I32 = 5
_T_I64 = 6
_T_DOUBLE = 7
_T_BINARY = 8
_T_LIST = 9
_T_SET = 10
_T_MAP = 11
_T_STRUCT = 12

PARQUET_MAGIC = b"PAR1"


class ParquetFooterException(ValueError):
    """Typed footer failure: truncated thrift bytes, missing ``PAR1``
    magic, an impossible footer length, or a schema shape the flat
    reader cannot consume.  Subclasses :class:`ValueError` so callers
    that predate the type (and the reference's IllegalArgumentException
    shape) keep catching it."""


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        result = 0
        shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_binary(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_value(self, ttype: int):
        if ttype == _T_BOOL_TRUE:
            return True
        if ttype == _T_BOOL_FALSE:
            return False
        if ttype == _T_BYTE:
            return self._read_byte_val()
        if ttype in (_T_I16, _T_I32, _T_I64):
            return self.zigzag()
        if ttype == _T_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ttype == _T_BINARY:
            return self.read_binary()
        if ttype in (_T_LIST, _T_SET):
            return self.read_list()
        if ttype == _T_STRUCT:
            return self.read_struct()
        raise ValueError(f"unsupported thrift type {ttype}")

    def _read_byte_val(self) -> int:
        v = self.byte()
        return v - 256 if v >= 128 else v

    def read_list(self):
        head = self.byte()
        size = head >> 4
        etype = head & 0x0F
        if size == 15:
            size = self.varint()
        if etype in (_T_BOOL_TRUE, _T_BOOL_FALSE):
            # list bools are one byte per element (unlike struct fields)
            items = [self.byte() == _T_BOOL_TRUE for _ in range(size)]
        else:
            items = [self.read_value(etype) for _ in range(size)]
        return ("list", etype, items)

    def read_struct(self):
        fields: Dict[int, Tuple[int, object]] = {}
        fid = 0
        while True:
            head = self.byte()
            if head == 0:
                return ("struct", fields)
            delta = head >> 4
            ttype = head & 0x0F
            if delta:
                fid += delta
            else:
                fid = self.zigzag()
            if ttype in (_T_BOOL_TRUE, _T_BOOL_FALSE):
                fields[fid] = (ttype, ttype == _T_BOOL_TRUE)
            else:
                fields[fid] = (ttype, self.read_value(ttype))


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def byte(self, b: int):
        self.out.append(b & 0xFF)

    def varint(self, v: int):
        v &= (1 << 64) - 1
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.byte(b | 0x80)
            else:
                self.byte(b)
                return

    def zigzag(self, v: int):
        self.varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def write_value(self, ttype: int, v):
        if ttype in (_T_BOOL_TRUE, _T_BOOL_FALSE):
            return  # encoded in the field header
        if ttype == _T_BYTE:
            self.byte(v & 0xFF)
        elif ttype in (_T_I16, _T_I32, _T_I64):
            self.zigzag(v)
        elif ttype == _T_DOUBLE:
            self.out += struct.pack("<d", v)
        elif ttype == _T_BINARY:
            self.varint(len(v))
            self.out += v
        elif ttype in (_T_LIST, _T_SET):
            _, etype, items = v
            if len(items) < 15:
                self.byte((len(items) << 4) | etype)
            else:
                self.byte(0xF0 | etype)
                self.varint(len(items))
            for item in items:
                # bool list elements carry a 1/2 byte each; writers may
                # declare the element type with either bool code
                if etype in (_T_BOOL_TRUE, _T_BOOL_FALSE):
                    self.byte(1 if item else 2)
                else:
                    self.write_value(etype, item)
        elif ttype == _T_STRUCT:
            self.write_struct(v)
        else:
            raise ValueError(f"unsupported thrift type {ttype}")

    def write_struct(self, sv):
        _, fields = sv
        last = 0
        for fid in sorted(fields):
            ttype, v = fields[fid]
            if ttype in (_T_BOOL_TRUE, _T_BOOL_FALSE):
                ttype = _T_BOOL_TRUE if v else _T_BOOL_FALSE
            delta = fid - last
            if 0 < delta <= 15:
                self.byte((delta << 4) | ttype)
            else:
                self.byte(ttype)
                self.zigzag(fid)
            self.write_value(ttype, v)
            last = fid
        self.byte(0)


# --------------------------------------------------------- footer model


def _sval(sv, fid, default=None):
    if sv is None:
        return default
    t = sv[1].get(fid)
    return default if t is None else t[1]


def parse_footer(data: bytes):
    """Thrift bytes (without the trailing length+PAR1) -> generic tree.
    Truncated or garbage buffers raise the typed
    :class:`ParquetFooterException` instead of a bare IndexError /
    struct.error bubbling out of the compact-protocol reader."""
    try:
        return _Reader(data).read_struct()
    except (IndexError, struct.error, ValueError, OverflowError,
            MemoryError) as e:
        # ValueError covers _Reader's unsupported-thrift-type raise on
        # garbage type nibbles (_Reader never raises the typed
        # exception itself, so this cannot double-wrap)
        raise ParquetFooterException(
            f"truncated or corrupt parquet footer "
            f"({len(data)} bytes): {e}") from e


def serialize_footer(tree) -> bytes:
    w = _Writer()
    w.write_struct(tree)
    return bytes(w.out)


def footer_tail_length(size: int, tail: bytes) -> int:
    """Validate a parquet file's 8-byte tail against its size and
    return the footer length — the ONE tail validation shared by the
    file-handle path below and the range-reading columnar reader.
    Every malformed-tail shape (short file, missing PAR1 magic, footer
    length pointing past the start of the file) raises the typed
    :class:`ParquetFooterException`."""
    if size < 12:  # magic + 4-byte length + leading magic
        raise ParquetFooterException(
            f"not a parquet file: {size} bytes is shorter than "
            f"the minimal header+footer")
    if tail[4:] != PARQUET_MAGIC:
        raise ParquetFooterException(
            "not a parquet file: missing PAR1 magic")
    flen = struct.unpack("<I", tail[:4])[0]
    if flen + 8 > size:
        raise ParquetFooterException(
            f"footer length {flen} exceeds file size {size}")
    return flen


def read_footer_from_file(path: str):
    """Extract and parse the footer from a .parquet file (typed
    failures per :func:`footer_tail_length` / :func:`parse_footer`)."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        if size >= 8:
            f.seek(size - 8)
        flen = footer_tail_length(size, f.read(8) if size >= 8
                                  else b"")
        f.seek(size - 8 - flen)
        return parse_footer(f.read(flen))


def _schema_elements(tree) -> List:
    return _sval(tree, 2)[2]


# parquet physical Type ids (parquet.thrift enum Type)
PHYS_BOOLEAN = 0
PHYS_INT32 = 1
PHYS_INT64 = 2
PHYS_INT96 = 3
PHYS_FLOAT = 4
PHYS_DOUBLE = 5
PHYS_BYTE_ARRAY = 6
PHYS_FIXED_LEN_BYTE_ARRAY = 7

PHYSICAL_TYPE_NAMES = {
    PHYS_BOOLEAN: "boolean", PHYS_INT32: "int32", PHYS_INT64: "int64",
    PHYS_INT96: "int96", PHYS_FLOAT: "float", PHYS_DOUBLE: "double",
    PHYS_BYTE_ARRAY: "byte_array",
    PHYS_FIXED_LEN_BYTE_ARRAY: "fixed_len_byte_array",
}


class SchemaLeaf(NamedTuple):
    """One flat schema column as the page reader consumes it: the
    (name, physical type, max definition level) mapping of the pruned
    footer, plus the logical-type hints needed to pick a column dtype.
    Leaf order is chunk order within every row group."""

    name: str
    physical_type: int          # PHYS_* id
    max_def_level: int          # 1 when OPTIONAL, 0 when REQUIRED
    type_length: int            # FIXED_LEN_BYTE_ARRAY width
    converted_type: Optional[int]   # legacy ConvertedType id
    scale: int                  # DECIMAL scale (parquet sign)
    logical: Optional[tuple]    # raw LogicalType thrift subtree


def schema_leaves(tree) -> List[SchemaLeaf]:
    """Flat-schema leaf mapping of a (possibly pruned) footer tree —
    the projection contract between the footer pruner and
    ``io/parquet_reader``.  Nested and repeated schemas raise the
    typed :class:`ParquetFooterException` (the flat reader cannot
    place their values)."""
    try:
        elems = _schema_elements(tree)
        out: List[SchemaLeaf] = []
        i = 1
        while i < len(elems):
            e = elems[i]
            name = _sval(e, 4, b"")
            name = name.decode("utf-8", "replace") \
                if isinstance(name, bytes) else str(name)
            if _sval(e, 5, 0):
                raise ParquetFooterException(
                    f"nested column {name!r}: flat schemas only")
            rep = _sval(e, 3, 0)
            if rep == 2:  # REPEATED
                raise ParquetFooterException(
                    f"repeated column {name!r}: flat schemas only")
            phys = _sval(e, 1)
            if phys is None:
                raise ParquetFooterException(
                    f"schema element {name!r} has no physical type")
            out.append(SchemaLeaf(name, int(phys),
                                  1 if rep == 1 else 0,
                                  int(_sval(e, 2, 0) or 0),
                                  _sval(e, 6),
                                  int(_sval(e, 7, 0) or 0),
                                  _sval(e, 10)))
            i += 1
        return out
    except (TypeError, IndexError, KeyError, AttributeError) as e:
        # corrupt-but-parseable thrift: field shapes the walk above
        # assumes (ints, lists, structs) can be anything — fold into
        # the typed contract instead of a bare TypeError (the typed
        # raises above are ValueError subclasses, outside this tuple)
        raise ParquetFooterException(
            f"malformed footer schema: {e}") from e


def schema_names(tree) -> List[str]:
    """Schema element names in order, root excluded — THE helper for
    asserting pruning results (used by the footer tests and the JNI
    surface tests; keeps field-id knowledge in one place)."""
    return [_sval(e, 4).decode() for e in _schema_elements(tree)[1:]
            if _sval(e, 4) is not None]


def prune_columns(tree, keep_names: List[str],
                  case_sensitive: bool = True):
    """Trim the footer to the requested TOP-LEVEL columns (nested
    subtrees of kept columns are preserved whole) — the common pruning
    shape of ParquetFooter.readAndFilter.  Delegates to the per-leaf
    pruner with a keep-whole spec, which also keeps the column_orders
    list aligned (the old standalone path left it unpruned, producing
    footers pyarrow rejects)."""
    return prune_columns_nested(tree, {n: None for n in keep_names},
                                case_sensitive=case_sensitive)


def read_and_filter(path: str, keep_names: List[str],
                    case_sensitive: bool = True) -> bytes:
    """ParquetFooter.readAndFilter: read, prune, return trimmed thrift
    bytes."""
    tree = read_footer_from_file(path)
    return serialize_footer(prune_columns(tree, keep_names,
                                          case_sensitive))


_DROP = object()  # unique missing-key sentinel (a str could collide)


def prune_columns_nested(tree, keep_spec: Dict,
                         case_sensitive: bool = True):
    """Per-leaf nested pruning (NativeParquetJni.cpp:126 column_pruner /
    filter_schema): `keep_spec` is a nested dict of schema-element
    names — `{"col": None}` keeps the whole subtree, `{"col": {...}}`
    keeps the group element and recurses, so pruning inside structs
    (including under parquet's list/map wrapper groups, which are
    addressed by their literal names, e.g.
    {"arr": {"list": {"element": {"a": None}}}}) drops unrequested
    leaves.  Row-group column chunks are pruned by LEAF ORDINAL — the
    reference's chunk_map — so dropping `b` inside a struct removes
    exactly that chunk.  Returns a new tree."""
    elems = _schema_elements(tree)

    def norm(s) -> str:
        t = s.decode("utf-8", "replace") if isinstance(s, bytes) else s
        return t if case_sensitive else t.lower()

    def norm_spec(spec):
        if spec is None:
            return None
        if not isinstance(spec, dict):
            raise TypeError(
                f"keep_spec values must be None or dict, got "
                f"{type(spec).__name__}")
        return {norm(k): norm_spec(v) for k, v in spec.items()}

    want_root = norm_spec(keep_spec)
    kept_elems: List = []
    kept_leaf_ordinals: List[int] = []
    leaf_counter = 0

    def count_leaves(i: int) -> Tuple[int, int]:
        """(subtree size, leaf count) of the flattened subtree at i."""
        nc = _sval(elems[i], 5, 0)
        if nc == 0:
            return 1, 1
        size, leaves = 1, 0
        j = i + 1
        for _ in range(nc):
            sz, lv = count_leaves(j)
            size += sz
            leaves += lv
            j += sz
        return size, leaves

    def keep_whole(i: int) -> int:
        nonlocal leaf_counter
        sz, lv = count_leaves(i)
        kept_elems.extend(elems[i:i + sz])
        kept_leaf_ordinals.extend(range(leaf_counter, leaf_counter + lv))
        leaf_counter += lv
        return sz

    def skip_whole(i: int) -> int:
        nonlocal leaf_counter
        sz, lv = count_leaves(i)
        leaf_counter += lv
        return sz

    def walk_children(i: int, nc: int, spec) -> Tuple[int, int]:
        """Process nc children starting at i under `spec`; returns
        (next index, number of kept children)."""
        kept_children = 0
        for _ in range(nc):
            name = norm(_sval(elems[i], 4, b""))
            child_spec = spec.get(name, _DROP) if spec else _DROP
            if child_spec is _DROP:
                i = i + skip_whole(i)
            elif child_spec is None:
                i = i + keep_whole(i)
                kept_children += 1
            else:
                child_nc = _sval(elems[i], 5, 0)
                if child_nc == 0:
                    # spec recurses into a leaf: keep the leaf itself
                    i = i + keep_whole(i)
                    kept_children += 1
                    continue
                slot = len(kept_elems)
                kept_elems.append(None)  # placeholder, fixed below
                i2, sub_kept = walk_children(i + 1, child_nc, child_spec)
                if sub_kept == 0:
                    kept_elems.pop(slot)  # nothing survived below
                else:
                    fields = dict(elems[i][1])
                    fields[5] = (_T_I32, sub_kept)
                    kept_elems[slot] = ("struct", fields)
                    kept_children += 1
                i = i2
        return i, kept_children

    root = elems[0]
    _, kept_top = walk_children(1, _sval(root, 5, 0), want_root)
    new_root_fields = dict(root[1])
    new_root_fields[5] = (_T_I32, kept_top)
    new_fields = dict(tree[1])
    new_fields[2] = (_T_LIST, ("list", _T_STRUCT,
                               [("struct", new_root_fields)] + kept_elems))

    # prune row-group column chunks by original leaf ordinal (chunk_map)
    keep_set = set(kept_leaf_ordinals)
    rg_entry = tree[1].get(4)
    if rg_entry is not None:
        new_rgs = []
        for rg in rg_entry[1][2]:
            rg_fields = dict(rg[1])
            cols_entry = rg_fields.get(1)
            if cols_entry is not None:
                new_cols = [cc for k, cc in enumerate(cols_entry[1][2])
                            if k in keep_set]
                rg_fields[1] = (_T_LIST, ("list", _T_STRUCT, new_cols))
            new_rgs.append(("struct", rg_fields))
        new_fields[4] = (_T_LIST, ("list", _T_STRUCT, new_rgs))
    # column_orders (FileMetaData field 7) holds one entry per LEAF and
    # must stay aligned with the surviving leaves
    co_entry = tree[1].get(7)
    if co_entry is not None:
        kept_co = [co for k, co in enumerate(co_entry[1][2])
                   if k in keep_set]
        new_fields[7] = (_T_LIST, ("list", co_entry[1][1], kept_co))
    return ("struct", new_fields)
